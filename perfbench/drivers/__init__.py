"""The traffic drivers, one module a driver named in a workload file."""
