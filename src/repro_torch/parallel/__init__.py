"""Client-axis fan-in (port of ``repro.parallel``, single-device path)."""
