"""Model zoo (port of ``repro.models``): the dense decoder family."""
