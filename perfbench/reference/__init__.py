"""Plain PyTorch references that decide ``correct``: they import nothing of
the program (``repro_torch``) and no JAX."""
