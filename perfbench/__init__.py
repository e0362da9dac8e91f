"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one cell a run,
driven by data. See ``run.py``."""
