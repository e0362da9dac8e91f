"""Synthetic classification data (port of
``repro.data.synthetic.synthetic_classification``).

The same mixture-of-Gaussians construction — class centers N(0, 1),
uniform labels, samples at their class center plus N(0, noise²) — drawn
from a seeded ``numpy`` Generator. ``jax.random`` cannot be reproduced
here, so the same seed does not give the reference's samples: code that
needs both packages on the same data builds it once and hands the numpy
arrays to both.
"""

from __future__ import annotations

import numpy as np


def synthetic_classification(
    seed: int,
    n_samples: int,
    n_classes: int = 10,
    dim: int = 784,
    image_hw: tuple | None = None,
    noise: float = 2.0,
    n_test: int = 0,
):
    """Mixture-of-Gaussians classification set.

    Returns (x, y) — or (x, y, x_test, y_test) when n_test > 0, both splits
    drawn from the same class centers. x is float32 (N, dim), or
    (N, H, W, C) if ``image_hw`` is given; y is int32."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_classes, dim), dtype=np.float32)
    total = n_samples + n_test
    y = rng.integers(0, n_classes, size=total).astype(np.int32)
    x = centers[y] + np.float32(noise) * rng.standard_normal((total, dim), dtype=np.float32)
    if image_hw is not None:
        h, w, c = image_hw
        assert h * w * c == dim
        x = x.reshape(total, h, w, c)
    if n_test:
        return x[:n_samples], y[:n_samples], x[n_samples:], y[n_samples:]
    return x, y
