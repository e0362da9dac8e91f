"""Synthetic classification data and the synthetic token stream (port of
``repro.data.synthetic``).

The same mixture-of-Gaussians construction — class centers N(0, 1),
uniform labels, samples at their class center plus N(0, noise²) — drawn
from a seeded ``numpy`` Generator. ``jax.random`` cannot be reproduced
here, so the same seed does not give the reference's samples: code that
needs both packages on the same data builds it once and hands the numpy
arrays to both.

``synthetic_tokens`` already draws from numpy in the reference, seeded
with an int that ``jax.random`` draws from its key. The port takes that
int, so the same int gives the reference's stream bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device


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


def synthetic_tokens(seed: int, n_tokens: int, vocab: int, order: int = 2) -> np.ndarray:
    """Markov-ish int32 token stream: the next token is a fixed function of
    a running hash of the previous tokens, except for a 15% noise branch,
    which gives a learnable LM signal (loss falls from uniform).

    The reference's hash grows without bound; only its residues modulo
    ``vocab`` and 16 are read, so it is kept modulo their lcm, which reads
    the same residues in constant time per token."""
    rng = np.random.default_rng(seed)
    trans = rng.integers(0, vocab, size=(vocab, 16), dtype=np.int32)
    modulus = math.lcm(vocab, 16)
    toks = np.empty((n_tokens,), np.int32)
    toks[0] = rng.integers(vocab)
    state = int(toks[0])
    for i in range(1, n_tokens):
        if rng.random() < 0.15:  # noise branch keeps entropy > 0
            toks[i] = rng.integers(vocab)
        else:
            toks[i] = trans[state % vocab, state % 16]
        state = (state * 31 + int(toks[i])) % modulus
    return toks


def token_batches(tokens: np.ndarray, batch: int, seq: int, *, start: int = 0,
                  device: str | torch.device = "cuda"):
    """Yield ({"tokens", "labels"} int32 (batch, seq) tensors on ``device``,
    cursor) next-token batches. The cursor is the index of the next batch,
    part of a train checkpoint; ``start`` resumes from it. The stream wraps
    to its first batch when the next one would run past its end."""
    dev = resolve_device(device)
    span = batch * (seq + 1)
    i = start
    while True:
        if (i + 1) * span > len(tokens):
            i = 0
        chunk = torch.from_numpy(
            np.ascontiguousarray(tokens[i * span:(i + 1) * span], np.int32)
        ).reshape(batch, seq + 1).to(dev)
        yield {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}, i + 1
        i += 1
