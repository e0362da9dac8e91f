"""Seeded inputs that hold subnormals, shared by the port's subnormal tests
on the CPU (against the reference) and on the card (against the CPU).
The window below 2^-126 is enumerated by ``repro_torch.dtypes``
(``window_operands``, ``window_pairs``), which ``chip_smoke.py`` shares."""

from __future__ import annotations

import numpy as np

from repro_torch.dtypes import WINDOW_LO, window_operands, window_pairs  # noqa: F401

TINY = 2.0 ** -126
LEAVES = ("subnormal", "tiny_max", "edge", "rows", "tiny")
# leaves whose sums (Δ, w_q, g_wq) have at most one nonzero term, so that
# they are exact in any order
EXACT_SUMS = ("subnormal", "tiny_max")


def subnormal_leaves(shape=(64, 32)) -> dict:
    """fp32 leaves of ``shape``: all subnormal (normals × 1e-39, seed 0);
    the same with one tiny normal (2e-38) as its maximum; values within six
    fp32 steps of 2^-126 on either side, of random sign; normals whose first
    quarter of rows is subnormal; and tiny normals (normals × 1e-36)."""
    base = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    sub = (base * 1e-39).astype(np.float32)
    tiny_max = sub.copy()
    tiny_max.reshape(-1)[5] = np.float32(2e-38)
    rng = np.random.default_rng(1)
    steps = rng.integers(-6, 7, size=shape)
    sign = rng.choice([-1.0, 1.0], size=shape)
    edge = (sign * (TINY + steps * 2.0 ** -149)).astype(np.float32)
    rows = base.copy()
    rows[: shape[0] // 4] *= np.float32(1e-39)
    return {"subnormal": sub, "tiny_max": tiny_max, "edge": edge, "rows": rows,
            "tiny": (base * 1e-36).astype(np.float32)}


def feedback_tree(seed: int = 1) -> dict:
    """A (64, 32) weight whose first 16 rows are subnormal and an
    all-subnormal bias (the weight and bias of one layer), an all-subnormal
    (16, 32) weight, and a (16, 32) weight of values within six fp32 steps
    of 2^-126 on either side."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    w[:16] *= np.float32(1e-39)
    bias = (rng.normal(size=(32,)) * 1e-39).astype(np.float32)
    sub = (rng.normal(size=(16, 32)) * 1e-39).astype(np.float32)
    steps = rng.integers(-6, 7, size=(16, 32))
    sign = rng.choice([-1.0, 1.0], size=(16, 32))
    edge = (sign * (TINY + steps * 2.0 ** -149)).astype(np.float32)
    return {"layer": {"w": w, "bias": bias}, "sub": {"w": sub}, "edge": {"w": edge}}


QAT_FACTORS = [0.3, 1.0, 1.0 - 2 ** -24, 4.0, 2.0 ** 100, 1e-39, -0.7]


def qat_backward_rows(seed: int = 3):
    """(g, codes, w) for the QAT backward's elementwise step: a
    (len(QAT_FACTORS), m) fp32 cotangent and codes (±1, ±0 and NaN) and the
    rows' factors (below, at and above 1, subnormal, negative, 2^100). Each
    row's cotangents are a seeded fp32 sample, the fp32 values about the
    window below 2^-126 for its factor, the mul window's operands, and
    NaN, ±inf, ±0 and subnormals, with their negatives."""
    rng = np.random.default_rng(seed)
    a, _ = window_operands("mul")
    rows = []
    for f in QAT_FACTORS:
        base = rng.integers(0, 2 ** 32, 2048, dtype=np.uint64).astype(np.uint32).view(np.float32)
        near = np.float32(WINDOW_LO / abs(f)) if f != 1e-39 else np.float32(1)
        steps = [np.nextafter(near, np.float32(0)), near, np.nextafter(near, np.float32(1))]
        extra = np.array(steps + [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-39, -2e-38]
                         + list(a[:64]), np.float32)
        rows.append(np.concatenate([base, extra, -extra]))
    g = np.stack(rows).astype(np.float32)
    codes = rng.choice(np.array([1.0, -1.0, 0.0, -0.0, np.nan], np.float32), size=g.shape,
                       p=[0.35, 0.35, 0.13, 0.13, 0.04]).astype(np.float32)
    return g, codes, np.array(QAT_FACTORS, np.float32)
