"""Federated Trained Ternary Quantization (FTTQ) — the layer statistics.

Port of the forward half of ``repro.core.fttq`` (paper §III.A, eqs. 6-12):

    θ_s  = g(θ)                    layer-wise scale to [-1, 1]          (eq. 6)
    Δ    = T_k / m · Σ_i |θ_s_i|   sparsity-aware threshold             (eq. 8)
    I_t  = sign(ε(|θ_s| − Δ) ⊙ θ_s) ternary codes in {-1, 0, +1}        (eq. 11)

plus the policy that decides which leaves of a parameter tree are
quantized, and the quantization-aware training (QAT) forward
``fttq_quantize`` (θ_t = w_q · I_t) with the straight-through backward of
Algorithm 1:

    ∂J/∂w_q = Σ_i ∂J/∂θ_t_i · I_t_i
    ∂J/∂θ_i = ∂J/∂θ_t_i · (w_q if I_t_i ≠ 0 else 1)

Leaves with ndim ≥ 3 are "stacked": one factor per leading index, so an
HWIO conv weight (3, 3, 64, 64) trains 3 factors of shape (3, 1, 1, 1), one
per kernel row, as the reference's ``vmap`` does.

Under tensor parallelism and FSDP (``parallel.tensor``) a rank holds a
shard of some leaves, cut over "model", "data" or both, and max|θ|, Δ and
the w_q gradient Σ g·I_t are still statistics of the whole leaf (of each
layer of a stacked one), as GSPMD computes them for the reference:
``leaf_row_stats`` all-reduces the shards' row maxima (MAX) and Σ|θ_s|
(SUM, divided by the whole row's count) over every axis that cuts the
leaf, and the backward sums the shards' g_wq over the same axes. The
functions over trees take ``shards`` (a ``parallel.tensor.Shards``); whole
leaves take no collective.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

import torch

from repro_torch.dtypes import (
    TINY, flush_subnormal, flushed_abs, is_floating, largest_subnormal, xla_op,
)
from repro_torch.tree import Path, flatten_with_path, path_str, tree_map_with_path

_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class FTTQConfig:
    """Hyper-parameters of the FTTQ quantizer (see ``repro.core.fttq``).

    Attributes:
      t_k: threshold hyper-parameter T_k of eq. (8); 0.7 is TWN's optimum.
      threshold_rule: "mean" → eq. (8); "max" → eq. (7).
      server_delta: fixed re-quantization threshold of the server (§III.B).
      quantize_embed: also ternarize embedding / unembedding tables.
      exclude_patterns: regexes over the key path; matches stay full precision.
      min_ndim: leaves with fewer dims are never quantized.
    """

    t_k: float = 0.7
    threshold_rule: str = "mean"
    server_delta: float = 0.05
    quantize_embed: bool = False
    exclude_patterns: tuple[str, ...] = ()
    min_ndim: int = 2


def abs_max(theta: torch.Tensor) -> torch.Tensor:
    """max|θ| without materializing |θ| (max is order-invariant, so this
    is bit-identical to ``jnp.max(jnp.abs(theta))``, which XLA flushes when
    the maximum is subnormal, and whose maximum of zeros is +0)."""
    return flush_subnormal(torch.maximum(theta.amax(), -theta.amin()).abs())


def scale_layer(theta: torch.Tensor, denom: torch.Tensor | None = None) -> torch.Tensor:
    """g(θ): scale one layer's weights into [-1, 1] (eq. 6), layer-wise, as
    XLA divides: a subnormal θ or quotient is a zero of its sign."""
    if denom is None:
        denom = abs_max(theta) + _EPS
    return xla_op(torch.div, theta, denom)


def _times_tk(t_k: float, stat: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Δ = T_k · stat as XLA forms it from a statistic (a mean summed and
    divided in fp32, or a maximum): stat flushed and rounded to ``dtype``,
    T_k rounded to ``dtype`` first (JAX rounds a Python scalar to the
    array's dtype before it multiplies, so a bf16 Δ would round once more
    otherwise), the product in fp32, flushed, then rounded to ``dtype``.
    For 0 ≤ T_k < 1 one ``hardshrink`` of the product does it all: a
    subnormal stat rounds to at most 2^-126, so its product is below 2^-126
    and flushed, as XLA's product of the flushed stat is; the zero is +0 on
    both sides (stat ≥ 0). Each op on these (L, 1) tensors is a launch, and
    the eager QAT of a model of small leaves pays for every one."""
    t = float(torch.tensor(t_k, dtype=dtype))
    stat = stat.to(dtype).to(torch.float32)
    if 0.0 <= t < 1.0:
        return _flushed(stat * t).to(dtype)
    return flush_subnormal(flush_subnormal(stat) * t).to(dtype)


def fttq_threshold(theta_s: torch.Tensor, t_k: float, rule: str = "mean") -> torch.Tensor:
    """Δ for one layer. rule="mean" is eq. (8); rule="max" is eq. (7). A
    subnormal |θ_s| counts as zero, and a subnormal Δ is zero."""
    if rule == "mean":
        return _times_tk(t_k, flushed_abs(theta_s).mean(dtype=torch.float32), theta_s.dtype)
    if rule == "max":
        return _times_tk(t_k, abs_max(theta_s), theta_s.dtype)
    raise ValueError(f"unknown threshold rule: {rule!r}")


def _flushed_delta(theta_s: torch.Tensor, delta) -> torch.Tensor:
    """flush(Δ) in the dtype θ_s is compared in."""
    delta = torch.as_tensor(delta, device=theta_s.device)
    return flush_subnormal(delta).to(torch.promote_types(theta_s.dtype, delta.dtype))


def _selected(theta_s: torch.Tensor, delta) -> torch.Tensor:
    """|θ_s| > Δ as XLA compares them, both read with subnormals as zeros.
    With Δ' = flush(Δ) ≥ 0 the compare is flush(|θ_s|) > Δ', which is
    |θ_s| > max(Δ', s) for s the largest subnormal of θ_s's dtype: a
    subnormal |θ_s| ≤ s fails both, a normal one passes both exactly when it
    exceeds Δ' (Δ' is 0 or normal). With Δ' < 0 every |θ_s| passes both.
    The cut is per layer or row, so the weights are read once."""
    d = _flushed_delta(theta_s, delta)
    cut = torch.where(d < 0, d, d.clamp_min(largest_subnormal(theta_s.dtype)))
    return torch.abs(theta_s) > cut


def ternarize(theta_s: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """I_t = sign(ε(|θ_s| − Δ) ⊙ θ_s) ∈ {-1, 0, +1} (eqs. 10-11), as XLA
    forms sign(flush(θ_s)) · mask: ±1 where |θ_s| > max(flush(Δ), s) (s the
    largest subnormal: below it the sign is ±0, whatever the mask), a zero
    of θ_s's sign elsewhere, and NaN for a NaN θ_s (``torch.sign`` gives +0
    for a zero and a NaN)."""
    cut = _flushed_delta(theta_s, delta).clamp_min(largest_subnormal(theta_s.dtype))
    nonzero = torch.abs(theta_s) > cut
    codes = nonzero.to(theta_s.dtype).copysign_(theta_s)
    return torch.where(torch.isnan(theta_s), theta_s, codes)


def init_wq(theta: torch.Tensor, cfg: FTTQConfig) -> torch.Tensor:
    """w_q at its Prop-4.1 optimum: mean |θ| over the selected positions,
    in ORIGINAL (unscaled) units. A selected θ is normal, so the sum reads
    every term as it is; a subnormal quotient is zero."""
    theta_s = scale_layer(theta)
    delta = fttq_threshold(theta_s, cfg.t_k, cfg.threshold_rule)
    sel = _selected(theta_s, delta)
    num = torch.sum(torch.where(sel, torch.abs(theta), 0.0))
    den = torch.sum(sel).to(torch.float32) + _EPS
    return flush_subnormal(num / den).to(theta.dtype)


_BUILTIN_EXCLUDES = ("norm", "bias", "scale", "ln_", "layernorm", "a_log", "dt_")
_EMBED_EXCLUDES = ("embed", "lm_head", "unembed", "patch_proj", "frontend")


def is_quantizable(path: Path, leaf, cfg: FTTQConfig) -> bool:
    """Policy: quantize weight-like leaves only — ndim ≥ cfg.min_ndim,
    floating point, and not an excluded path (norm/bias/embedding unless
    ``quantize_embed``)."""
    if not hasattr(leaf, "ndim") or leaf.ndim < cfg.min_ndim:
        return False
    if not is_floating(leaf):
        return False
    name = path_str(path).lower()
    excludes = _BUILTIN_EXCLUDES + (() if cfg.quantize_embed else _EMBED_EXCLUDES)
    if any(pat in name for pat in excludes):
        return False
    return not any(re.search(pat, name) for pat in cfg.exclude_patterns)


# --------------------------------------------------------------------------
# The QAT quantizer (Algorithm 1), over rows: one row per trained factor.
# --------------------------------------------------------------------------


def _row_abs_max(rows: torch.Tensor) -> torch.Tensor:
    lo, hi = torch.aminmax(rows, dim=1, keepdim=True)
    return torch.maximum(hi, -lo)


def row_denom(rows: torch.Tensor) -> torch.Tensor:
    """max|θ| + ε per row of a (L, m) weight, as (L, 1): each row (a layer
    of a stacked leaf, or a whole leaf as one row) is scaled on its own.
    XLA flushes a subnormal maximum, but ε = 1e-8 absorbs it either way."""
    return _row_abs_max(rows) + _EPS


def scaled_abs(rows: torch.Tensor, denom: torch.Tensor,
               theta_s: torch.Tensor | None = None) -> torch.Tensor:
    """|θ_s| = |rows / denom| of a (L, m) weight and its (L, 1) denom as XLA
    reads it: zero where θ or the quotient is subnormal (which makes θ_s a
    zero of its sign there), |θ_s| elsewhere. ``theta_s`` is rows / denom if
    the caller has it. The weights are read once more, with a per-row cut:

    fp32: θ_s is kept exactly when |θ_s| > c = fl(s / min(d, 1)), s the
      largest subnormal. For d ≥ 1, c = s and |θ| ≥ |θ_s| ≥ TINY. For d < 1,
      |θ_s| ≥ |θ| is normal when θ is, and division by d is monotone, so
      |θ| ≤ s gives |θ_s| ≤ c while |θ| ≥ TINY gives |θ_s| ≥ fl(TINY / d),
      which exceeds c: the reals TINY/d and s/d lie TINY/d · 2^-23 apart,
      at least one step of fp32's grid there, and where the gap is exactly
      one step (TINY/d a power of two) s/d is itself on the grid.
    bf16: θ_s = bf16(fl32(θ / d)) rounds an fp32 quotient that XLA flushes
      first, and a flushed quotient just below TINY rounds up to TINY in
      bf16, so the cut is on θ: kept exactly when |θ| ≥ B = TINY · max(d, 1).
      For d < 1 the quotient of a normal θ is normal. For d ≥ 1, |θ| ≥ B
      gives |θ|/d ≥ TINY; the next bf16 below B is at most TINY·d·(1 − 2^-8),
      and its fp32 quotient, at most TINY·(1 − 2^-8), an fp32 subnormal on
      the grid, stays below TINY.
    Other dtypes hold no value XLA would flush. (As ``dtypes.xla_op`` says,
    XLA on the CPU also flushes an fp32 quotient in [2^-126 − 2^-150,
    2^-126 − 2^-151), which rounds up to 2^-126 and is kept here: it needs
    d > 1 and a weight within half an fp32 step of 2^-126 · d.)"""
    if theta_s is None:
        theta_s = rows / denom
    a = theta_s.abs()
    if rows.dtype == torch.float32:
        lsub = torch.full_like(denom, largest_subnormal(torch.float32))
        return a.mul_(a > lsub.div_(denom.clamp(max=1.0)))
    if rows.dtype == torch.bfloat16:
        return a.mul_(rows.abs() >= TINY * denom.clamp(min=1.0))
    return a


def row_threshold(abs_s: torch.Tensor, t_k: float, rule: str = "mean") -> torch.Tensor:
    """Δ per row from a (L, m) |θ_s| as ``scaled_abs`` gives it, as (L, 1);
    a subnormal mean or Δ is zero."""
    if rule == "mean":
        stat = abs_s.mean(dim=1, keepdim=True, dtype=torch.float32)
    elif rule == "max":
        stat = abs_s.amax(dim=1, keepdim=True)
    else:
        raise ValueError(f"unknown threshold rule: {rule!r}")
    return _times_tk(t_k, stat, abs_s.dtype)


def _above(abs_s: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """XLA's mask flush(|θ_s|) > flush(Δ), for |θ_s| as ``scaled_abs``
    gives it (already 0 where XLA reads a zero)."""
    return abs_s > flush_subnormal(delta)


def _codes(theta_s: torch.Tensor, abs_s: torch.Tensor, cut: torch.Tensor) -> torch.Tensor:
    """I_t = sign(flush(θ_s)) · [flush(|θ_s|) > Δ'] for Δ' = flush(Δ), given
    cut = max(Δ', 0): ±1 where abs_s > cut, a zero of θ_s's sign elsewhere.
    A kept |θ_s| is normal and Δ' is 0 or normal, so this is the mask
    wherever Δ ≥ 0; where a negative Δ selects a flushed θ_s, XLA's code is
    sign(±0) · 1 = ±0, as here. θ_s is the unflushed quotient, so a flushed
    one keeps its sign. A NaN θ_s gets a zero where XLA's code is NaN
    (ROADMAP Queue 3): the one case that would cost another pass."""
    return (abs_s > cut).to(theta_s.dtype).copysign_(theta_s)


def scaled_codes(rows: torch.Tensor, denom: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """I_t = ternarize(rows / denom, Δ) of a (L, m) weight with (L, 1)
    scalars, as XLA forms it (a subnormal θ, θ_s or Δ is a zero)."""
    theta_s = rows / denom
    cut = flush_subnormal(delta).clamp_min(0.0)
    return _codes(theta_s, scaled_abs(rows, denom, theta_s), cut)


def row_codes(rows: torch.Tensor, t_k: float, rule: str = "mean") -> torch.Tensor:
    """I_t of a (L, m) weight, each row with its own scale and threshold."""
    denom = row_denom(rows)
    theta_s = rows / denom
    abs_s = scaled_abs(rows, denom, theta_s)
    delta = row_threshold(abs_s, t_k, rule)          # flushed, and ≥ 0 (or NaN) for T_k ≥ 0
    return _codes(theta_s, abs_s, delta if t_k >= 0 else delta.clamp_min(0.0))


def leaf_row_stats(rows: list, t_k: float, axes: list) -> list:
    """(denom, Δ), each (L, 1), per row of every (L, m) shard in ``rows``,
    from the whole leaf: the row maxima all-reduced (MAX) and Σ|θ_s|
    all-reduced (SUM) over every mesh axis in ``axes[i]`` (the
    ``MeshAxis`` tuple that cuts ``rows[i]``), the mean over the whole
    row's m · Π sizes elements. One all-reduce of each kind per axis for
    all of them; the sums in fp32, as a one-device mean accumulates. Each
    term is |θ_s| as ``scaled_abs`` reads it, 0 or at least TINY, so no
    partial sum is subnormal and a shard's flushed sum is its exact one;
    the mean and Δ of the whole row are flushed as one device's are."""
    from repro_torch.parallel.tensor import reduce_over

    mx = reduce_over([_row_abs_max(r).reshape(-1).to(torch.float32) for r in rows], axes, "max")
    denoms = [part.to(r.dtype).reshape(-1, 1) + _EPS for r, part in zip(rows, mx)]
    sums = reduce_over([scaled_abs(r, d).sum(dim=1, dtype=torch.float32)
                        for r, d in zip(rows, denoms)], axes)
    out = []
    for r, d, part, ax in zip(rows, denoms, sums, axes):
        whole = r.shape[1] * math.prod(a.size for a in ax)
        out.append((d, _times_tk(t_k, (part / whole).reshape(-1, 1), r.dtype)))
    return out


class FTTQQuantize(torch.autograd.Function):
    """θ_t = w_q · ternarize(g(θ), Δ(g(θ))) per row of ``theta.reshape(L, -1)``
    with ``w_q`` of L elements (L = 1 for a whole-leaf factor).

    The forward's Δ always follows eq. (8) (the "mean" rule), whatever the
    config's ``threshold_rule``: the reference's ``fttq_quantize`` calls
    ``fttq_threshold`` with its default rule. A shard passes its leaf's
    ``stats`` ((denom, Δ) from ``leaf_row_stats``) and the ``axes`` it is
    cut over, whose ranks' g_wq the backward sums."""

    @staticmethod
    def forward(ctx, theta, w_q, t_k, stats=None, axes=()):
        n_rows = w_q.numel()
        rows = theta.reshape(n_rows, -1)
        if stats is None:
            i_t = row_codes(rows, t_k)
        else:
            denom, delta = stats
            i_t = scaled_codes(rows, denom, delta)
        # XLA reads a subnormal w_q as a zero of its sign; w_q · (±1 or ±0)
        # is exact
        w = w_q.reshape(n_rows, 1)
        w = _flushed(w).copysign_(w)
        ctx.save_for_backward(i_t, w_q)
        ctx.axes = axes
        return (w * i_t).reshape(theta.shape)

    @staticmethod
    def backward(ctx, g):
        i_t, w_q = ctx.saved_tensors
        n_rows = w_q.numel()
        g_rows = g.reshape(n_rows, -1)
        # a flushed g_wq is +0 where XLA's zero keeps the sum's sign: Adam's
        # m and v cannot tell them apart (``_flushed_product``)
        g_wq = _flushed((g_rows * i_t).sum(dim=1)).reshape(w_q.shape).to(w_q.dtype)
        if ctx.axes:
            from repro_torch.parallel.tensor import reduce_over

            (g_wq,) = reduce_over([g_wq], [ctx.axes])
            g_wq = _flushed(g_wq)
        w = w_q.reshape(n_rows, 1)
        scale = torch.where(i_t != 0, w if w.dtype == torch.bfloat16 else _flushed(w), 1.0)
        g_theta = _flushed_product(g_rows, scale).reshape(g.shape)
        return g_theta, g_wq, None, None, None


def _flushed(t: torch.Tensor) -> torch.Tensor:
    """t with every |t| ≤ the largest subnormal of its dtype made +0, in
    one op (``flush_subnormal`` keeps the zero's sign in three)."""
    return torch.nn.functional.hardshrink(t, largest_subnormal(t.dtype))


def _flushed_product(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """g · scale as XLA forms it for the backward's scale (1 or w_q; in
    fp32 a flushed w_q, of either zero sign, as the product's zero is +0
    whatever it is). bf16: every operand and the fp32 product flushed, then
    rounded.
    fp32: the product, with every |r| ≤ s (the largest subnormal) made +0
    by ``hardshrink``, one pass. That is XLA's value wherever |scale| ≤ 1
    (a subnormal g gives |r| ≤ |g| < TINY, so reading g as a zero and
    flushing r agree) and wherever g is normal (r is then XLA's product,
    unflushed or flushed). It differs from XLA for a subnormal g times a
    w_q above 1 in magnitude, where XLA reads g as zero and this keeps a
    normal product (ROADMAP Queue 3); XLA's own cotangents come out of
    flushed arithmetic and are never subnormal. A flushed product is +0
    where XLA's zero has the product's sign: no later value can tell them
    apart, since the trainer only scales g, squares it and adds it to
    Adam's m, which starts at +0 and never holds -0 (a sum that cancels
    rounds to +0). Restoring the sign, or reading g as well, would cost
    another pass over every quantized weight."""
    if g.dtype == torch.bfloat16:
        return xla_op(torch.mul, g, scale)
    r = g * scale
    return _flushed(r) if r.dtype == torch.float32 else r


def fttq_quantize(theta: torch.Tensor, w_q: torch.Tensor, t_k: float) -> torch.Tensor:
    """Whole-leaf QAT forward θ_t = w_q · I_t, differentiable via STE."""
    return FTTQQuantize.apply(theta, w_q, t_k)


def _is_stacked(leaf, wq) -> bool:
    """Per-layer treatment: ndim ≥ 3 with a broadcast-shaped factor."""
    return leaf.ndim >= 3 and hasattr(wq, "ndim") and wq.ndim == leaf.ndim


def _factor_rows(leaf) -> int:
    return leaf.shape[0] if leaf.ndim >= 3 else 1


def _shards(params: Any, keep, shards) -> dict:
    """{path: (leaf, the MeshAxis tuple that cuts it)} of the shards among
    the leaves ``keep`` accepts."""
    if shards is None:
        return {}
    return {path: (leaf, shards.axes(path_str(path))) for path, leaf in flatten_with_path(params)
            if path_str(path) in shards.cuts and keep(path, leaf)}


def init_wq_tree(params: Any, cfg: FTTQConfig, shards=None) -> Any:
    """One w_q per quantizable leaf, ``None`` elsewhere. A leaf with
    ndim ≥ 3 gets a factor per leading index, shaped (L, 1, ..., 1). A
    shard (``shards``, a ``parallel.tensor.Shards``) gets its whole leaf's
    factor."""
    from repro_torch.parallel.tensor import reduce_over

    cut = _shards(params, lambda p, x: is_quantizable(p, x, cfg), shards)
    stats = dict(zip(cut, leaf_row_stats(
        [x.reshape(_factor_rows(x), -1) for x, _ in cut.values()], cfg.t_k,
        [ax for _, ax in cut.values()]) if cut else []))
    sums = {}
    for path, (leaf, _) in cut.items():
        denom, delta = stats[path]
        rows = leaf.reshape(_factor_rows(leaf), -1)
        sel = _above(scaled_abs(rows, denom), delta)
        sums[path] = torch.stack([torch.where(sel, rows.abs(), 0.0).sum(dim=1, dtype=torch.float32),
                                  sel.sum(dim=1).to(torch.float32)])
    sums = dict(zip(sums, reduce_over(list(sums.values()), [cut[p][1] for p in sums])))

    def make(path, leaf):
        if not is_quantizable(path, leaf, cfg):
            return None
        if path in sums:
            num, den = sums[path]
            wq = flush_subnormal(num / (den + _EPS)).to(leaf.dtype)
            return wq.reshape(((leaf.shape[0],) + (1,) * (leaf.ndim - 1))
                              if leaf.ndim >= 3 else ())
        if leaf.ndim >= 3:
            rows = leaf.reshape(leaf.shape[0], -1)
            abs_s = scaled_abs(rows, row_denom(rows))
            sel = _above(abs_s, row_threshold(abs_s, cfg.t_k, cfg.threshold_rule))
            num = torch.where(sel, rows.abs(), 0.0).sum(dim=1)
            den = sel.sum(dim=1).to(torch.float32) + _EPS
            return flush_subnormal(num / den).to(leaf.dtype).reshape(
                (leaf.shape[0],) + (1,) * (leaf.ndim - 1))
        return init_wq(leaf, cfg)

    return tree_map_with_path(make, params)


def quantize_tree(params: Any, wq_tree: Any, cfg: FTTQConfig, shards=None) -> Any:
    """QAT forward over a tree: every leaf with a factor in ``wq_tree``
    (as made by ``init_wq_tree``) is quantized, the rest pass through. A
    shard (``shards``) is quantized with its whole leaf's statistics."""
    wqs = dict(flatten_with_path(wq_tree))
    cut = _shards(params, lambda p, _: wqs.get(p) is not None, shards)
    with torch.no_grad():
        stats = dict(zip(cut, leaf_row_stats(
            [x.reshape(wqs[p].numel(), -1) for p, (x, _) in cut.items()], cfg.t_k,
            [ax for _, ax in cut.values()]) if cut else []))

    def one(path, leaf):
        wq = wqs.get(path)
        if wq is None:
            return leaf
        if path in stats:
            return FTTQQuantize.apply(leaf, wq, cfg.t_k, stats[path], cut[path][1])
        return FTTQQuantize.apply(leaf, wq, cfg.t_k)

    return tree_map_with_path(one, params)


def ternary_stats(params: Any, cfg: FTTQConfig, shards=None) -> dict:
    """Diagnostics: the share of parameters quantized, and the share of
    zero codes among them (each leaf scaled as a whole). The per-leaf zero
    counts stay on the device and cross to the host in one transfer, summed
    there as int64; a shard (``shards``) counts its whole leaf."""
    from repro_torch.parallel.tensor import reduce_over

    cut = _shards(params, lambda p, x: True, shards)
    quant = {p: v for p, v in cut.items() if is_quantizable(p, v[0], cfg)}
    if cfg.threshold_rule != "mean" and quant:
        raise NotImplementedError("ternary_stats on shards takes the 'mean' rule")
    stats = dict(zip(quant, leaf_row_stats([x.reshape(1, -1) for x, _ in quant.values()],
                                           cfg.t_k, [ax for _, ax in quant.values()])
                     if quant else []))
    total = quantized = 0
    zero_counts, shard_zeros = [], []
    for path, leaf in flatten_with_path(params):
        n = leaf.numel() * (math.prod(a.size for a in cut[path][1]) if path in cut else 1)
        total += n
        if is_quantizable(path, leaf, cfg):
            quantized += n
            if path in stats:
                denom, delta = stats[path]
                shard_zeros.append(torch.sum(scaled_abs(leaf.reshape(1, -1), denom) <= delta))
                continue
            theta_s = scale_layer(leaf)
            delta = fttq_threshold(theta_s, cfg.t_k, cfg.threshold_rule)
            zero_counts.append(torch.sum(torch.abs(theta_s) <= delta))
    zero_counts += reduce_over(shard_zeros, [ax for _, ax in quant.values()])
    zeros = int(torch.stack(zero_counts).cpu().sum(dtype=torch.int64)) if zero_counts else 0
    return {"total_params": total, "quantized_params": quantized,
            "quantized_fraction": quantized / max(total, 1),
            "ternary_sparsity": zeros / max(quantized, 1)}
