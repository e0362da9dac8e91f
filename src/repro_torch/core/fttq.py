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
import functools
import math
import re
from typing import Any

import torch

from repro_torch.dtypes import (
    TINY, flush_plus, flush_subnormal, flushed_abs, flushed_op, is_floating,
    keep_cut, largest_subnormal, xla_op,
)
from repro_torch.kernels.qat_backward import qat_backward, qat_backward_bf16
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
    otherwise), the product in fp32, flushed by its exact value
    (``dtypes.flushed_op``), then rounded to ``dtype``. Each op on these
    (L, 1) tensors is a launch, and the eager QAT of a model of small
    leaves pays for every one, so for 0 ≤ T_k < 1 two do it: XLA keeps the
    product of a stat ≥ 0 exactly where stat ≥ c, c the least fp32 whose
    exact product with T_k is at least ``dtypes.KEEP`` (found on the host,
    once a T_k), so a ``threshold`` at the fp32 below c (which passes NaN)
    and the product: a subnormal stat lies below c, the product of a kept
    one is normal, and the zero is +0 on both sides."""
    t = float(torch.tensor(t_k, dtype=dtype))
    stat = stat.to(dtype).to(torch.float32)
    if 0.0 <= t < 1.0:
        return (torch.nn.functional.threshold(stat, _below_kept(t), 0.0) * t).to(dtype)
    return flushed_op(torch.mul, stat, t).to(dtype)


@functools.lru_cache(maxsize=64)
def _below_kept(t: float) -> float:
    """The fp32 value just below the least stat ≥ 0 whose product with the
    fp32 factor t XLA keeps (``dtypes.flushed_op``'s cut)."""
    cut = keep_cut(torch.tensor(t, dtype=torch.float32), torch.mul)
    return float(torch.nextafter(cut, torch.zeros_like(cut)))


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
    return flushed_op(torch.div, num, den).to(theta.dtype)


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


def _quotient_cut(rows: torch.Tensor, denom: torch.Tensor) -> torch.Tensor | None:
    """The per-row cut on |θ| of a (L, m) weight and its (L, 1) denom (d >
    0): XLA keeps θ_s = θ / d (reads it as other than a zero) exactly where
    |θ| ≥ TINY · max(d, 1); None for a dtype XLA never flushes there.

    fp32: θ is read as a zero unless normal, and the quotient is flushed
      unless its exact value is at least KEEP (``dtypes.KEEP``). For d ≤ 1
      a normal θ has a quotient at least as large, so the cut is TINY. For
      d > 1 the cut is the least fp32 ≥ KEEP·d = TINY·d·(1 − 2^-25), which
      is TINY·d itself (exact): the fp32 below it lies at least 2^-24 of it
      lower.
    bf16: θ_s = bf16(fl32(θ / d)) rounds an fp32 quotient that XLA flushes
      first, and a flushed quotient just below TINY rounds up to TINY in
      bf16, so the cut is on θ too. For d < 1 the quotient of a normal θ is
      normal. For d ≥ 1, |θ| ≥ TINY·d gives |θ|/d ≥ TINY; the next bf16
      below is at most TINY·d·(1 − 2^-8), and its fp32 quotient, at most
      TINY·(1 − 2^-8), an fp32 subnormal on the grid, stays below TINY.
    A NaN d cuts everything (its quotient is NaN all the same)."""
    if rows.dtype in (torch.float32, torch.bfloat16):
        return TINY * denom.clamp(min=1.0)
    return None


def _signed_abs(rows: torch.Tensor, denom: torch.Tensor, sign: int) -> torch.Tensor:
    """sign · |θ_s| of a (L, m) weight as XLA reads it (``scaled_abs``),
    for sign ±1: |θ| / (sign · d), exactly sign · |θ / d|, times the mask
    of the kept weights, in three passes over a new tensor. Where XLA reads
    a zero it is a zero; where θ_s is NaN (a NaN θ or d, or inf / inf) it
    is NaN."""
    a = rows.abs()
    cut = _quotient_cut(rows, denom)
    keep = None if cut is None else a >= cut
    a = a.div_(denom if sign > 0 else -denom)
    return a if keep is None else a.mul_(keep)


def scaled_abs(rows: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """|θ_s| = |rows / denom| of a (L, m) weight and its (L, 1) denom as XLA
    reads it: zero where θ or the quotient is flushed (which makes θ_s a
    zero of θ's sign there), |θ_s| elsewhere. The cut is on |θ|, per row
    (``_quotient_cut``), so the quotient itself is never tested: an exact
    quotient just below KEEP that rounds up to TINY is a zero, as XLA's
    is."""
    return _signed_abs(rows, denom, 1)


def _row_stat(signed: torch.Tensor, rule: str) -> torch.Tensor:
    """The mean or max of |θ_s| per row, as (L, 1), from ``_signed_abs``'s
    −|θ_s| (negation commutes with both, bit for bit)."""
    if rule == "mean":
        return -signed.mean(dim=1, keepdim=True, dtype=torch.float32)
    if rule == "max":
        return -signed.amin(dim=1, keepdim=True)
    raise ValueError(f"unknown threshold rule: {rule!r}")


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


def _codes(rows: torch.Tensor, neg: torch.Tensor, cut: torch.Tensor) -> torch.Tensor:
    """I_t = sign(flush(θ_s)) · [flush(|θ_s|) > Δ'] for Δ' = flush(Δ), given
    neg = −|θ_s| as ``_signed_abs`` reads it and cut = max(Δ', 0): ±1 where
    |θ_s| > cut, a zero of θ's sign elsewhere, NaN where θ_s is NaN. A
    kept |θ_s| is normal and Δ' is 0 or normal, so this is the mask
    wherever Δ ≥ 0; where a negative Δ selects a flushed θ_s, XLA's code is
    sign(±0) · 1 = ±0, as here. max(mask, −|θ_s|) is the mask (−|θ_s| ≤ 0)
    but NaN where |θ_s| is, which XLA's sign(NaN) · 0 is; the sign is θ's,
    which is θ_s's for d > 0."""
    return torch.maximum(neg < -cut, neg).copysign_(rows)


def scaled_codes(rows: torch.Tensor, denom: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """I_t = ternarize(rows / denom, Δ) of a (L, m) weight with (L, 1)
    scalars, as XLA forms it (a subnormal θ, θ_s or Δ is a zero; a NaN θ_s
    gives a NaN code)."""
    cut = flush_subnormal(delta).clamp_min(0.0)
    return _codes(rows, _signed_abs(rows, denom, -1), cut)


def row_codes(rows: torch.Tensor, t_k: float, rule: str = "mean") -> torch.Tensor:
    """I_t of a (L, m) weight, each row with its own scale and threshold.
    A row with a NaN weight has a NaN denom, so every θ_s and code of it is
    NaN; a ±inf weight has the code NaN (inf / inf) and its row's others
    ±0 (their Δ is NaN), as the reference's."""
    denom = row_denom(rows)
    neg = _signed_abs(rows, denom, -1)
    delta = _times_tk(t_k, _row_stat(neg, rule), rows.dtype)   # ≥ 0 (or NaN) for T_k ≥ 0
    return _codes(rows, neg, delta if t_k >= 0 else delta.clamp_min(0.0))


def leaf_row_stats(rows: list, t_k: float, axes: list) -> list:
    """(denom, Δ), each (L, 1), per row of every (L, m) shard in ``rows``,
    from the whole leaf: the row maxima all-reduced (MAX) and Σ|θ_s|
    all-reduced (SUM) over every mesh axis in ``axes[i]`` (the
    ``MeshAxis`` tuple that cuts ``rows[i]``), the mean over the whole
    row's m · Π sizes elements. One all-reduce of each kind per axis for
    all of them; the sums in fp32, as a one-device mean accumulates. Each
    term is |θ_s| as ``scaled_abs`` reads it, 0 or at least TINY, so no
    partial sum is subnormal and a shard's flushed sum is its exact one;
    the mean and Δ of the whole row are flushed as one device's are. A
    shard's NaN row maximum travels as a flag beside the maxima in the same
    all-reduce, since ``gloo``'s MAX keeps a NaN only from its first
    operand; the whole row's maximum is then NaN, as XLA's is."""
    from repro_torch.parallel.tensor import reduce_over

    parts = []
    for r in rows:
        m = _row_abs_max(r).reshape(-1).to(torch.float32)
        parts.append(torch.cat([m, torch.isnan(m).to(torch.float32)]))
    mx = [torch.where(flag > 0, torch.nan, m) for m, flag in
          (p.chunk(2) for p in reduce_over(parts, axes, "max"))]
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
    cut over, whose ranks' g_wq the backward sums. ``cut``: the (L, 1)
    cut of fp32 w_q's backward product (``backward_cuts``), made here where
    the caller has not made it for many factors at once."""

    @staticmethod
    def forward(ctx, theta, w_q, t_k, stats=None, axes=(), cut=None):
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
        w = flush_plus(w).copysign_(w)
        ctx.save_for_backward(i_t, w_q)
        ctx.axes, ctx.cut = axes, cut
        return (w * i_t).reshape(theta.shape)

    @staticmethod
    def backward(ctx, g):
        i_t, w_q = ctx.saved_tensors
        n_rows = w_q.numel()
        g_rows = g.reshape(n_rows, -1)
        w = w_q.reshape(n_rows, 1)
        # XLA reads a subnormal cotangent as a zero: so does each term of
        # Σ g·I_t (I_t is ±1 or ±0) and the product g · w_q, which is also
        # flushed by its exact value (``dtypes.flushed_product``)
        if g.dtype == torch.float32:
            cut = ctx.cut if ctx.cut is not None else backward_cuts([w_q])[0]
            g_theta, g_it = qat_backward(g_rows, i_t, flush_plus(w), cut)
        else:
            g_theta, g_it = qat_backward_bf16(g_rows, i_t, w)
        # a flushed g_wq is +0 where XLA's zero keeps the sum's sign: Adam's
        # m and v cannot tell them apart
        g_wq = flush_plus(g_it.sum(dim=1)).reshape(w_q.shape).to(w_q.dtype)
        if ctx.axes:
            from repro_torch.parallel.tensor import reduce_over

            (g_wq,) = reduce_over([g_wq], [ctx.axes])
            g_wq = flush_plus(g_wq)
        return g_theta.reshape(g.shape), g_wq, None, None, None, None


def backward_cuts(wqs: list) -> list:
    """For each fp32 factor in ``wqs``, the (L, 1) cut on |g| of the QAT
    backward's g · w_q (``dtypes.flushed_op``'s, of the flushed w_q): all
    of them in one batch of small ops, since the eager QAT of a model of
    small leaves pays for every launch."""
    flat = torch.cat([w.detach().reshape(-1) for w in wqs])
    cut = keep_cut(flush_plus(flat), torch.mul)
    return [c.reshape(-1, 1) for c in cut.split([w.numel() for w in wqs])]


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
            wq = flushed_op(torch.div, num, den + _EPS).to(leaf.dtype)
            return wq.reshape(((leaf.shape[0],) + (1,) * (leaf.ndim - 1))
                              if leaf.ndim >= 3 else ())
        if leaf.ndim >= 3:
            rows = leaf.reshape(leaf.shape[0], -1)
            abs_s = scaled_abs(rows, row_denom(rows))
            sel = _above(abs_s, row_threshold(abs_s, cfg.t_k, cfg.threshold_rule))
            num = torch.where(sel, rows.abs(), 0.0).sum(dim=1)
            den = sel.sum(dim=1).to(torch.float32) + _EPS
            return flushed_op(torch.div, num, den).to(leaf.dtype).reshape(
                (leaf.shape[0],) + (1,) * (leaf.ndim - 1))
        return init_wq(leaf, cfg)

    return tree_map_with_path(make, params)


def quantize_tree(params: Any, wq_tree: Any, cfg: FTTQConfig, shards=None) -> Any:
    """QAT forward over a tree: every leaf with a factor in ``wq_tree``
    (as made by ``init_wq_tree``) is quantized, the rest pass through. A
    shard (``shards``) is quantized with its whole leaf's statistics."""
    wqs = dict(flatten_with_path(wq_tree))
    cut = _shards(params, lambda p, _: wqs.get(p) is not None, shards)
    fp32 = [p for p, w in wqs.items() if w is not None and w.dtype == torch.float32]
    with torch.no_grad():
        stats = dict(zip(cut, leaf_row_stats(
            [x.reshape(wqs[p].numel(), -1) for p, (x, _) in cut.items()], cfg.t_k,
            [ax for _, ax in cut.values()]) if cut else []))
        cuts = dict(zip(fp32, backward_cuts([wqs[p] for p in fp32]) if fp32 else []))

    def one(path, leaf):
        wq = wqs.get(path)
        if wq is None:
            return leaf
        if path in stats:
            return FTTQQuantize.apply(leaf, wq, cfg.t_k, stats[path], cut[path][1],
                                      cuts.get(path))
        return FTTQQuantize.apply(leaf, wq, cfg.t_k, None, (), cuts.get(path))

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
