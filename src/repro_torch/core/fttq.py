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

from repro_torch.dtypes import is_floating
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
    is bit-identical to ``jnp.max(jnp.abs(theta))``)."""
    return torch.maximum(theta.amax(), -theta.amin())


def scale_layer(theta: torch.Tensor, denom: torch.Tensor | None = None) -> torch.Tensor:
    """g(θ): scale one layer's weights into [-1, 1] (eq. 6), layer-wise."""
    if denom is None:
        denom = abs_max(theta) + _EPS
    return theta / denom


def _t(t_k: float, like: torch.Tensor) -> torch.Tensor:
    """T_k in the weights' dtype, as JAX rounds a Python scalar to the array's
    dtype before it multiplies (a bf16 Δ would round once more otherwise)."""
    return torch.tensor(t_k, dtype=like.dtype, device=like.device)


def fttq_threshold(theta_s: torch.Tensor, t_k: float, rule: str = "mean") -> torch.Tensor:
    """Δ for one layer. rule="mean" is eq. (8); rule="max" is eq. (7)."""
    if rule == "mean":
        return _t(t_k, theta_s) * torch.mean(torch.abs(theta_s))
    if rule == "max":
        return _t(t_k, theta_s) * abs_max(theta_s)
    raise ValueError(f"unknown threshold rule: {rule!r}")


def ternarize(theta_s: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """I_t = sign(ε(|θ_s| − Δ) ⊙ θ_s) ∈ {-1, 0, +1} (eqs. 10-11)."""
    mask = (torch.abs(theta_s) > delta).to(theta_s.dtype)
    return torch.sign(theta_s) * mask


def init_wq(theta: torch.Tensor, cfg: FTTQConfig) -> torch.Tensor:
    """w_q at its Prop-4.1 optimum: mean |θ| over the selected positions,
    in ORIGINAL (unscaled) units."""
    theta_s = scale_layer(theta)
    delta = fttq_threshold(theta_s, cfg.t_k, cfg.threshold_rule)
    sel = torch.abs(theta_s) > delta
    num = torch.sum(torch.where(sel, torch.abs(theta), 0.0))
    den = torch.sum(sel).to(torch.float32) + _EPS
    return (num / den).to(theta.dtype)


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
    return torch.maximum(rows.amax(dim=1, keepdim=True), -rows.amin(dim=1, keepdim=True))


def row_denom(rows: torch.Tensor) -> torch.Tensor:
    """max|θ| + ε per row of a (L, m) weight, as (L, 1): each row (a layer
    of a stacked leaf, or a whole leaf as one row) is scaled on its own."""
    return _row_abs_max(rows) + _EPS


def row_threshold(theta_s: torch.Tensor, t_k: float, rule: str = "mean") -> torch.Tensor:
    """Δ per row of a (L, m) scaled weight, as (L, 1)."""
    if rule == "mean":
        return _t(t_k, theta_s) * theta_s.abs().mean(dim=1, keepdim=True)
    if rule == "max":
        return _t(t_k, theta_s) * _row_abs_max(theta_s)
    raise ValueError(f"unknown threshold rule: {rule!r}")


def row_codes(rows: torch.Tensor, t_k: float, rule: str = "mean") -> torch.Tensor:
    """I_t of a (L, m) weight, each row with its own scale and threshold."""
    theta_s = rows / row_denom(rows)
    return ternarize(theta_s, row_threshold(theta_s, t_k, rule))


def leaf_row_stats(rows: list, t_k: float, axes: list) -> list:
    """(denom, Δ), each (L, 1), per row of every (L, m) shard in ``rows``,
    from the whole leaf: the row maxima all-reduced (MAX) and Σ|θ_s|
    all-reduced (SUM) over every mesh axis in ``axes[i]`` (the
    ``MeshAxis`` tuple that cuts ``rows[i]``), the mean over the whole
    row's m · Π sizes elements. One all-reduce of each kind per axis for
    all of them; the sums in fp32, as a one-device mean accumulates."""
    from repro_torch.parallel.tensor import reduce_over

    mx = reduce_over([_row_abs_max(r).reshape(-1).to(torch.float32) for r in rows], axes, "max")
    denoms = [part.to(r.dtype).reshape(-1, 1) + _EPS for r, part in zip(rows, mx)]
    sums = reduce_over([(r / d).abs().sum(dim=1, dtype=torch.float32)
                        for r, d in zip(rows, denoms)], axes)
    out = []
    for r, d, part, ax in zip(rows, denoms, sums, axes):
        whole = r.shape[1] * math.prod(a.size for a in ax)
        out.append((d, _t(t_k, r) * (part / whole).to(r.dtype).reshape(-1, 1)))
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
            i_t = ternarize(rows / denom, delta)
        w = w_q.reshape(n_rows, 1)
        ctx.save_for_backward(i_t, w_q)
        ctx.axes = axes
        return (w * i_t).reshape(theta.shape)

    @staticmethod
    def backward(ctx, g):
        i_t, w_q = ctx.saved_tensors
        n_rows = w_q.numel()
        g_rows = g.reshape(n_rows, -1)
        g_wq = (g_rows * i_t).sum(dim=1).reshape(w_q.shape).to(w_q.dtype)
        if ctx.axes:
            from repro_torch.parallel.tensor import reduce_over

            (g_wq,) = reduce_over([g_wq], [ctx.axes])
        w = w_q.reshape(n_rows, 1)
        scale = torch.where(i_t != 0, w, torch.ones_like(w))
        g_theta = (g_rows * scale).reshape(g.shape)
        return g_theta, g_wq, None, None, None


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
        sel = (rows / denom).abs() > delta
        sums[path] = torch.stack([torch.where(sel, rows.abs(), 0.0).sum(dim=1, dtype=torch.float32),
                                  sel.sum(dim=1).to(torch.float32)])
    sums = dict(zip(sums, reduce_over(list(sums.values()), [cut[p][1] for p in sums])))

    def make(path, leaf):
        if not is_quantizable(path, leaf, cfg):
            return None
        if path in sums:
            num, den = sums[path]
            wq = (num / (den + _EPS)).to(leaf.dtype)
            return wq.reshape(((leaf.shape[0],) + (1,) * (leaf.ndim - 1))
                              if leaf.ndim >= 3 else ())
        if leaf.ndim >= 3:
            rows = leaf.reshape(leaf.shape[0], -1)
            theta_s = rows / row_denom(rows)
            sel = theta_s.abs() > row_threshold(theta_s, cfg.t_k, cfg.threshold_rule)
            num = torch.where(sel, rows.abs(), 0.0).sum(dim=1)
            den = sel.sum(dim=1).to(torch.float32) + _EPS
            return (num / den).to(leaf.dtype).reshape(
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
                shard_zeros.append(torch.sum(torch.abs(leaf / denom.reshape(())) <= delta))
                continue
            theta_s = scale_layer(leaf)
            delta = fttq_threshold(theta_s, cfg.t_k, cfg.threshold_rule)
            zero_counts.append(torch.sum(torch.abs(theta_s) <= delta))
    zero_counts += reduce_over(shard_zeros, [ax for _, ax in quant.values()])
    zeros = int(torch.stack(zero_counts).cpu().sum(dtype=torch.int64)) if zero_counts else 0
    return {"total_params": total, "quantized_params": quantized,
            "quantized_fraction": quantized / max(total, 1),
            "ternary_sparsity": zeros / max(quantized, 1)}
