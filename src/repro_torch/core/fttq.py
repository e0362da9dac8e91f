"""Federated Trained Ternary Quantization (FTTQ) — the layer statistics.

Port of the forward half of ``repro.core.fttq`` (paper §III.A, eqs. 6-12):

    θ_s  = g(θ)                    layer-wise scale to [-1, 1]          (eq. 6)
    Δ    = T_k / m · Σ_i |θ_s_i|   sparsity-aware threshold             (eq. 8)
    I_t  = sign(ε(|θ_s| − Δ) ⊙ θ_s) ternary codes in {-1, 0, +1}        (eq. 11)

plus the policy that decides which leaves of a parameter tree are
quantized. The straight-through ``fttq_quantize`` arrives with the
federated training slice.
"""

from __future__ import annotations

import dataclasses
import re

import torch

from repro_torch.dtypes import is_floating
from repro_torch.tree import Path, path_str

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


def fttq_threshold(theta_s: torch.Tensor, t_k: float, rule: str = "mean") -> torch.Tensor:
    """Δ for one layer. rule="mean" is eq. (8); rule="max" is eq. (7)."""
    if rule == "mean":
        return t_k * torch.mean(torch.abs(theta_s))
    if rule == "max":
        return t_k * abs_max(theta_s)
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
