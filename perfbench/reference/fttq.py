"""FTTQ (arXiv:2003.03564 §III.A, eqs. 6-12) in plain PyTorch, each step
rounded to the weights' own dtype, as a configuration in that dtype states
it:

    θ_s = θ / (max|θ| + 1e-8)                   layer-wise scale       (eq. 6)
    Δ   = T_k · mean|θ_s|                        threshold              (eq. 8)
    I_t = sign(θ_s) · [|θ_s| > Δ]                ternary codes          (eq. 11)
    w_q = mean |θ| over the selected positions   the Prop-4.1 scale

A leaf of three or more dims is "stacked": one row (scale, Δ and factor)
per leading index; a matrix is one row. The server re-quantizes with the
fixed Δ = ``server_delta`` (§III.B); a deployed checkpoint scales each
whole leaf as one row. Weights of fewer than two dims, and those whose path
names a norm, a bias, a scale or an embedding table, stay full precision.

Sums are taken in float64, so each statistic is the correctly rounded value
of its dtype.
"""

from __future__ import annotations

import torch

EPS = 1e-8
_EXCLUDE = ("norm", "bias", "scale", "ln_", "layernorm", "a_log", "dt_",
            "embed", "lm_head", "unembed", "patch_proj", "frontend")


def quantized(path: str, shape) -> bool:
    """Whether the FTTQ policy ternarizes the leaf at ``path``."""
    return len(shape) >= 2 and not any(word in path.lower() for word in _EXCLUDE)


def rows_of(leaf: torch.Tensor, stacked: bool) -> torch.Tensor:
    return leaf.reshape(leaf.shape[0] if stacked and leaf.ndim >= 3 else 1, -1)


def scaled(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(θ_s, the scale divisor) per row, both in the rows' dtype."""
    dt = rows.dtype
    denom = (rows.float().abs().amax(dim=1, keepdim=True) + EPS).to(dt)
    return (rows.float() / denom.float()).to(dt), denom


def mean_threshold(theta_s: torch.Tensor, t_k: float) -> torch.Tensor:
    """Δ = T_k · mean|θ_s| per row, T_k and the mean each in the dtype."""
    dt = theta_s.dtype
    stat = theta_s.double().abs().mean(dim=1, keepdim=True).to(dt)
    t = torch.tensor(t_k, dtype=dt).item()
    return (stat.float() * t).to(dt)


def ternarize(theta_s: torch.Tensor, delta) -> torch.Tensor:
    delta = torch.as_tensor(delta, dtype=theta_s.dtype, device=theta_s.device)
    return torch.sign(theta_s) * (theta_s.abs() > delta).to(theta_s.dtype)


def codes(rows: torch.Tensor, t_k: float, delta=None) -> torch.Tensor:
    """I_t per row, by the mean rule or at a fixed ``delta``."""
    theta_s, _ = scaled(rows)
    return ternarize(theta_s, mean_threshold(theta_s, t_k) if delta is None else delta)


def prop41_scale(rows: torch.Tensor, i_t: torch.Tensor) -> torch.Tensor:
    """mean |θ| over the selected positions, per row, in the rows' dtype."""
    sel = i_t != 0
    num = torch.where(sel, rows.double().abs(), 0.0).sum(dim=1)
    return (num / (sel.sum(dim=1).double() + EPS)).to(rows.dtype)


def init_factor(leaf: torch.Tensor, t_k: float) -> torch.Tensor:
    """A trained factor at its Prop-4.1 optimum: (L, 1, ..., 1) for a
    stacked leaf, a scalar for a matrix."""
    rows = rows_of(leaf, True)
    w = prop41_scale(rows, codes(rows, t_k))
    return w.reshape((leaf.shape[0],) + (1,) * (leaf.ndim - 1)) if leaf.ndim >= 3 else w[0]


def requantize(leaf: torch.Tensor, *, t_k: float, delta=None, stacked: bool = True
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes shaped as the leaf, one scale a row) with the Prop-4.1 scale:
    the server's broadcast (``delta`` = server_delta) or a deployed leaf
    (``stacked=False``, the mean rule)."""
    rows = rows_of(leaf, stacked)
    i_t = codes(rows, t_k, delta)
    return i_t.reshape(leaf.shape), prop41_scale(rows, i_t)


def dequantize(i_t: torch.Tensor, scales: torch.Tensor, dtype=None) -> torch.Tensor:
    """w_q · I_t, one scale a row of the codes' leading dim (or one for all)."""
    n = scales.numel()
    rows = i_t.reshape(n, -1).to(torch.float32) * scales.reshape(n, 1).to(torch.float32)
    return rows.reshape(i_t.shape).to(dtype or scales.dtype)
