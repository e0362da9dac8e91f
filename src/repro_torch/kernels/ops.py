"""Kernel-level entry points (port of ``repro.kernels.ops``).

``fttq_apply`` is FTTQ on one layer: the statistics are plain reductions,
as the reference computes them outside its kernel, followed by one
``ternary_quantize`` launch. ``pack2bit``, ``unpack2bit`` and
``ternary_matmul`` are the kernels' device-dispatching wrappers, re-exported.
"""

from __future__ import annotations

import torch

from repro_torch.dtypes import flush_subnormal, flushed_abs, flushed_op, xla_op
from repro_torch.kernels.pack2bit import pack2bit, unpack2bit
from repro_torch.kernels.ternary_matmul import ternary_matmul
from repro_torch.kernels.ternary_quantize import ternary_quantize

__all__ = ["fttq_apply", "fttq_scalars", "pack2bit", "unpack2bit", "ternary_matmul"]


def fttq_scalars(theta: torch.Tensor, t_k: float
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer's statistics (1/max|θ|, Δ, w_q) in θ's dtype, on its
    device: Δ over the scaled weights (eq. 8), w_q at the Prop-4.1 optimum
    over θ/max|θ|. Each step follows XLA's subnormal rule: |θ| is read with
    subnormals as zeros (so its maximum and mean are the flushed ones), and
    every scalar and the scaled weights are flushed where they form, in
    fp32 before a bf16 result is rounded."""
    absw = flushed_abs(theta)
    inv_scale = xla_op(torch.div, 1.0, absw.max() + 1e-8)
    mean = flush_subnormal(absw.mean(dtype=torch.float32)).to(absw.dtype)
    delta = xla_op(torch.mul, xla_op(torch.mul, t_k, mean), inv_scale)
    scaled = xla_op(torch.mul, absw, inv_scale)
    sel = scaled > delta
    w_q = flushed_op(torch.div, torch.where(sel, scaled, 0.0).sum().to(torch.float32),
                     sel.sum() + 1e-8)
    return inv_scale, delta, w_q


def fttq_apply(theta: torch.Tensor, t_k: float
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full FTTQ for one layer: returns (I_t int8, θ_t, w_q), with θ_t and
    w_q in SCALED units."""
    inv_scale, delta, w_q = fttq_scalars(theta, t_k)
    i_t, theta_t = ternary_quantize(theta, inv_scale, delta, w_q)
    return i_t, theta_t, w_q
