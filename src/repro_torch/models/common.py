"""Shared model building blocks: norms, RoPE, activations, initializers,
and the weight-matmul dispatch that lets serving run on packed 2-bit
weights without touching the layer code (port of ``repro.models.common``)."""

from __future__ import annotations

import torch

from repro_torch.models import elementwise


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w``; a ``PackedTernary`` weight routes through the packed
    ternary matmul kernel instead of a dense product."""
    from repro_torch.kernels.repack import PackedTernary, packed_matmul

    if isinstance(w, PackedTernary):
        return packed_matmul(x, w)
    return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor | None, eps: float = 1e-6,
             mean_sq=None) -> torch.Tensor:
    """RMSNorm; scale=None gives the non-parametric variant. ``mean_sq``
    maps the (…, m) squares to the (…, 1) mean they enter with (default: the
    mean over the last axis); a row cut over ranks gives the whole row's."""
    xf = x.to(torch.float32)
    sq = xf * xf
    var = torch.mean(sq, dim=-1, keepdim=True) if mean_sq is None else mean_sq(sq)
    y = xf * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * (1.0 + scale.to(torch.float32))
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor | None, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm (mean-centred, population variance); scale=None →
    non-parametric (OLMo-style)."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * (1.0 + scale.to(torch.float32))
    return y.to(x.dtype)


def apply_norm(x: torch.Tensor, scale: torch.Tensor | None, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, scale)
    if kind == "layernorm":
        return layer_norm(x, scale)
    if kind == "nonparam":
        return layer_norm(x, None)
    raise ValueError(f"unknown norm kind {kind!r}")


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotate (..., S, H, D) by per-token positions (..., S)."""
    inv_freq = rope_frequencies(x.shape[-1], theta, x.device)
    ang = positions[..., :, None].to(torch.float32) * inv_freq  # (..., S, D/2)
    sin = torch.sin(ang)[..., :, None, :]
    cos = torch.cos(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def act_fn(name: str):
    """The activation ``name`` as the reference's ``jax.nn`` computes it
    (``models.elementwise``: XLA's bf16 steps at bf16, PyTorch's function
    at other dtypes)."""
    return {"gelu": elementwise.gelu, "silu": elementwise.silu, "relu": elementwise.relu}[name]


def dense_init(gen: torch.Generator, shape, dtype, in_axis: int = -2) -> torch.Tensor:
    """Lecun-normal init with fan_in from the given axis; drawn on the
    generator's device."""
    std = float(shape[in_axis]) ** -0.5
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return x.mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return x.mul_(0.02).to(dtype)
