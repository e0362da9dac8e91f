"""The models' elementwise steps at bf16 as XLA computes them (the
reference's ``jax.nn.silu``, ``jax.nn.gelu``, ``jax.nn.relu``, ``jnp.tanh``
and its residual adds).

XLA computes a bf16 elementwise op in fp32 and rounds each op's result to
bf16, one op at a time, with its constants rounded to bf16 (gelu's √(2/π)
is 0.796875, its 0.044715 is 0.044677734375); on the CPU, as on the TPU, it
reads a subnormal operand as a zero of its sign and flushes a subnormal
result (``dtypes.flush_subnormal``). PyTorch's ``F.silu`` and ``F.gelu``
compute the whole function in fp32 with exact constants, keep subnormals
and round once, which gives other bits on 1,866 (silu) and 1,518 (gelu) of
the 65,280 finite bf16 inputs, and autograd's derivatives other bits still.
The functions here take the reference's op order, forward and backward
(the VJP that JAX's autodiff makes of the same ops), one rounded and
flushed fp32 step (``_step``) at a time. On every bf16 bit pattern they
give the reference's bits, forward and backward
(``tests/test_torch_bf16_activations.py``): XLA's fp32 ``exp`` and
``tanh`` differ from PyTorch's in the last bits of some results, but never
across a bf16 rounding on these inputs.

Other dtypes take PyTorch's functions as before (fp32 holds its parity
with the reference as it did; the test samples it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dtypes import TINY, flush_subnormal

BF16 = torch.bfloat16
# jax.nn.gelu's constants as XLA holds them at bf16
_GELU_C = 0.044677734375
_GELU_S = 0.796875


def _step(t: torch.Tensor) -> torch.Tensor:
    """An fp32 step's result as XLA stores it at bf16: a subnormal flushed
    (a zero of its sign), then rounded to bf16; returned in fp32 for the
    next step."""
    return t.mul_(t.abs() >= TINY).to(BF16).to(torch.float32)


def _read(x: torch.Tensor) -> torch.Tensor:
    """A bf16 operand as XLA reads it, in fp32: a subnormal as a zero."""
    return flush_subnormal(x.to(torch.float32))


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``lax.logistic`` as XLA expands it: 1 / (1 + exp(−x)), step by step."""
    return _step(torch.reciprocal(_step(_step(torch.exp(-x)) + 1.0)))


class _Silu(torch.autograd.Function):
    """x · logistic(x); backward g·s + (x·g)·(s·(1 − s)) as JAX's autodiff
    orders it."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        xr = _read(x)
        return _step(xr * _sigmoid(xr)).to(BF16)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        xr, gr = _read(x), _read(g)
        s = _sigmoid(xr)
        c = _step(s * _step(1.0 - s))
        return _step(_step(gr * s) + _step(_step(xr * gr) * c)).to(BF16)


def _gelu_parts(xr: torch.Tensor):
    """(x², tanh(√(2/π)·(x + 0.044715·x³)), ½·(1 + tanh)) of jax.nn.gelu's
    tanh form, each step rounded."""
    x2 = _step(xr * xr)
    inner = _step(xr + _step(_step(x2 * xr) * _GELU_C))
    t = _step(torch.tanh(_step(inner * _GELU_S)))
    return x2, t, _step(_step(t + 1.0) * 0.5)


class _Gelu(torch.autograd.Function):
    """jax.nn.gelu (approximate=True): x · ½(1 + tanh(√(2/π)(x + 0.044715x³)))."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        xr = _read(x)
        return _step(xr * _gelu_parts(xr)[2]).to(BF16)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        xr, gr = _read(x), _read(g)
        x2, t, cdf = _gelu_parts(xr)
        # the transposed JVP, in the order JAX's autodiff emits it
        p = _step(_step(_step(xr * gr) * 0.5) * _step(1.0 - t))
        s = _step(_step(p + _step(p * t)) * _GELU_S)
        out = _step(_step(gr * cdf) + s)
        return _step(out + _step(_step(s * _GELU_C) * _step(x2 * 3.0))).to(BF16)


class _Relu(torch.autograd.Function):
    """max(x, 0) with a subnormal x read as zero (+0 for −0 and every x
    below 2^-126, NaN kept); backward select(x > 0, g, 0), g as it comes."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.where(x < TINY, torch.zeros((), dtype=x.dtype, device=x.device), x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= TINY, g, torch.zeros((), dtype=g.dtype, device=g.device))


class _Tanh(torch.autograd.Function):
    """tanh; backward (g·(1 − t)) + (g·(1 − t))·t as JAX's autodiff orders
    it (PyTorch's g·(1 − t²) rounds once)."""

    @staticmethod
    def forward(ctx, x):
        t = torch.tanh(x)
        ctx.save_for_backward(t)
        return t

    @staticmethod
    def backward(ctx, g):
        (t,) = ctx.saved_tensors
        tr = t.to(torch.float32)
        e = _step(_read(g) * _step(1.0 - tr))
        return _step(e + _step(e * tr)).to(BF16)


class _Add(torch.autograd.Function):
    """a + b with subnormal operands read as zeros and a subnormal sum
    flushed; the cotangent passes to both as it comes."""

    @staticmethod
    def forward(ctx, a, b):
        return flush_subnormal(flush_subnormal(a) + flush_subnormal(b))

    @staticmethod
    def backward(ctx, g):
        return g, g


def _bf16(x) -> bool:
    return x.dtype == BF16


def silu(x: torch.Tensor) -> torch.Tensor:
    return _Silu.apply(x) if _bf16(x) else F.silu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default, the tanh approximation."""
    return _Gelu.apply(x) if _bf16(x) else F.gelu(x, approximate="tanh")


def relu(x: torch.Tensor) -> torch.Tensor:
    return _Relu.apply(x) if _bf16(x) else F.relu(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return _Tanh.apply(x) if _bf16(x) else torch.tanh(x)


def residual_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A residual add ``a + b``: at bf16 as XLA adds (subnormals read and
    flushed as zeros), else PyTorch's."""
    return _Add.apply(a, b) if _bf16(a) and _bf16(b) else a + b
