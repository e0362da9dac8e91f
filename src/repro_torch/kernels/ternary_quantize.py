"""Fused FTTQ apply (scale → threshold → ternarize → rescale):
``csrc/ternary_quantize.cu``.

Replaces the TPU kernel ``repro/kernels/ternary_quantize.py::_kernel``
(``ternary_quantize``). The layer statistics — 1/max|θ|, Δ and w_q — are
scalars from plain reductions (``kernels.ops.fttq_apply``); the kernel is
the elementwise pass that emits both the int8 codes I_t and the rescaled
θ_t = w_q · I_t in θ's dtype, from one read of θ.

The arithmetic is done in θ's dtype, as the reference does: each scalar is
rounded to that dtype once, θ·s is rounded to it before the compare, and
I_t = sign(θ·s) where |θ·s| > Δ, else 0. In bf16 the product of two bf16
values is exact in fp32, so one rounding gives the bf16 product, and the
compare and w_q·I_t are exact: fp32 and bf16 are both bit-identical to the
Pallas kernel. Subnormals are treated as XLA treats them
(``dtypes.flush_subnormal``): a subnormal θ or scalar enters as a zero of
its sign, and a subnormal product θ·s is flushed before the compare.

Bound on the H100: bytes — one read and two writes per weight (9 B in
fp32, 5 B in bf16). Each thread takes 4 consecutive elements with one
vector load and two vector stores.

``ternary_quantize`` dispatches on the tensor's device: the plain PyTorch
version for a CPU tensor, the CUDA kernel for a CUDA tensor (or it raises).
``ternary_quantize.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.dtypes import flush_subnormal, flushed_op

_THREADS = 256
_MAX_BLOCKS = 132 * 16
_DTYPES = (torch.float32, torch.bfloat16)


def _scalar(s, dtype: torch.dtype, device) -> torch.Tensor:
    """A layer scalar as fp32 (the reference stacks them in fp32), then in
    θ's dtype, flushed if subnormal there."""
    return flush_subnormal(torch.as_tensor(s, dtype=torch.float32).to(device=device).to(dtype))


def ternary_quantize_plain(theta: torch.Tensor, inv_scale, delta, w_q
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (``repro.kernels.ref.ternary_quantize_ref``):
    (I_t int8, θ_t in θ's dtype), same shape as θ."""
    dt = theta.dtype
    wide = torch.promote_types(dt, torch.float32)
    xs = flushed_op(torch.mul, theta.to(wide), _scalar(inv_scale, dt, theta.device).to(wide)
                    ).to(dt)
    mask = xs.abs() > _scalar(delta, dt, theta.device)
    sign = torch.where(xs > 0, 1.0, torch.where(xs < 0, -1.0, xs)).to(dt)
    i_t = torch.where(mask, sign, torch.zeros((), dtype=dt, device=theta.device))
    return i_t.to(torch.int8), _scalar(w_q, dt, theta.device) * i_t


def _lib():
    from repro_torch.kernels import _build

    fn = _build.load("ternary_quantize").ternary_quantize_apply
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, ctypes.c_longlong, p, i, i, p, p, i, p]
        fn.restype = ctypes.c_int
    return fn


def ternary_quantize(theta: torch.Tensor, inv_scale, delta, w_q
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """FTTQ apply for one weight tensor (any shape, read flat): returns
    (I_t int8, θ_t in θ's dtype). The three scalars are Python floats or
    one-element tensors; see ``ternary_quantize_plain``."""
    if theta.device.type == "cpu":
        return ternary_quantize_plain(theta, inv_scale, delta, w_q)
    if theta.device.type != "cuda":
        raise ValueError(f"ternary_quantize: unsupported device {theta.device}")
    if theta.dtype not in _DTYPES:
        raise TypeError(f"ternary_quantize kernel takes float32 or bfloat16, got {theta.dtype}")
    if not theta.is_contiguous():
        raise ValueError("ternary_quantize: theta must be contiguous")
    # the scalars as the reference stacks them, in fp32, read by the kernel
    # from the device (no host sync)
    scal = torch.stack([torch.as_tensor(v, dtype=torch.float32).to(theta.device).reshape(())
                        for v in (inv_scale, delta, w_q)])
    it = torch.empty(theta.shape, dtype=torch.int8, device=theta.device)
    qt = torch.empty_like(theta)
    n = theta.numel()
    if n == 0:
        return it, qt
    width = 4 * theta.element_size()
    vec = int(theta.data_ptr() % width == 0 and qt.data_ptr() % width == 0
              and it.data_ptr() % 4 == 0)
    blocks = max(1, min(-(-max(n // 4, 1) // _THREADS), _MAX_BLOCKS))
    fn = _lib()
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream(theta.device).cuda_stream
        err = fn(theta.data_ptr(), n, scal.data_ptr(), int(theta.dtype == torch.bfloat16),
                 vec, it.data_ptr(), qt.data_ptr(), blocks, stream)
    if err != 0:
        raise RuntimeError(f"ternary_quantize kernel launch failed: CUDA error {err}")
    ternary_quantize.launches += 1
    return it, qt


ternary_quantize.launches = 0
