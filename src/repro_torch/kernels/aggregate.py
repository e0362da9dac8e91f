"""Packed fan-in aggregation for the T-FedAvg server: ``csrc/aggregate.cu``.

Replaces the TPU kernel ``repro/kernels/aggregate.py::_fanin_kernel``
(``packed_weighted_sum``). The server's aggregation step is
Σ_c coeff_c · dequant(codes_c) over C client updates; the kernel consumes
the WIRE bytes directly — a stacked ``(C, R, LANES)`` uint8 tensor of
flat-packed 2-bit codes (4 codes per byte, ``core.ternary.pack2bit`` order)
and a ``(C,)`` fp32 coefficient vector (weight · w_q, 0 for padding rows)
— and returns the flat fp32 weighted sum of length ``4·R·LANES`` in logical
element order. No per-client dense tree is ever built.

Bound on the H100: bytes — C bytes read and 16 bytes written per output
quad of 4 elements. The TPU kernel interleaved the four bit-planes by rows
and transposed after the call (a TPU layout artifact); the CUDA kernel
writes logical order directly, one thread per 4 packed bytes of every
client and 16 outputs stored as four float4.

Summation order: every element sums clients c = 0..C−1 in order from +0.0,
as the Pallas kernel's ``fori_loop`` does. Each term coeff·(code−1) is
exact, so the kernel, the plain version and the Pallas kernel agree bit for
bit; only the numpy oracle ``packed_weighted_sum_ref`` (a ``tensordot``)
sums in another order.

``packed_weighted_sum`` dispatches on the tensor's device: the plain
PyTorch version for a CPU tensor, the CUDA kernel for a CUDA tensor (or it
raises). ``packed_weighted_sum.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

LANES = 128
BLOCK_ROWS = 32        # byte-rows per block of the reference layout
_THREADS = 256
_MAX_BLOCKS = 132 * 16  # grid-stride beyond 16 blocks per SM of an H100
_MAX_CLIENTS = 12288    # coefficients in the 48 KB of default shared memory


def padded_rows(nbytes: int, block_rows: int = BLOCK_ROWS) -> int:
    """Byte-rows of the stacked buffer for a leaf of ``nbytes`` packed bytes:
    ⌈nbytes / LANES⌉ rounded up to a multiple of ``block_rows``."""
    rows = -(-max(nbytes, 1) // LANES)
    return -(-rows // block_rows) * block_rows


def _check(stacked: torch.Tensor, coeffs: torch.Tensor) -> None:
    if stacked.dtype != torch.uint8 or stacked.dim() != 3 or stacked.shape[2] != LANES:
        raise ValueError(f"stacked must be (C, R, {LANES}) uint8, got "
                         f"{tuple(stacked.shape)} {stacked.dtype}")
    if coeffs.shape != (stacked.shape[0],):
        raise ValueError(f"coeffs must be ({stacked.shape[0]},), got {tuple(coeffs.shape)}")


def packed_weighted_sum_plain(stacked: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the same per-element client order as the
    kernel, one client's codes unpacked at a time."""
    _check(stacked, coeffs)
    c = stacked.shape[0]
    flat = stacked.reshape(c, -1)
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=stacked.device)
    w = coeffs.to(torch.float32)
    acc = torch.zeros(flat.shape[1] * 4, dtype=torch.float32, device=stacked.device)
    for i in range(c):
        u = ((flat[i].reshape(-1, 1) >> shifts) & 3).to(torch.float32) - 1.0
        acc = acc + w[i] * u.reshape(-1)
    return acc


def _lib():
    from repro_torch.kernels import _build

    fn = _build.load("aggregate").aggregate_f32
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_longlong, p, ctypes.c_int, p, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def packed_weighted_sum(stacked: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Σ_c coeffs[c] · unpack(stacked[c]) as flat fp32 of length
    ``4·R·LANES``; see ``packed_weighted_sum_plain``."""
    if stacked.device.type == "cpu":
        return packed_weighted_sum_plain(stacked, coeffs)
    if stacked.device.type != "cuda":
        raise ValueError(f"packed_weighted_sum: unsupported device {stacked.device}")
    _check(stacked, coeffs)
    if not stacked.is_contiguous():
        raise ValueError("packed_weighted_sum: stacked must be contiguous")
    if coeffs.device != stacked.device or coeffs.dtype != torch.float32:
        raise ValueError("packed_weighted_sum: coeffs must be float32 on stacked's device")
    c = stacked.shape[0]
    if not 1 <= c <= _MAX_CLIENTS:
        raise ValueError(f"packed_weighted_sum: 1 ≤ C ≤ {_MAX_CLIENTS}, got {c}")
    coeffs = coeffs.contiguous()
    n_quads = stacked.shape[1] * LANES // 4
    out = torch.empty(16 * n_quads, dtype=torch.float32, device=stacked.device)
    blocks = max(1, min(-(-n_quads // _THREADS), _MAX_BLOCKS))
    fn = _lib()
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream(stacked.device).cuda_stream
        err = fn(stacked.data_ptr(), n_quads, coeffs.data_ptr(), c, out.data_ptr(),
                 blocks, stream)
    if err != 0:
        raise RuntimeError(f"aggregate kernel launch failed: CUDA error {err}")
    packed_weighted_sum.launches += 1
    return out


packed_weighted_sum.launches = 0
