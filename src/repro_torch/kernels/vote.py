"""Coordinate-wise ternary majority vote over wire bytes: ``csrc/vote.cu``.

Replaces the TPU kernel ``repro/kernels/vote.py::_vote_kernel``
(``packed_vote_counts``), the Byzantine-robust aggregation rule
``"majority"``. From the same staging contract as ``kernels.aggregate`` — a
stacked ``(C, R, LANES)`` uint8 tensor of flat-packed 2-bit codes and a
``(C,)`` fp32 vector, here the raw client WEIGHTS (a vote is scale-free) —
it returns the weighted −1 mass (code 0) and +1 mass (code 2) per
coordinate as ``(2, 4·R·LANES)`` fp32 in logical element order. The zero
mass is ``total − minus − plus``; code 3, which no honest encoder emits,
counts toward neither mass and so falls in it. Masses are plain sums over
clients, so the server accumulates them across chunk flushes and decides
the plurality once with ``majority_from_counts``.

Padding: a zero byte is four code-0 slots (−1 votes). Padding clients are
cancelled by coefficient 0; the tails of real clients are zeroed by the
staging and land past ``n_elements``, which the caller slices off.

Bound on the H100: bytes — C bytes read and 32 bytes written per output
quad of 4 elements. The TPU kernel interleaved the bit-planes by rows and
transposed after the call (a TPU layout artifact); the CUDA kernel writes
both planes in logical order, one thread per 4 packed bytes of every client
with 16 minus and 16 plus accumulators.

Every element sums clients c = 0..C−1 in order from +0.0 and each term is
exact, so the kernel, the plain version and the Pallas kernel agree bit for
bit.

``packed_vote_counts`` dispatches on the tensor's device: the plain PyTorch
version for a CPU tensor, the CUDA kernel for a CUDA tensor (or it raises).
``packed_vote_counts.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.aggregate import _MAX_BLOCKS, _MAX_CLIENTS, _THREADS, LANES, _check


def packed_vote_counts_plain(stacked: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the same per-element client order as the
    kernel, one client's codes unpacked at a time."""
    _check(stacked, coeffs)
    c = stacked.shape[0]
    flat = stacked.reshape(c, -1)
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=stacked.device)
    w = coeffs.to(torch.float32)
    acc = torch.zeros(2, flat.shape[1] * 4, dtype=torch.float32, device=stacked.device)
    for i in range(c):
        codes = ((flat[i].reshape(-1, 1) >> shifts) & 3).reshape(-1)
        ind = torch.stack([codes == 0, codes == 2]).to(torch.float32)
        acc = acc + w[i] * ind
    return acc


def _lib():
    from repro_torch.kernels import _build

    fn = _build.load("vote").vote_counts_f32
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_longlong, p, ctypes.c_int, p, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def packed_vote_counts(stacked: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Weighted [−1 mass, +1 mass] of ``stacked``'s codes under ``coeffs``,
    ``(2, 4·R·LANES)`` fp32; see ``packed_vote_counts_plain``."""
    if stacked.device.type == "cpu":
        return packed_vote_counts_plain(stacked, coeffs)
    if stacked.device.type != "cuda":
        raise ValueError(f"packed_vote_counts: unsupported device {stacked.device}")
    _check(stacked, coeffs)
    if not stacked.is_contiguous():
        raise ValueError("packed_vote_counts: stacked must be contiguous")
    if coeffs.device != stacked.device or coeffs.dtype != torch.float32:
        raise ValueError("packed_vote_counts: coeffs must be float32 on stacked's device")
    c = stacked.shape[0]
    if not 1 <= c <= _MAX_CLIENTS:
        raise ValueError(f"packed_vote_counts: 1 ≤ C ≤ {_MAX_CLIENTS}, got {c}")
    coeffs = coeffs.contiguous()
    n_quads = stacked.shape[1] * LANES // 4
    out = torch.empty((2, 16 * n_quads), dtype=torch.float32, device=stacked.device)
    blocks = max(1, min(-(-n_quads // _THREADS), _MAX_BLOCKS))
    fn = _lib()
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream(stacked.device).cuda_stream
        err = fn(stacked.data_ptr(), n_quads, coeffs.data_ptr(), c, out.data_ptr(),
                 blocks, stream)
    if err != 0:
        raise RuntimeError(f"vote kernel launch failed: CUDA error {err}")
    packed_vote_counts.launches += 1
    return out


packed_vote_counts.launches = 0


def majority_from_counts(counts: torch.Tensor, total_coeff: float) -> torch.Tensor:
    """The strict plurality per coordinate from accumulated masses, on the
    counts' device: ``counts`` is ``(2, n)`` [minus, plus]; the zero mass
    is ``fp32(total_coeff) − minus − plus``. Ties (and an empty total) go
    to 0, the conservative "don't move". Returns int8 votes in {−1, 0, +1}."""
    minus = counts[0].to(torch.float32)
    plus = counts[1].to(torch.float32)
    zero = float(np.float32(total_coeff)) - minus - plus
    votes = torch.zeros(minus.shape, dtype=torch.int8, device=counts.device)
    votes[(plus > minus) & (plus > zero)] = 1
    votes[(minus > plus) & (minus > zero)] = -1
    return votes
