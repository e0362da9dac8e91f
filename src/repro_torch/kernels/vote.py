"""Coordinate-wise ternary majority vote over wire bytes: ``csrc/vote.cu``.

Replaces the TPU kernel ``repro/kernels/vote.py::_vote_kernel``
(``packed_vote_counts``), the Byzantine-robust aggregation rule
``"majority"``. From the staging contract of ``kernels.aggregate`` — a
``(C, row_bytes)`` uint8 buffer of every segment's flat-packed 2-bit codes
at its byte offset, a ``FanInTable`` — and a ``(C,)`` fp32 vector, here the
raw client WEIGHTS (a vote is scale-free),
``packed_vote_counts_segments`` returns the weighted −1 mass (code 0) and
+1 mass (code 2) per coordinate as ``(2, n_total)`` fp32, every segment at
its element offset, in ONE launch per flush. The zero mass is
``total − minus − plus``; code 3, which no honest encoder emits, counts
toward neither mass and so falls in it. Masses are plain sums over
clients, so the server accumulates them across chunk flushes and decides
the plurality once, over the whole flat buffer, with
``majority_from_counts``.

Bound on the H100: bytes — C bytes read and 32 bytes written per 4
elements. The design is ``kernels.aggregate``'s (one launch over a table
that stays on the device, exact staging, ragged tails masked in the kernel,
coalesced stores through shared memory), for both planes. Two planes make
it bound by instruction issue as much as by bytes, so each mass costs two
instructions per client: a bit test and, with finite weights, a predicated
add of w (a zero indicator adds nothing, as w · 0 = ±0 leaves the sum
unchanged); a non-finite weight keeps the multiply-add. The client loop is
unrolled 16 deep at three blocks per SM. The old kernel stored each plane
as four float4 64 bytes apart within a warp and multiplied every
indicator, which held it to 47% of its bound.

Every element sums clients c = 0..C−1 in order from +0.0 and each term is
exact, so the kernel, the plain version and the Pallas kernel agree bit for
bit. ``packed_vote_counts(stacked (C, R, LANES), coeffs (C,))``, the
reference's entry point, is the one-row-table case.

Both wrappers dispatch on the tensor's device: the plain PyTorch version
for a CPU tensor, the CUDA kernel for a CUDA tensor (or they raise).
``packed_vote_counts.launches`` counts launches of the one kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.aggregate import (
    FanInTable, _check, _check_segments, _element_map, check_launch, stack_table,
)


def packed_vote_counts_segments_plain(staged: torch.Tensor, weights: torch.Tensor,
                                      table: FanInTable) -> torch.Tensor:
    """Plain PyTorch version: client by client over the whole flat output,
    as the kernel orders the sum; slot tails 0 in both planes."""
    _check_segments(staged, table)
    c = staged.shape[0]
    if weights.shape != (c,):
        raise ValueError(f"weights must be ({c},), got {tuple(weights.shape)}")
    _, byte, shift, valid = _element_map(table, staged.device)
    w = weights.to(torch.float32)
    acc = torch.zeros(2, table.n_total, dtype=torch.float32, device=staged.device)
    for i in range(c):
        codes = (staged[i, byte] >> shift) & 3
        acc = acc + w[i] * torch.stack([codes == 0, codes == 2]).to(torch.float32)
    return torch.where(valid, acc, 0.0)


def _lib():
    from repro_torch.kernels import _build

    fn = _build.load("vote").vote_segments_f32
    if fn.argtypes is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, ctypes.c_int, ll, p, ll, p, ctypes.c_int, p, ll, p]
        fn.restype = ctypes.c_int
    return fn


def packed_vote_counts_segments(staged: torch.Tensor, weights: torch.Tensor,
                                table: FanInTable) -> torch.Tensor:
    """Weighted [−1 mass, +1 mass] of every segment's codes in one launch,
    ``(2, table.n_total)`` fp32; see ``packed_vote_counts_segments_plain``."""
    if staged.device.type == "cpu":
        return packed_vote_counts_segments_plain(staged, weights, table)
    if staged.device.type != "cuda":
        raise ValueError(f"packed_vote_counts: unsupported device {staged.device}")
    check_launch("packed_vote_counts", staged, weights, table, (staged.shape[0],))
    out = torch.empty((2, table.n_total), dtype=torch.float32, device=staged.device)
    fn = _lib()
    with torch.cuda.device(staged.device):
        stream = torch.cuda.current_stream(staged.device).cuda_stream
        err = fn(table.rows.data_ptr(), table.n_segments, table.n_blocks, staged.data_ptr(),
                 table.row_bytes, weights.data_ptr(), staged.shape[0], out.data_ptr(),
                 table.n_total, stream)
    if err != 0:
        raise RuntimeError(f"vote kernel launch failed: CUDA error {err}")
    packed_vote_counts.launches += 1
    return out


def packed_vote_counts_plain(stacked: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``packed_vote_counts``: the segment form's
    over the stack's one-row table."""
    _check(stacked, coeffs)
    return packed_vote_counts_segments_plain(stacked.reshape(stacked.shape[0], -1), coeffs,
                                             stack_table(stacked))


def packed_vote_counts(stacked: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Weighted [−1 mass, +1 mass] of ``stacked``'s codes under ``coeffs``,
    ``(2, 4·R·LANES)`` fp32: ``packed_vote_counts_segments`` over a one-row
    table; see ``packed_vote_counts_plain``."""
    if stacked.device.type == "cpu":
        return packed_vote_counts_plain(stacked, coeffs)
    if stacked.device.type != "cuda":
        raise ValueError(f"packed_vote_counts: unsupported device {stacked.device}")
    _check(stacked, coeffs)
    if not stacked.is_contiguous():
        raise ValueError("packed_vote_counts: stacked must be contiguous")
    if coeffs.device != stacked.device or coeffs.dtype != torch.float32:
        raise ValueError("packed_vote_counts: coeffs must be float32 on stacked's device")
    return packed_vote_counts_segments(stacked.reshape(stacked.shape[0], -1),
                                       coeffs.contiguous(), stack_table(stacked))


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
