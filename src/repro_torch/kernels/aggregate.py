"""Packed fan-in aggregation for the T-FedAvg server: ``csrc/aggregate.cu``.

Replaces the TPU kernel ``repro/kernels/aggregate.py::_fanin_kernel``
(``packed_weighted_sum``). The server's aggregation step is
Σ_c coeff_c · dequant(codes_c) over C client updates; the kernel consumes
the WIRE bytes directly (flat-packed 2-bit codes, 4 codes per byte,
``core.ternary.pack2bit`` order) and returns the fp32 weighted sum in
logical element order. No per-client dense tree is ever built.

``packed_weighted_sum_segments(staged, coeffs, table)`` folds every scale
segment of a flush in ONE launch: ``staged`` is a ``(C, row_bytes)`` uint8
buffer holding each client's bytes of every segment at the segment's byte
offset, ``coeffs`` a ``(C, S)`` fp32 matrix (weight · scale of client c in
segment s) and ``table`` a ``FanInTable`` (``fanin_table``), built once per
leaf plan and kept on the device. The output is one flat fp32 buffer with
every segment at its element offset, segments back to back in table order;
a segment's slot is its element count rounded up to 4, and the slot's tail
past the element count is 0.

Bound on the H100: bytes — C bytes read and 16 bytes written per 4
elements. What the TPU kernel's design cost here, and what this one does:

1. One launch per (leaf, segment) group, ~6.5 µs of latency each for a
   round whose fold needs ~1 µs of bytes → one launch per flush, each
   block finding its segment in the table by binary search.
2. Staging padded to Pallas tiles (32 rows of 128 bytes) and clients to a
   power of two → segments at 4-byte aligned offsets of one row, exactly
   the flush's clients; ragged tails are masked in the kernel.
3. A runtime client loop with one dependent load per iteration and float4
   stores 64 bytes apart within a warp → the client loop unrolled 4 deep,
   stores through a swizzled shared-memory transpose so consecutive lanes
   write consecutive 16-byte chunks.

(The fourth point, the majority finalize per segment, is
``fed.aggregator``'s.)

Summation order: every element sums clients c = 0..C−1 in order from +0.0,
as the Pallas kernel's ``fori_loop`` does. Each term coeff·(code−1) is
exact, and a subnormal coefficient or partial sum is a zero, as XLA
computes the Pallas kernel's adds (``dtypes.flush_subnormal``), so the
kernel, the plain version and the Pallas kernel agree bit for bit; only
the numpy oracle ``packed_weighted_sum_ref`` (a ``tensordot``)
sums in another order.

``packed_weighted_sum(stacked (C, R, LANES), coeffs (C,))``, the reference's
entry point, is the one-row-table case. Both wrappers dispatch on the
tensor's device: the plain PyTorch version for a CPU tensor, the CUDA
kernel for a CUDA tensor (or they raise). ``packed_weighted_sum.launches``
counts launches of the one kernel by either wrapper.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.dtypes import flush_subnormal, flush_subnormal_

LANES = 128
ALIGN = 4             # staged segment offsets: the kernel loads 32-bit words
_THREADS = 256
_BLOCK_BYTES = 4 * _THREADS   # staged bytes of one segment per block
_MAX_CLIENTS = 8192   # coefficients in the 32 KB of shared memory beside the transpose


@dataclasses.dataclass(frozen=True)
class FanInTable:
    """Where each segment of a fan-in lies: its bytes at ``byte_offsets[s]``
    of a staged row of ``row_bytes``, its ``n_out[s]`` outputs from
    ``out_offsets[s]`` of ``n_total``; ``rows`` is the kernel's (S, 5) int64
    table (byte offset, bytes, output offset, outputs, first block) on the
    fan-in's device."""

    nbytes: tuple
    n_out: tuple
    byte_offsets: tuple
    out_offsets: tuple
    row_bytes: int
    n_total: int
    n_blocks: int
    rows: torch.Tensor

    @property
    def n_segments(self) -> int:
        return len(self.nbytes)


def _up(n: int, k: int) -> int:
    return -(-n // k) * k


def fanin_table(nbytes: Sequence[int], n_out: Sequence[int],
                device: str | torch.device = "cpu") -> FanInTable:
    """The segment table of segments of ``nbytes`` packed bytes and
    ``n_out`` elements each (n_out ≤ 4·nbytes), back to back: bytes at
    ALIGN-byte offsets, outputs in slots of n_out rounded up to 4. Built on
    the host and copied to ``device`` once."""
    if len(nbytes) != len(n_out) or not nbytes:
        raise ValueError("fanin_table: one n_out per segment, at least one segment")
    rows = np.zeros((len(nbytes), 5), np.int64)
    b = o = k = 0
    for s, (nb, n) in enumerate(zip(nbytes, n_out)):
        if nb < 1 or not 0 < n <= 4 * nb:
            raise ValueError(f"fanin_table: segment {s} has {nb} bytes for {n} elements")
        rows[s] = (b, nb, o, n, k)
        b += _up(nb, ALIGN)
        o += _up(n, 4)
        k += -(-nb // _BLOCK_BYTES)
    return FanInTable(tuple(int(x) for x in nbytes), tuple(int(x) for x in n_out),
                      tuple(int(x) for x in rows[:, 0]), tuple(int(x) for x in rows[:, 2]),
                      b, o, k, torch.from_numpy(rows).to(device))


def _element_map(table: FanInTable, device) -> tuple[torch.Tensor, ...]:
    """Per output slot: its segment, staged byte, code shift and whether it
    holds an element (not a slot's tail)."""
    rows = table.rows.to(device)
    slots = torch.tensor([_up(n, 4) for n in table.n_out], device=device)
    seg = torch.repeat_interleave(torch.arange(table.n_segments, device=device), slots)
    local = torch.arange(table.n_total, device=device) - rows[seg, 2]
    byte = rows[seg, 0] + local // 4
    shift = (2 * (local % 4)).to(torch.uint8)
    return seg, byte, shift, local < rows[seg, 3]


def _check_segments(staged: torch.Tensor, table: FanInTable) -> None:
    if staged.dtype != torch.uint8 or staged.dim() != 2 or staged.shape[1] != table.row_bytes:
        raise ValueError(f"staged must be (C, {table.row_bytes}) uint8, got "
                         f"{tuple(staged.shape)} {staged.dtype}")


def packed_weighted_sum_segments_plain(staged: torch.Tensor, coeffs: torch.Tensor,
                                       table: FanInTable) -> torch.Tensor:
    """Plain PyTorch version: client by client over the whole flat output,
    each slot's coefficient gathered by its segment, as the kernel orders
    the sum; slot tails 0."""
    _check_segments(staged, table)
    c = staged.shape[0]
    if coeffs.shape != (c, table.n_segments):
        raise ValueError(f"coeffs must be ({c}, {table.n_segments}), got {tuple(coeffs.shape)}")
    seg, byte, shift, valid = _element_map(table, staged.device)
    w = flush_subnormal(coeffs.to(torch.float32))
    acc = torch.zeros(table.n_total, dtype=torch.float32, device=staged.device)
    for i in range(c):
        u = ((staged[i, byte] >> shift) & 3).to(torch.float32) - 1.0
        acc = flush_subnormal_(acc.add_(w[i, seg] * u))
    return torch.where(valid, acc, 0.0)


def _lib():
    from repro_torch.kernels import _build

    fn = _build.load("aggregate").aggregate_segments_f32
    if fn.argtypes is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, ctypes.c_int, ll, p, ll, p, ctypes.c_int, p, p]
        fn.restype = ctypes.c_int
    return fn


def check_launch(name: str, staged: torch.Tensor, coeffs: torch.Tensor, table: FanInTable,
                 coeff_shape: tuple) -> None:
    """What a segment kernel takes: contiguous staging and fp32 coefficients
    of ``coeff_shape``, the table on their device, 1 ≤ C ≤ _MAX_CLIENTS."""
    _check_segments(staged, table)
    if not staged.is_contiguous():
        raise ValueError(f"{name}: staged must be contiguous")
    if (coeffs.shape != coeff_shape or coeffs.device != staged.device
            or coeffs.dtype != torch.float32 or not coeffs.is_contiguous()):
        raise ValueError(f"{name}: coefficients must be contiguous float32 {coeff_shape} "
                         "on staged's device")
    if table.rows.device != staged.device:
        raise ValueError(f"{name}: the table must lie on staged's device")
    if not 1 <= staged.shape[0] <= _MAX_CLIENTS:
        raise ValueError(f"{name}: 1 ≤ C ≤ {_MAX_CLIENTS}, got {staged.shape[0]}")


def packed_weighted_sum_segments(staged: torch.Tensor, coeffs: torch.Tensor,
                                 table: FanInTable) -> torch.Tensor:
    """Σ_c coeffs[c, s] · unpack(segment s of staged[c]) for every segment
    in one launch: flat fp32 of ``table.n_total``; see
    ``packed_weighted_sum_segments_plain``."""
    if staged.device.type == "cpu":
        return packed_weighted_sum_segments_plain(staged, coeffs, table)
    if staged.device.type != "cuda":
        raise ValueError(f"packed_weighted_sum: unsupported device {staged.device}")
    check_launch("packed_weighted_sum", staged, coeffs, table,
                 (staged.shape[0], table.n_segments))
    out = torch.empty(table.n_total, dtype=torch.float32, device=staged.device)
    fn = _lib()
    with torch.cuda.device(staged.device):
        stream = torch.cuda.current_stream(staged.device).cuda_stream
        err = fn(table.rows.data_ptr(), table.n_segments, table.n_blocks, staged.data_ptr(),
                 table.row_bytes, coeffs.data_ptr(), staged.shape[0], out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"aggregate kernel launch failed: CUDA error {err}")
    packed_weighted_sum.launches += 1
    return out


def _check(stacked: torch.Tensor, coeffs: torch.Tensor) -> None:
    if stacked.dtype != torch.uint8 or stacked.dim() != 3 or stacked.shape[2] != LANES:
        raise ValueError(f"stacked must be (C, R, {LANES}) uint8, got "
                         f"{tuple(stacked.shape)} {stacked.dtype}")
    if coeffs.shape != (stacked.shape[0],):
        raise ValueError(f"coeffs must be ({stacked.shape[0]},), got {tuple(coeffs.shape)}")


def stack_table(stacked: torch.Tensor) -> FanInTable:
    """The one-row table of a (C, R, LANES) stack: R·LANES bytes, every
    code an output."""
    nbytes = stacked.shape[1] * LANES
    return fanin_table([nbytes], [4 * nbytes], stacked.device)


def packed_weighted_sum_plain(stacked: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``packed_weighted_sum``: the segment form's
    over the stack's one-row table."""
    _check(stacked, coeffs)
    return packed_weighted_sum_segments_plain(stacked.reshape(stacked.shape[0], -1),
                                              coeffs.reshape(-1, 1), stack_table(stacked))


def packed_weighted_sum(stacked: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Σ_c coeffs[c] · unpack(stacked[c]) as flat fp32 of length
    ``4·R·LANES``: ``packed_weighted_sum_segments`` over a one-row table;
    see ``packed_weighted_sum_plain``."""
    if stacked.device.type == "cpu":
        return packed_weighted_sum_plain(stacked, coeffs)
    if stacked.device.type != "cuda":
        raise ValueError(f"packed_weighted_sum: unsupported device {stacked.device}")
    _check(stacked, coeffs)
    if not stacked.is_contiguous():
        raise ValueError("packed_weighted_sum: stacked must be contiguous")
    if coeffs.device != stacked.device or coeffs.dtype != torch.float32:
        raise ValueError("packed_weighted_sum: coeffs must be float32 on stacked's device")
    return packed_weighted_sum_segments(stacked.reshape(stacked.shape[0], -1),
                                        coeffs.reshape(-1, 1).contiguous(),
                                        stack_table(stacked))


packed_weighted_sum.launches = 0
