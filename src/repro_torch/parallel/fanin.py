"""Fan-in over the client axis: ``fanin_weighted_sum``, ``fanin_vote_counts``
and their segment-table forms.

Port of the single-device path of ``repro.parallel.fanin``. The segment
forms fold every scale segment of a flush in one launch of
``kernels.aggregate.packed_weighted_sum_segments`` (or
``kernels.vote.packed_vote_counts_segments``) over a ``(C, row_bytes)``
staging buffer; the stacked forms take the reference's ``(C, R, LANES)``
stack of one segment. The reference shards the client axis over a device
mesh and ``psum``s the dense partials; that path waits for the multi-GPU
slice (``torch.distributed`` all-reduce of the partials), and passing a
mesh raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.aggregate import (
    FanInTable, packed_weighted_sum, packed_weighted_sum_segments,
)
from repro_torch.kernels.vote import packed_vote_counts, packed_vote_counts_segments


def _single_device(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("the client-sharded fan-in is not ported yet")


def _f32(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(device=like.device, dtype=torch.float32)


def fanin_weighted_sum(stacked: torch.Tensor, coeffs: torch.Tensor, *,
                       mesh=None) -> torch.Tensor:
    """Σ_c coeffs[c] · unpack(stacked[c]) on ``stacked``'s device: flat
    fp32 of length 4·R·LANES."""
    _single_device(mesh)
    return packed_weighted_sum(stacked, _f32(coeffs, stacked))


def fanin_vote_counts(stacked: torch.Tensor, coeffs: torch.Tensor, *,
                      mesh=None) -> torch.Tensor:
    """Weighted [−1 mass, +1 mass] per coordinate on ``stacked``'s device:
    (2, 4·R·LANES) fp32, with the staging contract of ``fanin_weighted_sum``."""
    _single_device(mesh)
    return packed_vote_counts(stacked, _f32(coeffs, stacked))


def fanin_weighted_sum_segments(staged: torch.Tensor, coeffs: torch.Tensor,
                                table: FanInTable, *, mesh=None) -> torch.Tensor:
    """Σ_c coeffs[c, s] · unpack(segment s of staged[c]) for every segment
    of ``table`` on ``staged``'s device: flat fp32 of ``table.n_total``."""
    _single_device(mesh)
    return packed_weighted_sum_segments(staged, _f32(coeffs, staged).contiguous(), table)


def fanin_vote_counts_segments(staged: torch.Tensor, weights: torch.Tensor,
                               table: FanInTable, *, mesh=None) -> torch.Tensor:
    """Weighted [−1 mass, +1 mass] of every segment of ``table`` on
    ``staged``'s device: (2, table.n_total) fp32."""
    _single_device(mesh)
    return packed_vote_counts_segments(staged, _f32(weights, staged).contiguous(), table)
