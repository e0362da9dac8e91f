"""Fan-in over the client axis: ``fanin_weighted_sum``, ``fanin_vote_counts``
and their segment-table forms (port of ``repro.parallel.fanin``).

The segment forms fold every scale segment of a flush in one launch of
``kernels.aggregate.packed_weighted_sum_segments`` (or
``kernels.vote.packed_vote_counts_segments``) over a ``(C, row_bytes)``
staging buffer; the stacked forms take the reference's ``(C, R, LANES)``
stack of one segment.

With a ``mesh`` the client axis C is sharded over the mesh's ``"data"``
axis (or its first axis where it has none), as the reference's
``shard_map`` shards it: every rank is handed the whole flush, folds its
own C / n consecutive clients in one launch of the same kernel, and one fp32
all-reduce over the axis's subgroup merges the dense partials, so packed
bytes never cross ranks and every rank returns the whole fold. The
reference's degrade rule holds: no mesh, an axis of size 1, or a C that the
axis does not divide folds all C on each rank in one launch. The partials
are summed shard by shard, so a sharded fold equals the one-launch fold
within fp32 summation order.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.aggregate import (
    FanInTable, packed_weighted_sum, packed_weighted_sum_segments,
)
from repro_torch.kernels.vote import packed_vote_counts, packed_vote_counts_segments
from repro_torch.parallel.collectives import all_reduce_


def _f32(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(device=like.device, dtype=torch.float32)


def fanin_axis(mesh) -> str:
    """The mesh axis the client dimension shards over: "data" when present
    (clients are the data-parallel resource), else the first axis."""
    return "data" if "data" in mesh.axis_names else mesh.axis_names[0]


def _shard(mesh, c: int):
    """(rows of this rank, the axis's subgroup), or None where the fold is
    not sharded (no mesh, an axis of size 1, or C not divisible)."""
    if mesh is None:
        return None
    axis = fanin_axis(mesh)
    n = mesh.size(axis)
    if n == 1 or c % n:
        return None
    per = c // n
    i = mesh.index(axis)
    return slice(i * per, (i + 1) * per), mesh.group(axis)


def _fold(fn, staged: torch.Tensor, coeffs: torch.Tensor, mesh, *args) -> torch.Tensor:
    shard = _shard(mesh, staged.shape[0])
    if shard is None:
        return fn(staged, coeffs, *args)
    rows, group = shard
    part = fn(staged[rows], coeffs[rows].contiguous(), *args)
    return all_reduce_(part, group)


def fanin_weighted_sum(stacked: torch.Tensor, coeffs: torch.Tensor, *,
                       mesh=None) -> torch.Tensor:
    """Σ_c coeffs[c] · unpack(stacked[c]) on ``stacked``'s device: flat
    fp32 of length 4·R·LANES, the same on every rank of ``mesh``."""
    return _fold(packed_weighted_sum, stacked, _f32(coeffs, stacked), mesh)


def fanin_vote_counts(stacked: torch.Tensor, coeffs: torch.Tensor, *,
                      mesh=None) -> torch.Tensor:
    """Weighted [−1 mass, +1 mass] per coordinate on ``stacked``'s device:
    (2, 4·R·LANES) fp32, with the staging contract of ``fanin_weighted_sum``
    (vote masses are weighted sums over clients, so the shards merge by the
    same all-reduce)."""
    return _fold(packed_vote_counts, stacked, _f32(coeffs, stacked), mesh)


def fanin_weighted_sum_segments(staged: torch.Tensor, coeffs: torch.Tensor,
                                table: FanInTable, *, mesh=None) -> torch.Tensor:
    """Σ_c coeffs[c, s] · unpack(segment s of staged[c]) for every segment
    of ``table`` on ``staged``'s device: flat fp32 of ``table.n_total``."""
    return _fold(packed_weighted_sum_segments, staged, _f32(coeffs, staged).contiguous(),
                 mesh, table)


def fanin_vote_counts_segments(staged: torch.Tensor, weights: torch.Tensor,
                               table: FanInTable, *, mesh=None) -> torch.Tensor:
    """Weighted [−1 mass, +1 mass] of every segment of ``table`` on
    ``staged``'s device: (2, table.n_total) fp32."""
    return _fold(packed_vote_counts_segments, staged, _f32(weights, staged).contiguous(),
                 mesh, table)
