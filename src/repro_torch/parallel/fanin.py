"""Fan-in over the client axis: ``fanin_weighted_sum`` and
``fanin_vote_counts``.

Port of the single-device path of ``repro.parallel.fanin``: one launch of
``kernels.aggregate.packed_weighted_sum`` (or ``kernels.vote.
packed_vote_counts``) over a ``(C, R, LANES)`` stack of packed client
updates. The reference shards the client axis over a device mesh and
``psum``s the dense partials; that path waits for the multi-GPU slice
(``torch.distributed`` all-reduce of the partials), and passing a mesh
raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.aggregate import packed_weighted_sum
from repro_torch.kernels.vote import packed_vote_counts


def _single_device(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("the client-sharded fan-in is not ported yet")


def fanin_weighted_sum(stacked: torch.Tensor, coeffs: torch.Tensor, *,
                       mesh=None) -> torch.Tensor:
    """Σ_c coeffs[c] · unpack(stacked[c]) on ``stacked``'s device: flat
    fp32 of length 4·R·LANES."""
    _single_device(mesh)
    return packed_weighted_sum(stacked, coeffs.to(device=stacked.device, dtype=torch.float32))


def fanin_vote_counts(stacked: torch.Tensor, coeffs: torch.Tensor, *,
                      mesh=None) -> torch.Tensor:
    """Weighted [−1 mass, +1 mass] per coordinate on ``stacked``'s device:
    (2, 4·R·LANES) fp32, with the staging contract of ``fanin_weighted_sum``."""
    _single_device(mesh)
    return packed_vote_counts(stacked, coeffs.to(device=stacked.device, dtype=torch.float32))
