"""Device meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

A ``Mesh`` is a grid of ranks with named axes, ``("pod", "data", "model")``
as in the reference, and one process subgroup per axis: the ranks that
differ from this one along that axis only. The collectives of
``parallel.collectives`` run over those subgroups. Ranks lie in the grid in
row-major order, so along every axis a subgroup's rank order is the axis
index. An axis of size 1 has no subgroup (its collectives are the
identity), so a mesh whose axes are all of size 1 needs no process group at
all: one process is such a mesh.

The backend is the caller's: ``nccl`` across GPUs, ``gloo`` across CPU
processes and for several ranks sharing one GPU (``parallel.collectives``
stages a CUDA tensor through pinned host memory for a ``gloo`` group).
``device_mesh`` gives the same grid as a ``torch.distributed.DeviceMesh``
for DTensor placements (``parallel.sharding.param_shardings``,
``train.fault.elastic_reshard``).

``make_production_mesh`` describes the reference's TPU v5e production mesh
(16 × 16 per pod, two pods); it is a shape and axis names only, since 512
ranks cannot be started here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh's shape and axis names, without processes."""

    shape: tuple
    axis_names: tuple

    def size(self, axis: str) -> int:
        return dict(zip(self.axis_names, self.shape)).get(axis, 1)

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape)


class Mesh(MeshSpec):
    """This process's place in a grid of ranks, with a process subgroup per
    axis of size > 1. Build it with ``make_mesh``."""

    def __init__(self, shape: tuple, axis_names: tuple, ranks: tuple, rank: int,
                 groups: dict, device: torch.device):
        super().__init__(tuple(shape), tuple(axis_names))
        object.__setattr__(self, "ranks", ranks)
        object.__setattr__(self, "rank", rank)
        object.__setattr__(self, "groups", groups)
        object.__setattr__(self, "device", device)
        object.__setattr__(self, "_device_mesh", None)

    @property
    def member(self) -> bool:
        return self.rank in self.ranks

    @property
    def coords(self) -> dict:
        """This rank's index along every axis."""
        flat = self.ranks.index(self.rank)
        out = {}
        for axis, n in zip(reversed(self.axis_names), reversed(self.shape)):
            out[axis] = flat % n
            flat //= n
        return {a: out[a] for a in self.axis_names}

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """The subgroup along ``axis``, or None for an axis of size 1 (or
        one the mesh does not have)."""
        return self.groups.get(axis)

    def linear_index(self, axes: Sequence[str]) -> int:
        """This rank's row-major index over ``axes`` (e.g. the batch axes)."""
        i = 0
        for a in axes:
            i = i * self.size(a) + self.index(a)
        return i

    @property
    def device_mesh(self):
        """The grid as a ``DeviceMesh`` (built at first use; every process of
        the default group must ask for it together, as for ``make_mesh``)."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh

            grid = torch.tensor(self.ranks, dtype=torch.int64).reshape(self.shape)
            object.__setattr__(self, "_device_mesh", DeviceMesh(
                self.device.type, grid, mesh_dim_names=self.axis_names))
        return self._device_mesh

    def __repr__(self) -> str:
        return f"Mesh({describe(self)}, rank={self.rank})"


def make_mesh(shape: tuple, axes: tuple, *, ranks: Sequence[int] | None = None,
              device: str | torch.device | None = None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes`` over ``ranks`` (default:
    every rank of the default process group, or the one process where
    ``torch.distributed`` is not initialized). Where a subgroup is needed,
    every process of the default group calls this, in the same order, as
    ``torch.distributed.new_group`` requires; a process outside ``ranks``
    gets a mesh it is not a member of. ``device`` defaults to
    ``cuda:{rank % device_count}`` and raises where no card is present;
    pass ``device="cpu"`` for CPU ranks."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"make_mesh: shape {shape} and axes {axes} do not match")
    initialized = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if initialized else 0
    if ranks is None:
        ranks = range(dist.get_world_size() if initialized else 1)
    ranks = tuple(int(r) for r in ranks)
    if math.prod(shape) != len(ranks):
        raise ValueError(f"make_mesh: {len(ranks)} ranks do not fill a {shape} mesh")
    grid = torch.tensor(ranks).reshape(shape)
    groups = {}
    for d, axis in enumerate(axes):
        if shape[d] == 1:
            continue
        if not initialized:
            raise RuntimeError("make_mesh: an axis of size > 1 needs torch.distributed "
                               "initialized (init_process_group)")
        lines = grid.movedim(d, -1).reshape(-1, shape[d])
        for line in lines.tolist():
            g = dist.new_group(line)
            if rank in line:
                groups[axis] = g
    if device is None:
        device = (f"cuda:{rank % torch.cuda.device_count()}" if torch.cuda.is_available()
                  else "cuda")
    return Mesh(shape, axes, ranks, rank, groups, resolve_device(device))


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The reference's TPU v5e production mesh as a description: 16 × 16 =
    256 chips per pod, two pods = 512; axes ("data", "model") for one pod,
    ("pod", "data", "model") for two."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = AXES if multi_pod else AXES[1:]
    return MeshSpec(shape, axes)


def describe(mesh: MeshSpec) -> dict:
    return {"axes": dict(zip(mesh.axis_names, mesh.shape)), "n_devices": int(mesh.n_devices)}

