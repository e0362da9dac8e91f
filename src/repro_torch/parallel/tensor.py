"""Tensor parallelism over the mesh's "model" axis: the port's counterpart
of what GSPMD computes for the reference from ``parallel.sharding``'s rules
(TP over "model": attention QKV output columns, MLP hidden, vocab).

Each rank of the "model" subgroup holds its shard of every leaf whose spec
puts "model" on a dim (``shard_tree``: the rank's ``chunk`` of that dim);
the "data" entries of the specs stay whole (data-parallel ranks hold whole
copies, as the trainer's "data" axis is data parallelism). The layers
compute on the shards Megatron-LM's way, column-parallel then
row-parallel, with four conjugate autograd functions over
``parallel.collectives`` (so a CUDA tensor on a ``gloo`` group is staged
through pinned host memory, as every collective of the port is):

- ``copy_to_model``: forward identity, backward all-reduce (sum); where a
  replicated tensor enters computation that differs by rank;
- ``reduce_from_model``: forward all-reduce (sum), backward identity;
  where the ranks' partial results become one replicated tensor;
- ``gather_from_model``: forward all-gather along a dim, backward this
  rank's slice; where shards become a tensor every rank then uses alike;
- ``scatter_to_model``: forward this rank's slice, backward all-gather.

``vocab_parallel_ce`` is the cross entropy over logits split by vocab
columns: the row max all-reduced (MAX), Σ exp and the label's logit
all-reduced (SUM); its backward is the local softmax minus the one-hot on
the rank that holds the label, with no collective. No rank holds the whole
(B, S, V) logits.

A ``ModelAxis`` (``model_axis(mesh)``) is what the layers are handed: the
subgroup, its size and this rank's index; None for a mesh without a
"model" axis of size > 1, and then every layer computes as on one device.

``BatchAxes`` are the mesh axes whose ranks' rows together form one batch,
as GSPMD's automatic axes do: a layer whose result depends on the whole
batch (the MoE's capacity, queue slots and load loss) reads it across them.
``mean_over_batch`` is their mean with an identity backward: the trainer
averages every rank's gradient over the same axes, which gives the global
mean's gradient.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.parallel.collectives import all_gather, all_reduce_, group_rank, group_size
from repro_torch.tree import flatten_with_path, path_str, tree_map_with_path

Pytree = Any


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The "model" subgroup of a mesh, as the layers see it."""

    group: Any
    size: int
    rank: int

    def share(self, n: int) -> tuple[int, int]:
        """[lo, hi) of this rank's chunk of ``n`` (a multiple of ``size``)."""
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per


def model_group(mesh):
    """The mesh's "model" subgroup, or None (no such axis, or size 1)."""
    return None if mesh is None else mesh.group("model")


def model_axis(mesh) -> ModelAxis | None:
    """The mesh's "model" axis as the layers take it, or None where it has
    size 1. A mesh description without processes (``MeshSpec``) cannot
    compute and raises."""
    if mesh is None or mesh.size("model") <= 1:
        return None
    if not hasattr(mesh, "group"):
        raise TypeError("tensor parallelism needs a mesh of processes (launch.mesh.make_mesh), "
                        f"not {mesh!r}")
    return ModelAxis(model_group(mesh), mesh.size("model"), mesh.index("model"))


@dataclasses.dataclass(frozen=True)
class BatchAxes:
    """Process subgroups (outer axis first) whose ranks hold consecutive
    rows of one batch, in their linear order."""

    groups: tuple

    @property
    def size(self) -> int:
        return math.prod(group_size(g) for g in self.groups)

    @property
    def index(self) -> int:
        """This rank's place in the linear (outer-major) order."""
        i = 0
        for g in self.groups:
            i = i * group_size(g) + group_rank(g)
        return i

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's ``t`` in linear order."""
        out = t[None]
        for g in reversed(self.groups):
            out = all_gather(out, g).reshape((-1,) + tuple(t.shape))
        return out


def batch_axes(mesh, axes) -> BatchAxes | None:
    """The ``axes`` of ``mesh`` of size > 1 as ``BatchAxes``, or None."""
    groups = tuple(mesh.group(a) for a in axes if mesh.size(a) > 1)
    return BatchAxes(groups) if groups else None


class _MeanOverBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dp):
        x = x.contiguous().clone()
        for g in dp.groups:
            all_reduce_(x, g, mean=True)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def mean_over_batch(x: torch.Tensor, dp: BatchAxes) -> torch.Tensor:
    """The mean of ``x`` over ``dp``'s ranks; the gradient passes through
    unchanged (see the module docstring)."""
    return _MeanOverBatch.apply(x, dp)


# --------------------------------------------------------------------------
# The four conjugate functions.
# --------------------------------------------------------------------------


def _gather(x: torch.Tensor, tp: ModelAxis, dim: int) -> torch.Tensor:
    return torch.cat(list(all_gather(x.contiguous(), tp.group).unbind(0)), dim=dim)


def _slice(x: torch.Tensor, tp: ModelAxis, dim: int) -> torch.Tensor:
    return x.chunk(tp.size, dim)[tp.rank].contiguous()


def _own(x: torch.Tensor, tp: ModelAxis, dim: int) -> torch.Tensor:
    """A copy of this rank's chunk (no view keeps the whole tensor alive)."""
    return x.chunk(tp.size, dim)[tp.rank].clone(memory_format=torch.contiguous_format)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.tp.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return all_reduce_(x.contiguous().clone(), tp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _gather(x, tp, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.tp, ctx.dim), None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _slice(x, tp, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.tp, ctx.dim), None, None


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, tp):
        lo, _ = tp.share(logits.shape[-1] * tp.size)
        m = all_reduce_(logits.amax(dim=-1), tp.group, op="max")
        shifted = logits - m[..., None]
        e = torch.exp(shifted)
        own = (labels >= lo) & (labels < lo + logits.shape[-1])
        idx = torch.where(own, labels - lo, 0)[..., None]
        picked = torch.where(own, torch.gather(shifted, -1, idx)[..., 0], 0.0)
        sums = all_reduce_(torch.stack([e.sum(dim=-1), picked]), tp.group)
        ctx.save_for_backward(e.div_(sums[0][..., None]), idx, own)
        return torch.log(sums[0]) - sums[1]

    @staticmethod
    def backward(ctx, g):
        softmax, idx, own = ctx.saved_tensors
        grad = softmax * g[..., None]
        grad.scatter_add_(-1, idx, -torch.where(own, g, 0.0)[..., None])
        return grad, None, None


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor, tp: ModelAxis) -> torch.Tensor:
    """−log softmax(logits)[label] per position: ``logits`` (..., V / size)
    fp32, this rank's vocab columns; ``labels`` (...) int64 ids of the
    whole vocabulary."""
    return _VocabParallelCE.apply(logits, labels, tp)


def copy_to_model(x: torch.Tensor, tp: ModelAxis) -> torch.Tensor:
    return _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp: ModelAxis) -> torch.Tensor:
    return _ReduceFromModel.apply(x, tp)


def gather_from_model(x: torch.Tensor, tp: ModelAxis, dim: int = -1) -> torch.Tensor:
    return _GatherFromModel.apply(x, tp, dim)


def scatter_to_model(x: torch.Tensor, tp: ModelAxis, dim: int = -1) -> torch.Tensor:
    return _ScatterToModel.apply(x, tp, dim)


# --------------------------------------------------------------------------
# Trees: shard, gather, local shapes.
# --------------------------------------------------------------------------


def local_shape(path: str, shape: tuple, mesh) -> tuple:
    """The shape of this rank's shard of a leaf at ``path`` (the "model"
    entry of its spec divides that dim; the "data" entries stay whole)."""
    from repro_torch.parallel.sharding import mesh_sizes, model_dim, spec_for

    d = model_dim(spec_for(path, tuple(shape), mesh_sizes(mesh)))
    if d is None:
        return tuple(shape)
    return tuple(s // mesh.size("model") if i == d else s for i, s in enumerate(shape))


def _dims(specs: Pytree) -> dict:
    """{param path string: its "model" dim} for the sharded leaves."""
    from repro_torch.parallel.sharding import is_spec, model_dim

    out = {}
    for path, spec in flatten_with_path(specs, is_leaf=is_spec):
        d = model_dim(spec)
        if d is not None:
            out[path_str(path)] = d
    return out


def shard_tree(tree: Pytree, specs: Pytree, mesh) -> Pytree:
    """This rank's shards of a tree of whole leaves (a copy of each chunk,
    so the whole leaves can be freed)."""
    tp = model_axis(mesh)
    if tp is None:
        return tree
    dims = _dims(specs)

    def one(path, leaf):
        d = dims.get(path_str(path))
        return leaf if d is None else _own(leaf, tp, d)

    return tree_map_with_path(one, tree)


def gather_tree(tree: Pytree, specs: Pytree, mesh) -> Pytree:
    """Whole leaves from every rank's shards (every rank of the "model"
    subgroup calls this together)."""
    tp = model_axis(mesh)
    if tp is None:
        return tree
    dims = _dims(specs)

    def one(path, leaf):
        d = dims.get(path_str(path))
        return leaf if d is None else _gather(leaf, tp, d)

    return tree_map_with_path(one, tree)


# the subtrees of a train state laid out as the params, by the prefix of
# their ``train.checkpoint.flatten`` names, and how many dims they lead with
_PARAM_LIKE = {".params/": 0, ".opt_state/m/": 0, ".opt_state/v/": 0, ".residuals/": 1}


def state_dims(state: Pytree, specs: Pytree) -> list:
    """The "model" dim of every leaf of ``train.checkpoint.flatten(state)``
    (None where the leaf is whole): a params tree, or a ``TrainState``
    whose params, Adam moments and residuals (one leading pod dim) follow
    the params' specs; w_q, steps and counters are replicated."""
    from repro_torch.train.checkpoint import flatten

    dims = _dims(specs)
    out = []
    for name, _ in flatten(state):
        d = dims.get(name)
        for prefix, lead in _PARAM_LIKE.items():
            if name.startswith(prefix) and name[len(prefix):] in dims:
                d = dims[name[len(prefix):]] + lead
        out.append(d)
    return out


def gather_state(state: Pytree, specs: Pytree, mesh) -> Pytree:
    """``state`` (a params tree or a ``TrainState``) with every model shard
    gathered into its whole leaf; every rank of the subgroup calls it."""
    from repro_torch.train.checkpoint import flatten, unflatten

    tp = model_axis(mesh)
    if tp is None:
        return state
    leaves = [leaf if d is None else _gather(leaf, tp, d)
              for (_, leaf), d in zip(flatten(state), state_dims(state, specs))]
    return unflatten(state, leaves)


def shard_state(state: Pytree, specs: Pytree, mesh) -> Pytree:
    """``state`` of whole leaves cut to this rank's shards (as
    ``gather_state``'s inverse)."""
    from repro_torch.train.checkpoint import flatten, unflatten

    tp = model_axis(mesh)
    if tp is None:
        return state
    leaves = [leaf if d is None else _own(leaf, tp, d)
              for (_, leaf), d in zip(flatten(state), state_dims(state, specs))]
    return unflatten(state, leaves)
