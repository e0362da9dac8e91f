"""Sharded compute over the mesh's "model" and "data" axes: the port's
counterpart of what GSPMD computes for the reference from
``parallel.sharding``'s rules (TP over "model": attention QKV output
columns, MLP hidden, vocab; FSDP over "data": the other matrix axis of
every weight).

Each rank holds its chunk of every dim a leaf's spec names
(``shard_tree``): over the "model" subgroup where the spec says "model"
and over the "data" subgroup where it says "data"; a leaf may carry both
on different dims (``attn/wq`` (L, D, H·hd) is (None, "data", "model")),
and where the divisibility guard leaves a dim whole, that axis does not
cut it. The layers compute on the "model" shards Megatron-LM's way,
column-parallel then row-parallel, with four conjugate autograd functions
over ``parallel.collectives`` (so a CUDA tensor on a ``gloo`` group is
staged through pinned host memory, as every collective of the port is):

- ``copy_to_model``: forward identity, backward all-reduce (sum); where a
  replicated tensor enters computation that differs by rank;
- ``reduce_from_model``: forward all-reduce (sum), backward identity;
  where the ranks' partial results become one replicated tensor;
- ``gather_from_model``: forward all-gather along a dim, backward this
  rank's slice; where shards become a tensor every rank then uses alike;
- ``scatter_to_model``: forward this rank's slice, backward all-gather.

The "data" shards are FSDP's (ZeRO-3): params, Adam moments and residuals
are held cut, and a layer gathers its weights where it uses them.
``gather_from_data`` all-gathers a leaf over the "data" subgroup along its
data dim in the forward and reduce-scatters its gradient in the backward
(``parallel.collectives.reduce_scatter``: the sum over the data ranks,
which the trainer divides by their count); ``gather_layer`` applies it to
every data-sharded leaf of a layer's params, and ``models.transformer``
calls it inside each remat unit, so no rank holds every layer's whole
weights at once.

``Shards`` (``param_shards(cfg, mesh)``) tells code over whole trees
(FTTQ's statistics, the clip's global norm, the w_q step, the cross-pod
sync) which axes cut each leaf: a statistic of the whole leaf is its
shards' reduced over each of those axes (``reduce_over``, one all-reduce
per axis for all the leaves it cuts).

``vocab_parallel_ce`` is the cross entropy over logits split by vocab
columns: the row max all-reduced (MAX), Σ exp and the label's logit
all-reduced (SUM); its backward is the local softmax minus the one-hot on
the rank that holds the label, with no collective. No rank holds the whole
(B, S, V) logits.

A ``MeshAxis`` (``model_axis(mesh)``, ``data_axis(mesh)``) is what the
layers are handed: the subgroup, its size and this rank's index; None for
a mesh without that axis of size > 1, and then every layer computes as on
one device.

``BatchAxes`` are the mesh axes whose ranks' rows together form one batch,
as GSPMD's automatic axes do: a layer whose result depends on the whole
batch (the MoE's capacity, queue slots and load loss) reads it across them.
``mean_over_batch`` is their mean with an identity backward: the trainer
averages every rank's gradient over the same axes, which gives the global
mean's gradient.

Serving (``serve_layout``) follows ``parallel.sharding.batch_specs`` and
``cache_specs``: where the global batch divides over ("pod", "data") each
rank serves its block of rows (``gather_rows`` rebuilds the reference's
global tensor), else every rank serves the whole batch; the KV cache's
sequence dim is cut over "model" where the kv heads do not divide over
it, and over "data" where the rows are not cut. Attention over a
sequence-cut cache (``models.attention``) computes each rank's partial
blocked softmax over its own slots and ``combine_softmax`` merges them
exactly, as flash-decode does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.parallel.collectives import (
    all_gather, all_reduce_, group_rank, group_size, reduce_scatter,
)
from repro_torch.tree import flatten_with_path, path_str, tree_map_with_path

Pytree = Any


# the mesh axes that cut params, in the order their collectives run
SHARD_AXES = ("model", "data")


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One axis of a mesh ("model" or "data"), as the layers see it: its
    subgroup, size and this rank's index."""

    group: Any
    size: int
    rank: int
    name: str = "model"

    def share(self, n: int) -> tuple[int, int]:
        """[lo, hi) of this rank's chunk of ``n`` (a multiple of ``size``)."""
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per


def mesh_axis(mesh, name: str) -> MeshAxis | None:
    """The mesh's axis ``name`` as the layers take it, or None where it has
    size 1. A mesh description without processes (``MeshSpec``) cannot
    compute and raises."""
    if mesh is None or mesh.size(name) <= 1:
        return None
    if not hasattr(mesh, "group"):
        raise TypeError(f"sharding over {name!r} needs a mesh of processes "
                        f"(launch.mesh.make_mesh), not {mesh!r}")
    return MeshAxis(mesh.group(name), mesh.size(name), mesh.index(name), name)


def model_axis(mesh) -> MeshAxis | None:
    """The "model" axis (tensor parallelism), or None."""
    return mesh_axis(mesh, "model")


def data_axis(mesh) -> MeshAxis | None:
    """The "data" axis (FSDP over the params' "data" dims), or None."""
    return mesh_axis(mesh, "data")


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


# --------------------------------------------------------------------------
# Serving: rows over the batch axes, the KV cache's sequence over the mesh.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServeLayout:
    """How a serving step's batch and cache lie on the mesh. ``rows``: the
    ``BatchAxes`` the global batch's rows are cut over (None: every rank
    has the whole batch), this rank holding block ``rows.index`` of
    ``rows.size``; ``seq``: the ``MeshAxis`` list (outer first) that cut
    the KV cache's sequence dim (``linear_rank``); ``heads``: whether
    "model" cuts the cache's kv heads."""

    rows: BatchAxes | None = None
    seq: tuple = ()
    heads: bool = False

    @property
    def n_rows(self) -> int:
        return self.rows.size if self.rows is not None else 1

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of rows of a global (B, ...) tensor."""
        if self.rows is None:
            return x
        per = x.shape[0] // self.rows.size
        return x[self.rows.index * per:(self.rows.index + 1) * per]


def linear_rank(axes) -> tuple[int, int]:
    """(this rank's row-major index, the count of ranks) over a list of
    ``MeshAxis``, outer first: a sequence cut over them gives this rank the
    global slots [index·S/count, (index + 1)·S/count)."""
    index, count = 0, 1
    for a in axes:
        index, count = index * a.size + a.rank, count * a.size
    return index, count


def _serve_rows(mesh, batch: int | None) -> BatchAxes | None:
    """The batch axes ("pod", "data") a global batch of ``batch`` rows is
    cut over (None where it does not divide over them, or they have one
    rank): the rule of ``parallel.sharding.batch_specs``. ``batch`` None:
    cut wherever the axes have more than one rank."""
    from repro_torch.parallel.sharding import logical_batch_axes

    rows = batch_axes(mesh, logical_batch_axes(mesh)) if mesh is not None else None
    if rows is None or batch is None:
        return rows
    return rows if batch % rows.size == 0 and batch >= rows.size else None


def batch_ranks(mesh) -> int:
    """The ranks of the mesh's batch axes ("pod", "data"); 1 without a mesh."""
    rows = _serve_rows(mesh, None)
    return rows.size if rows is not None else 1


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def serve_layout(cfg, mesh, batch: int) -> ServeLayout:
    """The ``ServeLayout`` of a global batch of ``batch`` rows on ``mesh``:
    the rows cut over ("pod", "data") where ``batch`` divides over them (the
    rule of ``parallel.sharding.batch_specs``), and the KV cache's sequence
    and heads as ``cache_specs`` places them."""
    from repro_torch.parallel.sharding import cache_specs

    if mesh is None:
        return ServeLayout()
    rows = _serve_rows(mesh, batch)
    cut = rows is not None or batch_ranks(mesh) == 1
    specs = cache_specs(cfg, mesh, batch_sharded=cut)
    kv = specs.get("k", specs.get("attn_k"))
    if kv is None:
        return ServeLayout(rows=rows)
    seq = tuple(a for a in (mesh_axis(mesh, name) for name in _entry_axes(kv[2]))
                if a is not None)
    return ServeLayout(rows=rows, seq=seq, heads=kv[3] == "model" and mesh.size("model") > 1)


def gather_rows(x: torch.Tensor, mesh, batch: int | None = None) -> torch.Tensor:
    """The reference's global (B, ...) tensor from every rank's rows ``x``
    (a serving step's logits): all-gathered over the batch axes in their
    linear order where a global batch of ``batch`` rows is cut over them
    (without ``batch``: wherever they have more than one rank), else ``x``
    itself, whole on every rank already. Every rank of the batch axes
    calls it together."""
    rows = _serve_rows(mesh, batch)
    if rows is None:
        return x
    return rows.gather(x).reshape((-1,) + tuple(x.shape[1:]))


def combine_softmax(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                    axes) -> torch.Tensor:
    """Attention's output from every rank's partial blocked softmax over its
    own keys: ``m`` (...) the row max of its scores (``NEG_INF`` where it
    has no valid key), ``l`` (...) Σ exp(score − m), ``acc`` (..., hd)
    Σ exp(score − m)·v. Over each ``MeshAxis`` of ``axes`` in turn: M = max
    of m, l = Σ l·e^(m−M), acc = Σ acc·e^(m−M) (one MAX and one SUM
    all-reduce); returns acc / l. A rank with no valid key (l = 0) adds
    nothing; no autograd."""
    for ax in axes:
        big = all_reduce_(m.clone(), ax.group, op="max")
        w = torch.exp(m - big)
        parts = torch.cat([(l * w).reshape(-1), (acc * w[..., None]).reshape(-1)])
        all_reduce_(parts, ax.group)
        l, acc = parts[:l.numel()].view(l.shape), parts[l.numel():].view(acc.shape)
        m = big
    return acc / torch.clamp(l, min=1e-30)[..., None]


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


def _gather(x: torch.Tensor, tp: MeshAxis, dim: int) -> torch.Tensor:
    return torch.cat(list(all_gather(x.contiguous(), tp.group).unbind(0)), dim=dim)


def _slice(x: torch.Tensor, tp: MeshAxis, dim: int) -> torch.Tensor:
    return x.chunk(tp.size, dim)[tp.rank].contiguous()


def _own(x: torch.Tensor, tp: MeshAxis, dim: int) -> torch.Tensor:
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


class _GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.ax.group, ctx.dim), None, None


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


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor, tp: MeshAxis) -> torch.Tensor:
    """−log softmax(logits)[label] per position: ``logits`` (..., V / size)
    fp32, this rank's vocab columns; ``labels`` (...) int64 ids of the
    whole vocabulary."""
    return _VocabParallelCE.apply(logits, labels, tp)


def copy_to_model(x: torch.Tensor, tp: MeshAxis) -> torch.Tensor:
    return _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp: MeshAxis) -> torch.Tensor:
    return _ReduceFromModel.apply(x, tp)


def gather_from_model(x: torch.Tensor, tp: MeshAxis, dim: int = -1) -> torch.Tensor:
    return _GatherFromModel.apply(x, tp, dim)


def scatter_to_model(x: torch.Tensor, tp: MeshAxis, dim: int = -1) -> torch.Tensor:
    return _ScatterToModel.apply(x, tp, dim)


def gather_from_data(x: torch.Tensor, ax: MeshAxis, dim: int) -> torch.Tensor:
    """The whole of a leaf cut over ``ax`` along ``dim``: all-gathered in
    the forward, its gradient reduce-scattered (summed over the axis's
    ranks) in the backward."""
    return _GatherFromData.apply(x, ax, dim)


def gather_layer(tree: Pytree, ax: MeshAxis | None, dims: Pytree) -> Pytree:
    """``tree`` (a layer's params) with every leaf that ``dims`` (a tree of
    the same paths: the dim ``ax`` cuts, or None) marks made whole by
    ``gather_from_data``; ``tree`` itself where ``ax`` is None."""
    if ax is None:
        return tree
    at = {path_str(p): d for p, d in flatten_with_path(dims)}

    def one(path, leaf):
        d = at.get(path_str(path))
        return leaf if d is None else gather_from_data(leaf, ax, d)

    return tree_map_with_path(one, tree)


# --------------------------------------------------------------------------
# Trees: shard, gather, local shapes.
# --------------------------------------------------------------------------


def local_shape(path: str, shape: tuple, mesh) -> tuple:
    """The shape of this rank's shard of a leaf at ``path``: every dim its
    spec gives an axis of size > 1 ("model" or "data") divided by it."""
    from repro_torch.parallel.sharding import axis_dim, mesh_sizes, spec_for

    spec = spec_for(path, tuple(shape), mesh_sizes(mesh))
    out = list(shape)
    for name in SHARD_AXES:
        d = axis_dim(spec, name)
        if d is not None:
            out[d] //= mesh.size(name)
    return tuple(out)


def sharded(mesh) -> bool:
    """Whether ``mesh`` has an axis of size > 1 that cuts params."""
    return mesh is not None and any(mesh.size(a) > 1 for a in SHARD_AXES)


def _cuts(specs: Pytree, mesh) -> dict:
    """{param path string: ((MeshAxis, dim), ...)} for the leaves an axis
    of size > 1 cuts, "model" first."""
    from repro_torch.parallel.sharding import axis_dim, is_spec

    axes = [a for a in (mesh_axis(mesh, n) for n in SHARD_AXES) if a is not None]
    out = {}
    for path, spec in flatten_with_path(specs, is_leaf=is_spec):
        cut = tuple((a, axis_dim(spec, a.name)) for a in axes
                    if axis_dim(spec, a.name) is not None)
        if cut:
            out[path_str(path)] = cut
    return out


@dataclasses.dataclass(frozen=True)
class Shards:
    """Which axes cut each leaf of a params tree: ``cuts`` maps a leaf's
    path string to ((MeshAxis, dim), ...), "model" first; a leaf not in it
    is whole on every rank."""

    cuts: dict

    def axes(self, path: str) -> tuple:
        return tuple(a for a, _ in self.cuts.get(path, ()))

    def factor(self, path: str) -> int:
        """How many shards make the whole leaf."""
        return math.prod(a.size for a in self.axes(path))


def param_shards(cfg, mesh) -> Shards | None:
    """The ``Shards`` of ``init_params(cfg)`` on ``mesh``, or None where no
    axis cuts a leaf."""
    from repro_torch.parallel.sharding import param_specs

    if not sharded(mesh):
        return None
    cuts = _cuts(param_specs(cfg, mesh), mesh)
    return Shards(cuts) if cuts else None


def reduce_over(parts: list, axes: list, op: str = "sum") -> list:
    """``parts[i]`` (tensors of one dtype) reduced over every axis in
    ``axes[i]`` (a tuple of ``MeshAxis``, empty for a whole leaf): one
    all-reduce per axis, over the parts it cuts; a statistic of a leaf from
    its shards. Every rank of a subgroup passes the same cuts."""
    out = list(parts)
    for name in SHARD_AXES:
        at = [i for i, a in enumerate(axes) if any(x.name == name for x in a)]
        if not at:
            continue
        group = next(x for x in axes[at[0]] if x.name == name).group
        flat = all_reduce_(torch.cat([out[i].reshape(-1) for i in at]), group, op=op)
        for i, piece in zip(at, flat.split([out[i].numel() for i in at])):
            out[i] = piece.view(out[i].shape)
    return out


def _cut(leaf: torch.Tensor, cut: tuple) -> torch.Tensor:
    for ax, d in cut:
        leaf = _own(leaf, ax, d)
    return leaf


def _whole(leaf: torch.Tensor, cut: tuple) -> torch.Tensor:
    for ax, d in reversed(cut):
        leaf = _gather(leaf, ax, d)
    return leaf


def shard_tree(tree: Pytree, specs: Pytree, mesh) -> Pytree:
    """This rank's shards of a tree of whole leaves (a copy of each chunk,
    so the whole leaves can be freed)."""
    cuts = _cuts(specs, mesh) if sharded(mesh) else {}
    if not cuts:
        return tree
    return tree_map_with_path(lambda path, leaf: _cut(leaf, cuts.get(path_str(path), ())),
                              tree)


def gather_tree(tree: Pytree, specs: Pytree, mesh) -> Pytree:
    """Whole leaves from every rank's shards (every rank of the subgroups
    that cut them calls this together)."""
    cuts = _cuts(specs, mesh) if sharded(mesh) else {}
    if not cuts:
        return tree
    return tree_map_with_path(lambda path, leaf: _whole(leaf, cuts.get(path_str(path), ())),
                              tree)


# the subtrees of a train state laid out as the params, by the prefix of
# their ``train.checkpoint.flatten`` names, and how many dims they lead with
_PARAM_LIKE = {".params/": 0, ".opt_state/m/": 0, ".opt_state/v/": 0, ".residuals/": 1}


def state_cuts(state: Pytree, specs: Pytree, mesh) -> list:
    """The cuts ((MeshAxis, dim), ...) of every leaf of
    ``train.checkpoint.flatten(state)`` (empty where the leaf is whole): a
    params tree, or a ``TrainState`` whose params, Adam moments and
    residuals (one leading pod dim) follow the params' specs; w_q, steps
    and counters are replicated."""
    from repro_torch.train.checkpoint import flatten

    cuts = _cuts(specs, mesh)
    out = []
    for name, _ in flatten(state):
        cut = cuts.get(name, ())
        for prefix, lead in _PARAM_LIKE.items():
            if name.startswith(prefix) and name[len(prefix):] in cuts:
                cut = tuple((a, d + lead) for a, d in cuts[name[len(prefix):]])
        out.append(cut)
    return out


def gather_state(state: Pytree, specs: Pytree, mesh) -> Pytree:
    """``state`` (a params tree or a ``TrainState``) with every shard
    gathered into its whole leaf; every rank of the mesh calls it."""
    from repro_torch.train.checkpoint import flatten, unflatten

    if not sharded(mesh):
        return state
    return unflatten(state, [_whole(leaf, cut) for (_, leaf), cut in
                             zip(flatten(state), state_cuts(state, specs, mesh))])


def shard_state(state: Pytree, specs: Pytree, mesh) -> Pytree:
    """``state`` of whole leaves cut to this rank's shards (as
    ``gather_state``'s inverse)."""
    from repro_torch.train.checkpoint import flatten, unflatten

    if not sharded(mesh):
        return state
    return unflatten(state, [_cut(leaf, cut) for (_, leaf), cut in
                             zip(flatten(state), state_cuts(state, specs, mesh))])
