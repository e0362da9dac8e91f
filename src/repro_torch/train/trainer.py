"""The train step, on one device or over a mesh of ranks (port of
``repro.train.trainer``).

The paper-faithful QAT path: the loss is evaluated on FTTQ-quantized params
(clients train the quantized network, Algorithm 1), and the latent
full-precision params and the per-layer trained factors w_q update from the
straight-through gradients of ``core.fttq.FTTQQuantize``. The step clips the
params' gradients by their global norm, applies the optimizer, moves each
w_q by ``wq_lr · g / numel`` and counts the step. With ``microbatches > 1``
the batch is split on dim 0 and the chunks' gradients are averaged in fp32,
as the reference's scan does.

Over a mesh (``launch.mesh``) every rank takes its own rows of the global
batch (dim 0 sharded over ("pod", "data"), pod major; with microbatches,
its share of each of the reference's global microbatches, ``_rank_rows``),
and holds its
shards of the state as the specs (``parallel.sharding``) place it:

- A "model" axis of size > 1 is tensor parallelism (every family): each
  rank holds its chunk of the "model"-sharded params (attention and MLP
  columns, expert stacks by expert, Mamba2 projections, vocab) and of
  their Adam moments; the forward is column- then row-parallel with a
  vocab-parallel loss (``parallel.tensor``; local experts in
  ``models.moe`` or over the all-to-all of ``models.moe_a2a``, gathered
  weights in ``models.mamba2``).
- A "data" axis of size > 1 is FSDP (ZeRO-3) as well as data parallelism:
  each rank holds its chunk of every leaf whose spec puts "data" on a dim
  (params, both Adam moments and the pods' residuals), each layer gathers
  those weights where it uses them and the backward reduce-scatters their
  gradients (``parallel.tensor.gather_layer``), which sums them over the
  data ranks; they are divided by the axis's size once, while the loss,
  the metrics and the leaves whole over "data" are averaged over its
  subgroup, which is what GSPMD's automatic axis computes. The MoE layers
  route the ranks' rows as one batch (``parallel.tensor.BatchAxes``: the
  global capacity, queue slots and load loss), over the pods too where
  their sync is not the compressed per-pod one.

On shards the w_q stay whole on every rank; FTTQ's statistics, their w_q
gradients, the clip's global norm and the w_q step (``wq_lr · g /
numel``) are the whole leaf's (``parallel.tensor.Shards``). Across pods (a
"pod" axis) with ``pod_compression`` the parameter gradients are synced
by ``parallel.collectives.ternary_allreduce_tree`` with error feedback (on
the rank's shards, with whole-leaf scalars), the w_q gradients, loss and
metrics by an exact mean, and every rank applies the same update (the
reference's ``trainer.py:213–262``); without it the pod sync is an exact
mean too. Each rank keeps its own pod's residuals of its shards as a (1,
*shape) block; ``gather_residuals`` assembles the reference's (n_pods,
*shape) tree over the pods, ``parallel.tensor.gather_state`` the whole
leaves over "model" and "data". A state whose leaves are not the rank's
shards is refused (``ValueError``), not cut. The step is eager PyTorch;
the backward is autograd through plain ops, as the reference's is
``jax.grad`` through plain ``jnp``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core import fttq
from repro_torch.models import transformer as tfm
from repro_torch.optim import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.parallel.collectives import (
    all_gather, all_reduce_, group_size, ternary_allreduce_tree,
)
from repro_torch.parallel.sharding import logical_batch_axes, param_specs
from repro_torch.parallel.tensor import (
    SHARD_AXES, batch_axes, data_axis, model_axis, param_shards, shard_tree,
)
from repro_torch.tree import flatten_with_path, path_str, tree_leaves, tree_map

Pytree = Any


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    qat: bool = True                     # train the quantized network (FTTQ)
    fttq: fttq.FTTQConfig = dataclasses.field(default_factory=fttq.FTTQConfig)
    grad_clip: float = 1.0
    wq_lr: float = 0.05
    pod_compression: bool = True         # ternary cross-pod grad sync (multi-pod only)
    error_feedback: bool = True
    microbatches: int = 1                # gradient-accumulation chunks


@dataclasses.dataclass
class TrainState:
    """Latent params, their w_q factors (``None`` where a leaf is not
    quantized, or for the whole tree without QAT), the optimizer state, the
    cross-pod error-feedback residuals (``None`` without compressed pods:
    (n_pods, *shape) per leaf in one process, this rank's (1, *shape) pod
    block on a mesh) and the int32 step."""

    params: Pytree
    wq: Pytree
    opt_state: Pytree
    residuals: Pytree | None
    step: torch.Tensor


def init_train_state(model_cfg: tfm.ModelConfig, tcfg: TrainerConfig, optimizer: Optimizer,
                     seed: int = 0, *, params: Pytree | None = None,
                     device: str | torch.device = "cuda", n_pods: int = 1,
                     mesh=None) -> TrainState:
    """Fresh state: ``params`` if given (kept as they are), else
    ``init_params(model_cfg, seed, device)``; w_q at its Prop-4.1 optimum.
    With compressed pods (``n_pods`` > 1, ``pod_compression`` and
    ``error_feedback``) the residuals start at zero: (n_pods, *shape) per
    leaf, as the reference stacks them, or on a ``mesh`` whose "pod" axis
    has ``n_pods`` ranks this rank's (1, *shape) block. On a mesh whose
    "model" or "data" axis has size > 1 the whole params (given or drawn)
    are cut to this rank's shards after the w_q are made from them; the
    Adam moments and residuals follow the shards."""
    if mesh is not None and mesh.size("pod") != n_pods:
        raise ValueError(f"the mesh has {mesh.size('pod')} pods, not n_pods={n_pods}")
    if params is None:
        params = tfm.init_params(model_cfg, seed=seed, device=device)
    wq = fttq.init_wq_tree(params, tcfg.fttq) if tcfg.qat else None
    if mesh is not None:
        params = shard_tree(params, param_specs(model_cfg, mesh), mesh)
    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    residuals = None
    if tcfg.pod_compression and n_pods > 1 and tcfg.error_feedback:
        lead = 1 if mesh is not None else n_pods
        residuals = tree_map(
            lambda p: torch.zeros((lead,) + tuple(p.shape), dtype=torch.float32,
                                  device=p.device), params)
    return TrainState(params=params, wq=wq, opt_state=optimizer.init(params),
                      residuals=residuals, step=step)


@dataclasses.dataclass(frozen=True)
class StepAxes:
    """How a step sees its mesh: ``tp`` the "model" axis, ``fsdp`` the
    "data" axis (``parallel.tensor.MeshAxis``, None at size 1), ``dp`` the
    MoE's batch axes (``BatchAxes``) and ``shards`` the axes that cut each
    leaf (``parallel.tensor.Shards``)."""

    tp: Any = None
    fsdp: Any = None
    dp: Any = None
    shards: Any = None


def step_axes(model_cfg: tfm.ModelConfig, tcfg: TrainerConfig, mesh) -> StepAxes:
    """The ``StepAxes`` of ``make_train_step`` on ``mesh`` (empty for None).
    The MoE routes over the data axis, and the pods too where their sync is
    not the compressed per-pod one, as the reference's GSPMD step treats
    their rows as one batch."""
    if mesh is None:
        return StepAxes()
    compressed = "pod" in mesh.axis_names and tcfg.pod_compression
    return StepAxes(model_axis(mesh), data_axis(mesh),
                    batch_axes(mesh, ("data",) if compressed else logical_batch_axes(mesh)),
                    param_shards(model_cfg, mesh))


def _loss(model_cfg, tcfg: TrainerConfig, params, wq, batch, ax: StepAxes):
    qparams = fttq.quantize_tree(params, wq, tcfg.fttq, ax.shards) if tcfg.qat else params
    return tfm.loss_fn(model_cfg, qparams, batch, ax.tp, ax.dp, ax.fsdp)


def _rebuild(tree: Pytree, leaves: list) -> Pytree:
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _grads_of(model_cfg, tcfg: TrainerConfig, state: TrainState, batch, ax: StepAxes):
    """(loss, metrics, ∂loss/∂params, ∂loss/∂w_q or None) by autograd."""
    params = tree_map(lambda p: p.detach().requires_grad_(True), state.params)
    wq = tree_map(lambda w: w.detach().requires_grad_(True), state.wq) if tcfg.qat else None
    with torch.enable_grad():
        loss, metrics = _loss(model_cfg, tcfg, params, wq, batch, ax)
        p_leaves = tree_leaves(params)
        w_leaves = tree_leaves(wq) if tcfg.qat else []
        grads = torch.autograd.grad(loss, p_leaves + w_leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(p_leaves + w_leaves, grads)]
    g_p = _rebuild(state.params, grads[:len(p_leaves)])
    g_w = _rebuild(state.wq, grads[len(p_leaves):]) if tcfg.qat else None
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, g_p, g_w


def _local_grads(model_cfg, tcfg: TrainerConfig, state: TrainState, batch,
                 ax: StepAxes = StepAxes()):
    """The whole batch's gradients, or with ``microbatches`` = n > 1 the
    mean over n sequential chunks of dim 0, accumulated in fp32 zeros with
    each chunk's gradient divided by n (the reference's scan)."""
    n = tcfg.microbatches
    if n <= 1:
        return _grads_of(model_cfg, tcfg, state, batch, ax)
    chunks = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:]) for k, v in batch.items()}
    dev = state.step.device
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    metrics = {"ce": torch.zeros((), dtype=torch.float32, device=dev),
               "aux": torch.zeros((), dtype=torch.float32, device=dev)}
    g_p = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                   state.params)
    g_w = (tree_map(lambda w: torch.zeros(w.shape, dtype=torch.float32, device=w.device),
                    state.wq) if tcfg.qat else None)
    for i in range(n):
        c_loss, c_metrics, c_p, c_w = _grads_of(
            model_cfg, tcfg, state, {k: v[i] for k, v in chunks.items()}, ax)
        loss = loss + c_loss / n
        metrics = {k: metrics[k] + c_metrics[k] / n for k in metrics}
        for a, g in zip(tree_leaves(g_p), tree_leaves(c_p)):
            a.add_(g.to(torch.float32) / n)
        if g_w is not None:
            for a, g in zip(tree_leaves(g_w), tree_leaves(c_w)):
                a.add_(g / n)
        del c_p, c_w
    return loss, metrics, g_p, g_w


def _apply_grads(tcfg: TrainerConfig, optimizer: Optimizer, state: TrainState, loss, metrics,
                 grads, g_wq, residuals, shards=None):
    grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip, shards=shards)
    updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
    params = apply_updates(state.params, updates)
    del updates
    if tcfg.qat:
        # float(numel): stacked expert weights exceed 2^31 elements; a
        # shard's factor steps by its whole leaf's count
        sizes = {path: float(p.numel()) * (shards.factor(path_str(path)) if shards else 1)
                 for path, p in flatten_with_path(state.params)}
        wq = _rebuild(state.wq, [
            (w - tcfg.wq_lr * g / sizes[path]).to(w.dtype)
            for (path, w), g in zip(flatten_with_path(state.wq), tree_leaves(g_wq))])
    else:
        wq = state.wq
    new_state = TrainState(params=params, wq=wq, opt_state=opt_state,
                           residuals=residuals, step=state.step + 1)
    return new_state, {"loss": loss, "grad_norm": gnorm, **metrics}


def _mean_over(group, loss, metrics, g_p, g_w, summed: frozenset = frozenset()):
    """Exact mean over ``group`` of the loss, the metrics and the gradient
    trees (``g_p`` may be None), in one fp32 all-reduce. The leaves of
    ``summed`` (param path strings: the data shards, whose gradients the
    reduce-scatter and whose w_q gradients FTTQ's backward already summed
    over ``group``) are divided by its size instead."""
    if group is None:
        return loss, metrics, g_p, g_w
    p = group_size(group)
    parts = [loss.reshape(1)] + [metrics[k].reshape(1) for k in sorted(metrics)]
    items = (flatten_with_path(g_p) if g_p is not None else []) + (
        flatten_with_path(g_w) if g_w is not None else [])
    own = [path_str(path) in summed for path, _ in items]
    mean = parts + [t for (_, t), o in zip(items, own) if not o]
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in mean])
    all_reduce_(flat, group, mean=True)
    out, at = [], 0
    for t in mean:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    n = 1 + len(metrics)
    loss, metrics = out[0].reshape(()), dict(zip(sorted(metrics), (m.reshape(()) for m in out[1:n])))
    it = iter(out[n:])
    leaves = [t / p if o else next(it) for (_, t), o in zip(items, own)]
    k = len(tree_leaves(g_p)) if g_p is not None else 0
    g_p = _rebuild(g_p, leaves[:k]) if g_p is not None else None
    g_w = _rebuild(g_w, leaves[k:]) if g_w is not None else None
    return loss, metrics, g_p, g_w


def _pod_block(residuals: Pytree, mesh) -> Pytree | None:
    """This rank's pod residuals, (1, *shape) blocks or the stacked
    (n_pods, *shape) tree, as (*shape) leaves."""
    if residuals is None:
        return None
    i = mesh.index("pod")
    return tree_map(lambda r: r[0] if r.shape[0] == 1 else r[i], residuals)


def _local(leaf):
    """A DTensor as the trainer holds it: whole over every mesh dim but
    "model" and "data", where a ``Shard(d)`` placement keeps this rank's
    chunk of d."""
    from torch.distributed.tensor import Shard

    out = leaf.full_tensor()
    mesh = leaf.device_mesh
    names = mesh.mesh_dim_names or ()
    for name in SHARD_AXES:
        if name not in names:
            continue
        place = leaf.placements[names.index(name)]
        if isinstance(place, Shard) and mesh.size(names.index(name)) > 1:
            out = out.chunk(mesh.size(names.index(name)), place.dim)[mesh.get_local_rank(name)]
    return out.clone(memory_format=torch.contiguous_format)


def local_state(state: TrainState) -> TrainState:
    """``state`` with every DTensor leaf (a state re-placed by
    ``fault.elastic_reshard``) made a plain tensor on its rank: whole, or
    this rank's chunk where its placement shards the "model" or "data"
    axis."""
    from repro_torch.train.checkpoint import flatten, unflatten

    leaves = [leaf for _, leaf in flatten(state)]
    if not any(hasattr(leaf, "full_tensor") for leaf in leaves):
        return state
    return unflatten(state, [_local(leaf) if hasattr(leaf, "full_tensor") else leaf
                             for leaf in leaves])


def gather_residuals(state: TrainState, mesh) -> TrainState:
    """``state`` with its per-rank (1, *shape) pod residuals gathered over
    the mesh's "pod" axis into the reference's (n_pods, *shape) tree (for
    checkpoints and parity); every rank of the pod axis calls it."""
    if state.residuals is None:
        return state
    group = mesh.group("pod")
    res = tree_map(lambda r: all_gather(r[0], group), state.residuals)
    return dataclasses.replace(state, residuals=res)


def _layout(model_cfg: tfm.ModelConfig, mesh) -> dict:
    """{param path string: this rank's shard shape on ``mesh``}."""
    return {path_str(p): tuple(s) for p, s in flatten_with_path(
        tfm.param_shapes(model_cfg, mesh), is_leaf=lambda x: isinstance(x, tuple))}


def check_layout(state: TrainState, layout: dict, mesh) -> None:
    """Raise ``ValueError`` naming the first params or Adam-moment leaf of
    ``state`` whose shape is not its shard's in ``layout`` (``_layout``):
    ``init_train_state(..., mesh=)`` or ``parallel.tensor.shard_state``
    make a state that fits."""
    from repro_torch.train.checkpoint import flatten

    for name, leaf in flatten(state):
        for prefix in (".params/", ".opt_state/m/", ".opt_state/v/"):
            want = layout.get(name[len(prefix):]) if name.startswith(prefix) else None
            if want is not None and tuple(leaf.shape) != want:
                raise ValueError(
                    f"{name}: shape {tuple(leaf.shape)} is not this rank's shard {want} on "
                    f"{mesh!r}; make the state on the mesh (init_train_state(..., mesh=)) "
                    "or cut it (parallel.tensor.shard_state)")


def _rank_rows(v: torch.Tensor, n_shards: int, shard: int, n_micro: int,
               micro_shards: int) -> torch.Tensor:
    """Rank ``shard``'s rows of the global batch ``v``, in the order
    ``_local_grads`` splits them: its microbatch i is its share of the
    reference's microbatch i. The reference cuts the global rows (or, with
    ``micro_shards`` < ``n_shards``, each block of ``n_shards //
    micro_shards`` ranks' rows: a pod's) into ``n_micro`` chunks and places
    each chunk's rows over the ``micro_shards`` ranks of the block."""
    blocks = n_shards // micro_shards
    per_block = v.shape[0] // blocks
    b, j = divmod(shard, micro_shards)
    block = v[b * per_block:(b + 1) * per_block]
    chunk = per_block // n_micro
    per = chunk // micro_shards
    mine = block.reshape(n_micro, chunk, *v.shape[1:])[:, j * per:(j + 1) * per]
    return mine.reshape(n_micro * per, *v.shape[1:])


def make_grad_fn(model_cfg: tfm.ModelConfig, tcfg: TrainerConfig, mesh=None):
    """Returns ``grads(state, batch) -> (loss, metrics, g_p, g_w)``: the
    gradients the train step takes from this rank's rows of the global
    ``batch`` (its shards' over "model" and "data"), averaged over the data
    subgroup, before any cross-pod sync; ``make_train_step`` calls it."""
    ax = step_axes(model_cfg, tcfg, mesh)
    # the data shards, whose gradients arrive summed over the data ranks
    summed = frozenset(p for p, cut in ax.shards.cuts.items()
                       if any(a.name == "data" for a, _ in cut)) if ax.shards else frozenset()
    compressed = mesh is not None and "pod" in mesh.axis_names and tcfg.pod_compression
    bax = logical_batch_axes(mesh) if mesh is not None else ()
    n_shards = math.prod(mesh.size(a) for a in bax)
    shard = mesh.linear_index(bax) if mesh is not None else 0
    # the reference's microbatch split is over the global rows, or a pod's
    # rows where the compressed step's body is manual over "pod"
    micro_shards = mesh.size("data") if compressed else n_shards
    data_group = mesh.group("data") if mesh is not None else None

    def grads(state: TrainState, batch: dict):
        rows = {}
        for k, v in batch.items():
            if v.shape[0] % (n_shards * tcfg.microbatches):
                raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not split over "
                                 f"{n_shards} ranks and {tcfg.microbatches} microbatches")
            rows[k] = _rank_rows(v, n_shards, shard, tcfg.microbatches, micro_shards)
        loss, metrics, g_p, g_w = _local_grads(model_cfg, tcfg, state, rows, ax)
        return _mean_over(data_group, loss, metrics, g_p, g_w, summed)

    return grads


def make_train_step(model_cfg: tfm.ModelConfig, tcfg: TrainerConfig, optimizer: Optimizer,
                    mesh=None):
    """Returns ``step(state, batch) -> (state, metrics)`` with metrics
    ``loss, grad_norm, ce, aux`` as 0-d tensors on the state's device. The
    input state is not modified. With a ``mesh``, every rank calls the step
    with the same global batch and its state (its shards over "model" and
    "data"; a leaf of another shape raises ``ValueError``)."""
    ax = step_axes(model_cfg, tcfg, mesh)
    layout = _layout(model_cfg, mesh) if mesh is not None else None
    grads = make_grad_fn(model_cfg, tcfg, mesh)
    # no mesh is one shard with no subgroups: every sync below is the identity
    compressed = mesh is not None and "pod" in mesh.axis_names and tcfg.pod_compression
    pod_group = mesh.group("pod") if mesh is not None else None

    def synced_grads(state: TrainState, batch: dict):
        """(loss, metrics, g_p, g_w, residuals): this rank's rows' gradients,
        synced over the data and pod subgroups."""
        loss, metrics, g_p, g_w = grads(state, batch)
        if not compressed:
            return (*_mean_over(pod_group, loss, metrics, g_p, g_w), state.residuals)
        g_p, res = ternary_allreduce_tree(
            g_p, pod_group, cfg=tcfg.fttq, residuals=_pod_block(state.residuals, mesh),
            error_feedback=tcfg.error_feedback, shards=ax.shards)
        loss, metrics, _, g_w = _mean_over(pod_group, loss, metrics, None, g_w)
        return loss, metrics, g_p, g_w, tree_map(lambda r: r[None], res)

    def step(state: TrainState, batch: dict):
        state = local_state(state)
        if layout is not None:
            check_layout(state, layout, mesh)
        with torch.no_grad():
            # no frame here keeps the gradients, so clipping frees them
            return _apply_grads(tcfg, optimizer, state, *synced_grads(state, batch),
                                ax.shards)

    return step
