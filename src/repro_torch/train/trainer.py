"""The single-device train step (port of ``repro.train.trainer``).

The paper-faithful QAT path: the loss is evaluated on FTTQ-quantized params
(clients train the quantized network, Algorithm 1), and the latent
full-precision params and the per-layer trained factors w_q update from the
straight-through gradients of ``core.fttq.FTTQQuantize``. The step clips the
params' gradients by their global norm, applies the optimizer, moves each
w_q by ``wq_lr · g / numel`` and counts the step. With ``microbatches > 1``
the batch is split on dim 0 and the chunks' gradients are averaged in fp32,
as the reference's scan does.

The reference's multi-pod branch (a mesh, ternary-compressed cross-pod
gradient sync with error-feedback residuals) is ROADMAP item 14 and raises
here. The step is eager PyTorch; the backward is autograd through plain
ops, as the reference's is ``jax.grad`` through plain ``jnp``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import fttq
from repro_torch.models import transformer as tfm
from repro_torch.optim import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.tree import flatten_with_path, tree_leaves, tree_map

Pytree = Any

_MULTI_DEVICE = ("needs the multi-device slice (ROADMAP item 14: the trainer's multi-pod "
                 "branch with ternary_allreduce_tree), which is not ported")


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
    cross-pod residuals (``None`` on one device) and the int32 step."""

    params: Pytree
    wq: Pytree
    opt_state: Pytree
    residuals: Pytree | None
    step: torch.Tensor


def init_train_state(model_cfg: tfm.ModelConfig, tcfg: TrainerConfig, optimizer: Optimizer,
                     seed: int = 0, *, params: Pytree | None = None,
                     device: str | torch.device = "cuda", n_pods: int = 1) -> TrainState:
    """Fresh state: ``params`` if given (kept as they are), else
    ``init_params(model_cfg, seed, device)``; w_q at its Prop-4.1 optimum."""
    if n_pods > 1 and tcfg.pod_compression:
        raise NotImplementedError(f"n_pods={n_pods} with pod_compression {_MULTI_DEVICE}")
    if params is None:
        params = tfm.init_params(model_cfg, seed=seed, device=device)
    wq = fttq.init_wq_tree(params, tcfg.fttq) if tcfg.qat else None
    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    return TrainState(params=params, wq=wq, opt_state=optimizer.init(params),
                      residuals=None, step=step)


def _loss(model_cfg, tcfg: TrainerConfig, params, wq, batch):
    qparams = fttq.quantize_tree(params, wq, tcfg.fttq) if tcfg.qat else params
    return tfm.loss_fn(model_cfg, qparams, batch)


def _rebuild(tree: Pytree, leaves: list) -> Pytree:
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _grads_of(model_cfg, tcfg: TrainerConfig, state: TrainState, batch):
    """(loss, metrics, ∂loss/∂params, ∂loss/∂w_q or None) by autograd."""
    params = tree_map(lambda p: p.detach().requires_grad_(True), state.params)
    wq = tree_map(lambda w: w.detach().requires_grad_(True), state.wq) if tcfg.qat else None
    with torch.enable_grad():
        loss, metrics = _loss(model_cfg, tcfg, params, wq, batch)
        p_leaves = tree_leaves(params)
        w_leaves = tree_leaves(wq) if tcfg.qat else []
        grads = torch.autograd.grad(loss, p_leaves + w_leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(p_leaves + w_leaves, grads)]
    g_p = _rebuild(state.params, grads[:len(p_leaves)])
    g_w = _rebuild(state.wq, grads[len(p_leaves):]) if tcfg.qat else None
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, g_p, g_w


def _local_grads(model_cfg, tcfg: TrainerConfig, state: TrainState, batch):
    """The whole batch's gradients, or with ``microbatches`` = n > 1 the
    mean over n sequential chunks of dim 0, accumulated in fp32 zeros with
    each chunk's gradient divided by n (the reference's scan)."""
    n = tcfg.microbatches
    if n <= 1:
        return _grads_of(model_cfg, tcfg, state, batch)
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
            model_cfg, tcfg, state, {k: v[i] for k, v in chunks.items()})
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
                 grads, g_wq):
    grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
    updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
    params = apply_updates(state.params, updates)
    del updates
    if tcfg.qat:
        # float(numel): stacked expert weights exceed 2^31 elements
        sizes = {path: float(p.numel()) for path, p in flatten_with_path(state.params)}
        wq = _rebuild(state.wq, [
            (w - tcfg.wq_lr * g / sizes[path]).to(w.dtype)
            for (path, w), g in zip(flatten_with_path(state.wq), tree_leaves(g_wq))])
    else:
        wq = state.wq
    new_state = TrainState(params=params, wq=wq, opt_state=opt_state,
                           residuals=state.residuals, step=state.step + 1)
    return new_state, {"loss": loss, "grad_norm": gnorm, **metrics}


def make_train_step(model_cfg: tfm.ModelConfig, tcfg: TrainerConfig, optimizer: Optimizer,
                    mesh=None):
    """Returns ``step(state, batch) -> (state, metrics)`` with metrics
    ``loss, grad_norm, ce, aux`` as 0-d tensors on the state's device. The
    input state is not modified."""
    if mesh is not None:
        raise NotImplementedError(f"a mesh {_MULTI_DEVICE}")

    def step(state: TrainState, batch: dict):
        with torch.no_grad():
            # no frame here keeps the gradients, so clipping frees them
            return _apply_grads(tcfg, optimizer, state,
                                *_local_grads(model_cfg, tcfg, state, batch))

    return step
