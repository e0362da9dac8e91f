"""SGD / momentum / Adam / AdamW with the reference's ``(init, update)``
contract, global-norm clipping and the cosine learning-rate schedules (port
of ``repro.optim.optimizers``).

Optimizers are functional over parameter trees (nested dicts of tensors):
``update(grads, state, params)`` returns ``(updates, new_state)`` and
``apply_updates`` adds the updates as ``(p.f32 + u).astype(p.dtype)``.
States hold fp32 moments shaped like the parameters. Nothing is updated in
place, so one broadcast tree can start many clients' training.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.tree import flatten_with_path, path_str, tree_leaves, tree_map

Pytree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """(init, update) pair; updates are ADDED to params (``apply_updates``)."""

    init: Callable[[Pytree], Pytree]
    update: Callable[..., tuple[Pytree, Pytree]]


def _zeros_like_f32(params: Pytree) -> Pytree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def _step0(params: Pytree) -> torch.Tensor:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def _resolve_lr(lr, step: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return lr(step)
    return torch.tensor(lr, dtype=torch.float32, device=step.device)


def _map2(fn, a: Pytree, b: Pytree) -> Pytree:
    """``fn`` over two trees of the same structure."""
    bs = iter(tree_leaves(b))
    return tree_map(lambda x: fn(x, next(bs)), a)


def sgd(lr) -> Optimizer:
    def init(params):
        return {"step": _step0(params)}

    def update(grads, state, params=None):
        lr_t = _resolve_lr(lr, state["step"])
        updates = tree_map(lambda g: -lr_t * g.to(torch.float32), grads)
        return updates, {"step": state["step"] + 1}

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"step": _step0(params), "m": _zeros_like_f32(params)}

    def update(grads, state, params=None):
        lr_t = _resolve_lr(lr, state["step"])
        m = _map2(lambda m_, g: beta * m_ + g.to(torch.float32), state["m"], grads)
        if nesterov:
            upd = _map2(lambda m_, g: -lr_t * (beta * m_ + g.to(torch.float32)), m, grads)
        else:
            upd = tree_map(lambda m_: -lr_t * m_, m)
        return upd, {"step": state["step"] + 1, "m": m}

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam; with weight_decay > 0 it is decoupled (AdamW). The bias
    corrections are computed in fp32, as the reference does."""

    def init(params):
        return {"step": _step0(params), "m": _zeros_like_f32(params),
                "v": _zeros_like_f32(params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _resolve_lr(lr, state["step"])
        step_f = step.to(torch.float32)
        bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=step.device) ** step_f
        bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=step.device) ** step_f
        m = _map2(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32), state["m"], grads)
        v = _map2(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.to(torch.float32)),
                  state["v"], grads)

        def upd(m_, v_, p):
            u = -(lr_t * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps))
            if weight_decay > 0.0 and p is not None:
                u = u - lr_t * weight_decay * p.to(torch.float32)
            return u

        if weight_decay > 0.0:
            vs, ps = iter(tree_leaves(v)), iter(tree_leaves(params))
            updates = tree_map(lambda m_: upd(m_, next(vs), next(ps)), m)
        else:
            updates = _map2(lambda m_, v_: upd(m_, v_, None), m, v)
        return updates, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    return adam(lr, b1, b2, eps, weight_decay)


def apply_updates(params: Pytree, updates: Pytree) -> Pytree:
    return _map2(lambda p, u: (p.to(torch.float32) + u).to(p.dtype), params, updates)


def global_norm(tree: Pytree, *, shards=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32. The leaves' sums
    are added one after another in flatten order, as the reference's
    Python ``sum`` adds them. Under tensor parallelism or FSDP ``shards`` (a
    ``parallel.tensor.Shards``) names the axes that cut each leaf: a
    shard's sum is all-reduced over them (one collective per axis for all
    of them), a whole leaf counted once."""
    items = flatten_with_path(tree)
    sums = [torch.sum(torch.square(leaf.to(torch.float32))) for _, leaf in items]
    if shards is not None:
        from repro_torch.parallel.tensor import reduce_over

        sums = reduce_over(sums, [shards.axes(path_str(p)) for p, _ in items])
    total = 0
    for v in sums:
        total = total + v
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads: Pytree, max_norm: float, *,
                        shards=None) -> tuple[Pytree, torch.Tensor]:
    """(grads scaled by min(1, max_norm / (‖grads‖ + 1e-9)), ‖grads‖);
    ``shards`` as in ``global_norm``."""
    gn = global_norm(grads, shards=shards)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def cosine_schedule(base_lr: float, total_steps: int, final_frac: float = 0.1):
    """lr(step) decaying from ``base_lr`` to ``final_frac · base_lr`` over
    ``total_steps`` on a half cosine; ``step`` is an int32 tensor."""

    def lr(step: torch.Tensor) -> torch.Tensor:
        t = torch.clamp(step.to(torch.float32) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return base_lr * (final_frac + (1 - final_frac) * cos)

    return lr


def warmup_cosine_schedule(base_lr: float, warmup: int, total_steps: int,
                           final_frac: float = 0.1):
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then the cosine
    decay over the remaining ``total_steps - warmup``."""
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), final_frac)

    def lr(step: torch.Tensor) -> torch.Tensor:
        warm = base_lr * (step.to(torch.float32) + 1) / max(warmup, 1)
        return torch.where(step < warmup, warm, cos(step - warmup))

    return lr
