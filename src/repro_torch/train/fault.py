"""Fault tolerance and re-placement helpers (port of ``repro.train.fault``).

Failure model:
  - CLIENT loss mid-round (federated path): handled inside the servers,
    which reweight the fold over the survivors.
  - HOST crash: training resumes from the newest atomic checkpoint
    (``train.checkpoint``); the data cursor and the step live in it, so the
    resumed run repeats the uninterrupted one after the lost steps.
  - STRAGGLERS: a wall-clock budget per unit of work (``StragglerDeadline``).
  - ELASTIC RESCALE: ``elastic_reshard`` re-places a state onto a smaller or
    larger mesh (e.g. 2 pods → 1 pod after a pod outage) with the same
    sharding rules (``parallel.sharding.param_shardings``): every leaf
    becomes a DTensor with the new mesh's placements, the counterpart of
    the reference's ``device_put`` with new ``NamedSharding``s; it takes
    whole leaves (``parallel.tensor.gather_state`` of a sharded state), and
    the train step keeps each rank's chunk of every "model" and "data"
    placement (``trainer.local_state``). Given one device instead, it moves
    every leaf there.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.parallel.sharding import NamedSharding
from repro_torch.train.checkpoint import flatten, unflatten

log = logging.getLogger("repro_torch.fault")

Pytree = Any


def retrying(fn: Callable, *, max_attempts: int = 3, backoff_s: float = 0.1,
             retryable=(RuntimeError, OSError)):
    """Wrap a step or IO function with bounded retry and exponential
    back-off (transient failures: preempted hosts, file-system hiccups)."""

    def wrapped(*args, **kwargs):
        last = None
        for attempt in range(max_attempts):
            try:
                return fn(*args, **kwargs)
            except retryable as e:
                last = e
                log.warning("attempt %d/%d failed: %s", attempt + 1, max_attempts, e)
                time.sleep(backoff_s * (2 ** attempt))
        raise last

    return wrapped


def _shardings(tree) -> list:
    """The ``NamedSharding`` leaves of a tree of them, in flatten order."""
    if isinstance(tree, NamedSharding) or tree is None:
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [s for f in dataclasses.fields(tree) for s in _shardings(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _shardings(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in _shardings(v)]
    raise TypeError(f"elastic_reshard: {type(tree).__name__} is not a sharding tree")


def _place(leaf, sharding: NamedSharding | None):
    if not isinstance(leaf, torch.Tensor) or sharding is None:
        return leaf
    from torch.distributed.tensor import distribute_tensor

    mesh = sharding.mesh
    if hasattr(leaf, "full_tensor"):            # a DTensor of an earlier mesh
        leaf = leaf.full_tensor()
    return distribute_tensor(leaf.detach().to(mesh.device), mesh.device_mesh,
                             sharding.placements)


def elastic_reshard(state: Pytree, shardings) -> Pytree:
    """Re-place every leaf of ``state`` (dataclasses such as ``TrainState``,
    dicts, lists and tuples: params, w_q, optimizer moments, the step,
    residuals) onto new shardings: a tree of ``NamedSharding`` matching
    ``state``, or a single one for every leaf. Each tensor leaf becomes a
    DTensor on the sharding's mesh, its values unchanged; every rank of that
    mesh calls this together. ``shardings`` may also be one device (a str
    or ``torch.device``), which every leaf moves to."""
    leaves = [leaf for _, leaf in flatten(state)]
    if isinstance(shardings, (str, torch.device)):
        dev = resolve_device(shardings)
        return unflatten(state, [leaf.to(dev) if isinstance(leaf, torch.Tensor) else leaf
                                 for leaf in leaves])
    if isinstance(shardings, NamedSharding):
        per_leaf = [shardings] * len(leaves)
    else:
        per_leaf = _shardings(shardings)
        if len(per_leaf) != len(leaves):
            raise ValueError(f"elastic_reshard: {len(per_leaf)} shardings for "
                             f"{len(leaves)} leaves")
    return unflatten(state, [_place(leaf, s) for leaf, s in zip(leaves, per_leaf)])


class StragglerDeadline:
    """Wall-clock budget for a unit of work; callers drop work that overruns."""

    def __init__(self, budget_s: float):
        self.budget_s = budget_s
        self._start = time.monotonic()

    def reset(self):
        self._start = time.monotonic()

    def exceeded(self) -> bool:
        return (time.monotonic() - self._start) > self.budget_s

    def remaining(self) -> float:
        return max(0.0, self.budget_s - (time.monotonic() - self._start))
