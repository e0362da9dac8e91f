"""Fault tolerance and re-placement helpers (port of ``repro.train.fault``).

Failure model:
  - CLIENT loss mid-round (federated path): handled inside the servers,
    which reweight the fold over the survivors.
  - HOST crash: training resumes from the newest atomic checkpoint
    (``train.checkpoint``); the data cursor and the step live in it, so the
    resumed run repeats the uninterrupted one after the lost steps.
  - STRAGGLERS: a wall-clock budget per unit of work (``StragglerDeadline``).
  - RE-PLACEMENT: ``elastic_reshard`` moves a state onto a device. Resharding
    over a mesh (the reference's elastic rescale after a pod loss) needs the
    multi-device slice, ROADMAP item 14.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable

import torch

from repro_torch.device import resolve_device
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


def elastic_reshard(state: Pytree, device: str | torch.device) -> Pytree:
    """Every tensor leaf of ``state`` (dataclasses such as ``TrainState``,
    dicts, lists and tuples) moved to ``device``. A per-leaf tree of shardings or a mesh placement raises:
    that is the multi-device slice (ROADMAP item 14)."""
    if not isinstance(device, (str, torch.device)):
        raise NotImplementedError(
            "re-placing a state over a mesh needs the multi-device slice (ROADMAP item 14), "
            "which is not ported; pass one device")
    dev = resolve_device(device)
    return unflatten(state, [leaf.to(dev) if isinstance(leaf, torch.Tensor) else leaf
                             for _, leaf in flatten(state)])


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
