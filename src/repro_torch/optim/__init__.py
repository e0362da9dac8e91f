"""Functional optimizers, global-norm clipping and learning-rate schedules
over parameter trees (port of ``repro.optim``)."""

from repro_torch.optim.optimizers import (
    Optimizer, adam, adamw, apply_updates, clip_by_global_norm, cosine_schedule,
    global_norm, momentum, sgd, warmup_cosine_schedule,
)

__all__ = ["Optimizer", "adam", "adamw", "apply_updates", "clip_by_global_norm",
           "cosine_schedule", "global_norm", "momentum", "sgd", "warmup_cosine_schedule"]
