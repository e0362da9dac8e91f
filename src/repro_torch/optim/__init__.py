"""Functional optimizers over parameter trees (port of ``repro.optim``)."""

from repro_torch.optim.optimizers import Optimizer, adam, adamw, apply_updates, momentum, sgd

__all__ = ["Optimizer", "adam", "adamw", "apply_updates", "momentum", "sgd"]
