"""Training substrate on one device: the train-step factory,
checkpointing, fault-tolerance and re-placement helpers (port of
``repro.train``)."""

from repro_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.train.fault import elastic_reshard, retrying
from repro_torch.train.trainer import (
    TrainerConfig, TrainState, init_train_state, make_grad_fn, make_train_step,
)

__all__ = [
    "TrainState", "TrainerConfig", "make_train_step", "make_grad_fn", "init_train_state",
    "save_checkpoint", "restore_checkpoint", "latest_step",
    "retrying", "elastic_reshard",
]
