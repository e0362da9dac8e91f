"""Carry the JAX package's parameters and train states into the port.

JAX initializers draw with ``jax.random``, which torch cannot reproduce, so
code that wants both packages to compute from identical weights exports the
JAX tree as numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``)
and converts it here. The tree's keys and layouts are the same in both
packages.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dtypes import from_numpy
from repro_torch.tree import tree_map


def _tensor(a) -> torch.Tensor:
    """One numpy array as a writable CPU tensor; a bfloat16 array (numpy
    has none of its own; JAX exports ``ml_dtypes.bfloat16``) keeps its bits."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return from_numpy(a.view(np.uint16), "bfloat16")
    return torch.from_numpy(a)


def params_from_jax(tree_of_numpy, device: str | torch.device = "cuda", *, mesh=None,
                    specs=None):
    """A nested dict/list of numpy arrays → the same tree of tensors on
    ``device`` (copied, so the result is writable). With a ``mesh`` whose
    "model" or "data" axis has size > 1 and the tree's ``specs``
    (``parallel.sharding.param_specs``), this rank's shards."""
    dev = resolve_device(device)
    tree = tree_map(lambda a: _tensor(a).to(dev), tree_of_numpy)
    if mesh is None:
        return tree
    from repro_torch.parallel.tensor import shard_tree

    return shard_tree(tree, specs, mesh)


def train_state_from_jax(state_of_numpy, device: str | torch.device = "cuda"):
    """A reference ``repro.train.TrainState`` whose leaves were exported as
    numpy (``jax.tree_util.tree_map(np.asarray, state)``) → the port's
    ``TrainState`` on ``device``: params, w_q with its ``None`` leaves, the
    optimizer state, residuals and step, so both packages step from the
    same state. Reads the fields by name, so the JAX package is not
    imported."""
    from repro_torch.train.trainer import TrainState

    def conv(tree):
        return None if tree is None else params_from_jax(tree, device)

    return TrainState(params=conv(state_of_numpy.params), wq=conv(state_of_numpy.wq),
                      opt_state=conv(state_of_numpy.opt_state),
                      residuals=conv(state_of_numpy.residuals),
                      step=conv(state_of_numpy.step))
