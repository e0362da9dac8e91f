"""Carry the JAX package's parameters into the port.

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
from repro_torch.tree import tree_map


def params_from_jax(tree_of_numpy, device: str | torch.device = "cuda"):
    """A nested dict/list of numpy arrays → the same tree of tensors on
    ``device`` (copied, so the result is writable)."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree_of_numpy)
