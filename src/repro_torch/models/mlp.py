"""Dense feed-forward blocks: gated (SwiGLU/GeGLU) and plain (port of
``repro.models.mlp``). Under tensor parallelism ``w_in``/``w_gate`` are
column-parallel over the hidden units, the activation runs on the local
columns, and ``w_out`` is row-parallel, followed by ``reduce_from_model``."""

from __future__ import annotations

import torch

from repro_torch.models.common import act_fn, dense_init, matmul
from repro_torch.parallel.tensor import copy_to_model, reduce_from_model


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, gated: bool, dtype,
             n_layers: int | None = None):
    """MLP weights, stacked (n_layers, ...) unless ``n_layers`` is None."""
    lead = () if n_layers is None else (n_layers,)
    p = {
        "w_in": dense_init(gen, lead + (d_model, d_ff), dtype),
        "w_out": dense_init(gen, lead + (d_ff, d_model), dtype),
    }
    if gated:
        p["w_gate"] = dense_init(gen, lead + (d_model, d_ff), dtype)
    return p


def mlp(params: dict, x: torch.Tensor, activation: str = "silu", tp=None) -> torch.Tensor:
    """``tp``: the "model" axis the hidden units are sharded over, or None
    for whole weights."""
    act = act_fn(activation)
    if tp is not None:
        x = copy_to_model(x, tp)
    h = matmul(x, params["w_in"])
    if "w_gate" in params:
        h = act(matmul(x, params["w_gate"])) * h
    else:
        h = act(h)
    out = matmul(h, params["w_out"])
    return reduce_from_model(out, tp) if tp is not None else out
