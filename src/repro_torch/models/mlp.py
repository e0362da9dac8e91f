"""Dense feed-forward blocks: gated (SwiGLU/GeGLU) and plain (port of
``repro.models.mlp``)."""

from __future__ import annotations

import torch

from repro_torch.models.common import act_fn, dense_init, matmul


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


def mlp(params: dict, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    act = act_fn(activation)
    h = matmul(x, params["w_in"])
    if "w_gate" in params:
        h = act(matmul(x, params["w_gate"])) * h
    else:
        h = act(h)
    return matmul(h, params["w_out"])
