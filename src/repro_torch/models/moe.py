"""Mixture-of-Experts layer on one device (port of ``repro.models.moe``):
top-k token-choice routing, the Switch load-balancing loss, capacity-bounded
scatter dispatch, batched expert GEMMs, the gate-weighted combine and the
optional shared experts (DeepSeekMoE).

Dispatch follows the reference step by step: each selected (token, expert)
copy takes the slot given by its rank within the expert's queue (a cumsum
over the one-hot routing, in token-major order); copies past the capacity
C are dropped (GShard semantics). Ties in the router probabilities keep the
lower expert index first, as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import act_fn, dense_init


def init_moe(gen: torch.Generator, d_model: int, moe_d_ff: int, n_experts: int,
             n_shared_experts: int, shared_d_ff: int, dtype,
             n_layers: int | None = None):
    """Router and expert weights, stacked (n_layers, ...) unless
    ``n_layers`` is None."""
    lead = () if n_layers is None else (n_layers,)
    p = {
        "router": dense_init(gen, lead + (d_model, n_experts), dtype),
        "w_gate": dense_init(gen, lead + (n_experts, d_model, moe_d_ff), dtype),
        "w_in": dense_init(gen, lead + (n_experts, d_model, moe_d_ff), dtype),
        "w_out": dense_init(gen, lead + (n_experts, moe_d_ff, d_model), dtype),
    }
    if n_shared_experts > 0:
        p["shared"] = {
            "w_gate": dense_init(gen, lead + (d_model, shared_d_ff), dtype),
            "w_in": dense_init(gen, lead + (d_model, shared_d_ff), dtype),
            "w_out": dense_init(gen, lead + (shared_d_ff, d_model), dtype),
        }
    return p


def capacity_of(n_tokens: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    """Slots per expert: the reference's expression, rounded up to a
    multiple of 256 from 256 on, so both packages drop the same copies."""
    capacity = max(int(n_tokens * top_k / n_experts * capacity_factor), top_k)
    if capacity >= 256:
        capacity = -(-capacity // 256) * 256
    return capacity


def route(probs: torch.Tensor, top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(gates, idx) of the ``top_k`` largest probabilities per row, largest
    first, ties to the lower index (a stable descending sort)."""
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :top_k]
    return torch.gather(probs, 1, order), order


def dispatch(idx: torch.Tensor, n_experts: int, capacity: int):
    """Each (token, k) copy's expert, slot and keep flag, flat in
    token-major order: the slot is the copy's rank within its expert."""
    flat_e = idx.reshape(-1)
    onehot = F.one_hot(flat_e, n_experts).to(torch.int32)
    pos = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=-1)
    return flat_e, pos, pos < capacity


def moe(params: dict, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
        activation: str = "silu") -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (out (B, S, D), aux loss, a float32 scalar)."""
    act = act_fn(activation)
    b, s, d = x.shape
    e = params["router"].shape[-1]
    t = b * s
    xt = x.reshape(t, d)

    logits = (xt @ params["router"]).to(torch.float32)             # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = route(probs, top_k)                                 # (T, k)
    gates = gates / gates.sum(dim=-1, keepdim=True)

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(dim=0)
    ce = F.one_hot(idx[:, 0], e).to(torch.float32).mean(dim=0)
    aux = e * torch.sum(me * ce)

    capacity = capacity_of(t, top_k, e, capacity_factor)
    flat_e, pos, keep = dispatch(idx, e, capacity)
    tok_id = torch.arange(t, device=x.device).repeat_interleave(top_k)
    safe_pos = torch.where(keep, pos, 0)
    updates = torch.where(keep[:, None], xt[tok_id], 0).to(x.dtype)
    buf = torch.zeros((e, capacity, d), dtype=x.dtype, device=x.device)
    buf.index_put_((flat_e, safe_pos), updates, accumulate=True)

    h = torch.einsum("ecd,edf->ecf", buf, params["w_in"])
    g = torch.einsum("ecd,edf->ecf", buf, params["w_gate"])
    out_e = torch.einsum("ecf,efd->ecd", act(g) * h, params["w_out"])   # (E, C, D)

    res = torch.where(keep[:, None], out_e[flat_e, safe_pos], 0)      # (T·k, D)
    combined = torch.zeros((t, d), dtype=x.dtype, device=x.device).index_add_(
        0, tok_id, (res * gates.reshape(-1)[:, None]).to(x.dtype))

    if "shared" in params:
        sp = params["shared"]
        hs = act(xt @ sp["w_gate"]) * (xt @ sp["w_in"])
        combined = combined + hs @ sp["w_out"]
    return combined.reshape(b, s, d), aux.to(torch.float32)
