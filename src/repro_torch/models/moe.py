"""Mixture-of-Experts layer on one device (port of ``repro.models.moe``):
top-k token-choice routing, the Switch load-balancing loss, capacity-bounded
scatter dispatch, batched expert GEMMs, the gate-weighted combine and the
optional shared experts (DeepSeekMoE).

Dispatch follows the reference step by step: each selected (token, expert)
copy takes the slot given by its rank within the expert's queue (a cumsum
over the one-hot routing, in token-major order); copies past the capacity
C are dropped (GShard semantics). Ties in the router probabilities keep the
lower expert index first, as ``jax.lax.top_k`` does.

Under tensor parallelism (``tp``, a ``parallel.tensor.MeshAxis``, with the
layer's "model" ``dims``) the tokens are whole on every rank of the axis.
Every rank routes them alike (router, softmax, top-k, the aux loss, the
capacity and the dispatch are the one device's), then scatters only the
copies routed to its own experts, ``[lo, hi)`` of E, into an (E / size, C,
D) buffer, runs its expert shards and combines its copies. The shared
experts are column- then row-parallel, as ``models.mlp`` is. The two
partial outputs are summed and reduced over the axis once. The tokens enter
the per-rank experts through ``copy_to_model``, and so do the gates where
they enter the combine: the router's gradient through the combine is summed
over the ranks, while its aux-loss part, the same on every rank, is not. A
stack the divisibility guard left whole is computed whole on every rank and
takes no part in the reduce.

Over data-parallel ranks (``dp``, ``parallel.tensor.BatchAxes``) the rows
of all ranks are one batch, as in the reference's GSPMD step: the capacity
is the global batch's, a copy's slot counts the copies routed to its expert
by the ranks before it (its rank in the global token-major queue), and the
load loss takes the global means (``mean_over_batch``).

Under FSDP the router and expert stacks are also cut on D over "data";
``models.transformer`` gathers them (``parallel.tensor.gather_layer``)
before the layer, so this module sees them whole over "data" and its
routing, ``BatchAxes`` and local experts are as above.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import act_fn, dense_init
from repro_torch.parallel.tensor import copy_to_model, mean_over_batch, reduce_from_model


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


def dispatch(idx: torch.Tensor, n_experts: int, capacity: int, dp=None):
    """Each (token, k) copy's expert, slot and keep flag, flat in
    token-major order: the slot is the copy's rank within its expert,
    behind the copies of the ranks before this one over ``dp``."""
    flat_e = idx.reshape(-1)
    onehot = F.one_hot(flat_e, n_experts).to(torch.int32)
    pos = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=-1)
    if dp is not None:
        before = dp.gather(onehot.sum(dim=0))[:dp.index].sum(dim=0)
        pos = pos + before[flat_e]
    return flat_e, pos, pos < capacity


def split_axis(tp, dims, *keys):
    """``tp`` where ``dims`` (a layer's "model" dims) shards the leaf at
    ``keys``, else None."""
    for k in keys:
        dims = dims.get(k) if isinstance(dims, dict) else None
    return tp if tp is not None and dims is not None else None


def moe(params: dict, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
        activation: str = "silu", tp=None, dims: dict | None = None, dp=None
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (out (B, S, D), aux loss, a float32 scalar). ``tp``
    and ``dims`` (the layer's "model" dim per leaf, None where whole): the
    params are this rank's shards; ``dp``: the ranks whose rows make one
    batch with ``x`` (see the module docstring)."""
    act = act_fn(activation)
    b, s, d = x.shape
    e = params["router"].shape[-1]
    t = b * s
    xt = x.reshape(t, d)
    ep = split_axis(tp, dims, "w_in")
    stp = split_axis(tp, dims, "shared", "w_in")
    # the tokens as the per-rank experts take them
    xs = copy_to_model(xt, tp) if ep is not None or stp is not None else xt

    logits = (xt @ params["router"]).to(torch.float32)             # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = route(probs, top_k)                                 # (T, k)
    gates = gates / gates.sum(dim=-1, keepdim=True)

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(dim=0)
    ce = F.one_hot(idx[:, 0], e).to(torch.float32).mean(dim=0)
    if dp is not None:
        me, ce = mean_over_batch(me, dp), mean_over_batch(ce, dp)
    aux = e * torch.sum(me * ce)

    capacity = capacity_of(t * (dp.size if dp is not None else 1), top_k, e, capacity_factor)
    flat_e, pos, keep = dispatch(idx, e, capacity, dp)
    tok_id = torch.arange(t, device=x.device).repeat_interleave(top_k)
    if ep is not None:
        lo, hi = ep.share(e)
        keep = keep & (flat_e >= lo) & (flat_e < hi)
        flat_e = torch.where(keep, flat_e - lo, 0)
        gates = copy_to_model(gates, ep)
    safe_pos = torch.where(keep, pos, 0)
    src = xs if ep is not None else xt
    updates = torch.where(keep[:, None], src[tok_id], 0).to(x.dtype)
    buf = torch.zeros((params["w_in"].shape[-3], capacity, d), dtype=x.dtype, device=x.device)
    buf.index_put_((flat_e, safe_pos), updates, accumulate=True)

    h = torch.einsum("ecd,edf->ecf", buf, params["w_in"])
    g = torch.einsum("ecd,edf->ecf", buf, params["w_gate"])
    out_e = torch.einsum("ecf,efd->ecd", act(g) * h, params["w_out"])   # (E, C, D)

    res = torch.where(keep[:, None], out_e[flat_e, safe_pos], 0)      # (T·k, D)
    routed = torch.zeros((t, d), dtype=x.dtype, device=x.device).index_add_(
        0, tok_id, (res * gates.reshape(-1)[:, None]).to(x.dtype))

    partial, whole = (routed, None) if ep is not None else (None, routed)
    if "shared" in params:
        sp = params["shared"]
        src = xs if stp is not None else xt
        hs = act(src @ sp["w_gate"]) * (src @ sp["w_in"])
        shared = hs @ sp["w_out"]
        if stp is not None:
            partial = shared if partial is None else partial + shared
        else:
            whole = shared if whole is None else whole + shared
    if partial is not None:
        partial = reduce_from_model(partial, tp)
        whole = partial if whole is None else whole + partial
    return whole.reshape(b, s, d), aux.to(torch.float32)
