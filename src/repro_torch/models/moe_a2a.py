"""Expert-parallel MoE over an all-to-all (port of ``repro.models.moe_a2a``).

The scatter dispatch of ``models/moe.py`` computes every expert on every
rank. Here the ranks of an expert-parallel (EP) subgroup each own
E / n_ep experts, and only the k routed copies of each token move:

  per rank (T_loc tokens, E_loc = E / n_ep experts):
    1. route locally; a copy's destination is expert // E_loc;
    2. scatter into an (n_ep, C_send, D) send buffer, with an int32 buffer
       holding each slot's local expert index (0 = empty);
    3. tiled all-to-all over the EP subgroup (both buffers);
    4. regroup by local expert into (E_loc, C_loc, D), batched expert GEMMs;
    5. all-to-all back, gather and gate-weighted combine.

Capacity is GShard's per queue: C_send = T_loc·k / n_ep · cf per
(source, destination) pair and C_loc = n_ep·C_send / E_loc per local
expert; copies past a queue's capacity are dropped. With ``wire_dtype``
"int8" each slot crosses the wire as int8 with its own fp32 scale
(``quantized_all_to_all``; its backward sends the gradient back the same
way); "bf16" sends the activations as they are, in their own dtype, as the
reference does.

Each rank calls the layer with its own tokens (its rows of the batch) and
the expert stacks, whole or already cut to its own experts
(``expert_lo``: the first expert a stack holds); it computes the experts of
its EP index. The load-balancing loss is the global batch's, as the
scatter dispatch's is: the router's mean probabilities and top-1 fractions
are averaged over the batch subgroups (``data_groups``) before their
product (the reference averages each rank's product instead, which differs
wherever the ranks' routing does); the mean's backward passes the gradient
through unchanged, since the trainer averages the ranks' gradients.

Under tensor parallelism with the EP group the "model" axis (``tp``), every
rank of the group holds the same replicated tokens, routes them alike and
sends its copies, so an expert's owner computes each copy once per source,
as the reference's dispatch does. The output is then whole on every rank.
In the Megatron convention each rank's dL/dout is the whole gradient, so a
plain backward would give every expert weight n_ep times its gradient: the
returned copies' gradient is scaled by 1/n_ep (``_ScaleGrad``, the
identity forward), and the dispatched tokens enter through
``copy_to_model``, so the ranks' n_ep partial gradients of x sum to the
whole one. The router and gates take their gradients from the combine,
unscaled, complete and equal on every rank. The shared experts are column-
then row-parallel over "model" where their specs cut them (``shared_tp``),
as in ``models.moe``. The
collectives are ``parallel.collectives``'s (``dist.all_to_all_single`` over
the EP subgroup, staged through host memory for ``gloo`` on a GPU); with
no subgroup (one rank) they are the identity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import act_fn
from repro_torch.models.moe import route
from repro_torch.parallel.collectives import all_reduce_, all_to_all, group_rank, group_size
from repro_torch.parallel.tensor import copy_to_model, reduce_from_model


_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


def _q8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-slot int8 codes and fp32 scales: s = max|x| / 127 over the last
    dim (at least 1e-12), q = clip(round(x / s), ±127), rounding half to
    even as ``jnp.round`` does. XLA compiles the reference's division by
    the constant 127 into a product with its fp32 reciprocal (under ``jit``
    and ``shard_map``, where the reference always runs it), so s is that
    product here too, bit for bit."""
    s = x.abs().amax(dim=-1, keepdim=True).to(torch.float32) * _INV_127
    s = torch.clamp_min(s, 1e-12)
    q = torch.clamp(torch.round(x.to(torch.float32) / s), -127, 127).to(torch.int8)
    return q, s


def _exchange_q8(x: torch.Tensor, group) -> torch.Tensor:
    q, s = _q8(x)
    qq = all_to_all(q, group)
    ss = all_to_all(s, group)
    return (qq.to(torch.float32) * ss).to(x.dtype)


class _QuantizedAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange_q8(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange_q8(g, ctx.group), None


def quantized_all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """The tiled all-to-all along dim 0 with an int8 wire: every slot (last
    dim) quantized with its own scale, dequantized on arrival. The backward
    quantizes the incoming gradient and sends it back the same way (the
    tiled all-to-all is its own transpose)."""
    return _QuantizedAllToAll.apply(x, group)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), ctx.group), None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class _BatchMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group, mean=True)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _fill_queue(values: torch.Tensor, dest: torch.Tensor, keep_mask: torch.Tensor,
                n_queues: int, capacity: int, extra: torch.Tensor | None = None):
    """Scatter ``values`` (N, ...) into (n_queues, capacity, ...) by ``dest``
    (N,): a kept value's slot is its rank among the kept values of its
    queue, in order. Returns (buffer, int32 buffer of ``extra`` or None,
    slot, keep). The reference ranks the masked-out values too (the empty
    slots of the received buffer, all sent to queue 0), so there a local
    expert 0's copies from a later source land past its capacity and are
    dropped even at drop-free capacity; here they are not counted."""
    n = dest.shape[0]
    onehot = F.one_hot(dest, n_queues).to(torch.int32) * keep_mask[:, None].to(torch.int32)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1) - 1
    keep = keep_mask & (pos < capacity)
    safe_pos = torch.where(keep, pos, 0)
    safe_dest = torch.where(keep, dest, 0)
    kept = torch.where(keep.reshape((n,) + (1,) * (values.ndim - 1)), values, 0)
    buf = torch.zeros((n_queues, capacity) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device).index_put((safe_dest, safe_pos), kept,
                                                      accumulate=True)
    ebuf = None
    if extra is not None:
        ebuf = torch.zeros((n_queues, capacity), dtype=torch.int32, device=values.device)
        ebuf.view(-1).scatter_reduce_(0, safe_dest * capacity + safe_pos,
                                      torch.where(keep, extra, 0).to(torch.int32), "amax")
    return buf, ebuf, safe_pos, keep


def _up8(n: int) -> int:
    return -(-n // 8) * 8


def moe_a2a(params: dict, x: torch.Tensor, *, top_k: int, n_experts: int,
            capacity_factor: float = 1.25, activation: str = "silu", ep_group=None,
            data_groups: tuple = (), wire_dtype: str = "bf16", expert_lo: int = 0,
            tp=None, shared_tp=None):
    """x: (B_loc, S, D) this rank's tokens → (out, aux loss). ``params``
    holds the layer's expert stacks from expert ``expert_lo`` on (0: whole
    stacks); this rank computes experts [i·E_loc, (i + 1)·E_loc) of its EP
    index i. ``tp``: the "model" ``MeshAxis`` where it is the EP group (the
    tokens replicated over it; see the module docstring); ``shared_tp``: the
    axis the shared experts are column/row-parallel over, or None."""
    if wire_dtype not in ("bf16", "int8"):
        raise ValueError(f"moe_a2a: wire_dtype {wire_dtype!r} is not 'bf16' or 'int8'")
    act = act_fn(activation)
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    n_ep = group_size(ep_group)
    if n_experts % n_ep:
        raise ValueError(f"moe_a2a: {n_experts} experts do not split over {n_ep} ranks")
    e_loc = n_experts // n_ep
    e0 = group_rank(ep_group) * e_loc - expert_lo
    if e0 < 0 or e0 + e_loc > params["w_in"].shape[-3]:
        raise ValueError(f"moe_a2a: experts [{e0 + expert_lo}, {e0 + expert_lo + e_loc}) of "
                         f"EP rank {group_rank(ep_group)} are not in the stacks, which hold "
                         f"[{expert_lo}, {expert_lo + params['w_in'].shape[-3]})")

    # 1. local routing (the router is replicated)
    logits = (xt @ params["router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = route(probs, top_k)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    means = torch.stack([probs.mean(dim=0),
                         F.one_hot(idx[:, 0], n_experts).to(torch.float32).mean(dim=0)])
    for g in data_groups:
        if g is not None:
            means = _BatchMean.apply(means, g)
    aux = n_experts * torch.sum(means[0] * means[1])

    # 2. per-destination send queues
    flat_e = idx.reshape(-1)
    tok_id = torch.arange(t, device=x.device).repeat_interleave(top_k)
    dest = flat_e // e_loc
    c_send = _up8(max(int(t * top_k / n_ep * capacity_factor), top_k))
    xd = copy_to_model(xt, tp) if tp is not None else xt
    send, send_e, pos_send, keep = _fill_queue(
        xd[tok_id], dest, torch.ones_like(dest, dtype=torch.bool), n_ep, c_send,
        extra=flat_e % e_loc + 1)

    # 3. the all-to-all over the EP subgroup (the only cross-rank traffic)
    exchange = quantized_all_to_all if wire_dtype == "int8" else _AllToAll.apply
    recv = exchange(send, ep_group)
    recv_e = all_to_all(send_e, ep_group)

    # 4. regroup by local expert (no second capacity factor), grouped GEMMs
    rflat = recv.reshape(n_ep * c_send, d)
    reflat = recv_e.reshape(n_ep * c_send)
    c_loc = min(_up8(max(int(n_ep * c_send / e_loc), 8)), n_ep * c_send)
    local_e = torch.clamp_min(reflat - 1, 0).to(torch.int64)
    buf, _, pos_loc, keep_loc = _fill_queue(rflat, local_e, reflat > 0, e_loc, c_loc)
    experts = {k: params[k][e0:e0 + e_loc] for k in ("w_in", "w_gate", "w_out")}
    h = torch.einsum("ecd,edf->ecf", buf, experts["w_in"])
    g = torch.einsum("ecd,edf->ecf", buf, experts["w_gate"])
    out_e = torch.einsum("ecf,efd->ecd", act(g) * h, experts["w_out"])

    # 5. the return trip and the combine
    safe_e = torch.where(keep_loc, local_e, 0)
    gathered = out_e[safe_e, torch.where(keep_loc, pos_loc, 0)]
    back = torch.where(keep_loc[:, None], gathered, 0).reshape(n_ep, c_send, d)
    res = exchange(back, ep_group)
    if tp is not None:  # each copy came from n_ep sources: see the module docstring
        res = _ScaleGrad.apply(res, 1.0 / n_ep)
    per_copy = res[torch.where(keep, dest, 0), torch.where(keep, pos_send, 0)]
    per_copy = torch.where(keep[:, None], per_copy, 0)
    combined = torch.zeros((t, d), dtype=x.dtype, device=x.device).index_add(
        0, tok_id, (per_copy * gates.reshape(-1)[:, None]).to(x.dtype))

    if "shared" in params:
        sp = params["shared"]
        xs = copy_to_model(xt, shared_tp) if shared_tp is not None else xt
        shared = (act(xs @ sp["w_gate"]) * (xs @ sp["w_in"])) @ sp["w_out"]
        combined = combined + (reduce_from_model(shared, shared_tp) if shared_tp is not None
                               else shared)
    return combined.reshape(b, s, d), aux.to(torch.float32)
