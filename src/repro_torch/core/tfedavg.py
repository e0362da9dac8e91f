"""T-FedAvg — Ternary Federated Averaging (paper §III.B, Algorithm 2).

Port of ``repro.core.tfedavg``. A round:
  1. UPSTREAM — each selected client trains with FTTQ (QAT) and uploads
     {I_t packed 2-bit, w_q per layer}; non-quantized leaves ship fp32.
  2. AGGREGATE — θ_{r+1} = Σ_k |D_k| / Σ|D_k| · θ_k^t over the dequantized
     client models (``server_aggregate`` here is the list-based reference;
     the servers stream blobs through ``fed.aggregator.Aggregator``).
  3. DOWNSTREAM — the server re-quantizes with the FIXED threshold
     Δ = server_delta and broadcasts codes + the optimal scale.

``client_update_payload`` and ``server_requantize`` take ``fused=True``
(the quantize→pack kernel, ``core.encode``) or ``fused=False`` (the
per-leaf reference chain ``reference_leaf``: scale → threshold →
ternarize → ``pack2bit``, with the scale from the plain tile moments).
Both give the same wire bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import fttq
from repro_torch.core.encode import segment_scalars
from repro_torch.core.ternary import TernaryTensor, encode_ternary
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.dtypes import dtype_name
from repro_torch.kernels.quantize_pack import moments_plain, scale_from_moments
from repro_torch.tree import flatten_with_path, tree_map, tree_map_with_path

Pytree = Any


@dataclasses.dataclass
class TernaryUpdate:
    """A client's upstream payload: ``payload`` is the tree with ternary wire
    leaves for quantized weights and raw tensors elsewhere; ``n_samples`` is
    |D_k|, the aggregation weight."""

    payload: Pytree
    n_samples: int
    client_id: int = -1


def reference_leaf(leaf: torch.Tensor, mode: str, cfg: fttq.FTTQConfig, wq=None,
                   stacked: bool = False) -> TernaryTensor:
    """The per-leaf reference chain for one quantizable leaf in ``mode``
    ("payload", "server" or "codec"; see ``core.encode``), per layer when
    ``stacked``."""
    leaf = leaf.detach()
    n_seg = leaf.shape[0] if stacked else 1
    rows = leaf.reshape(n_seg, -1)
    denom, delta = segment_scalars(rows, mode, cfg)
    i_t = fttq.scaled_codes(rows, denom, delta).reshape(leaf.shape)
    if mode == "payload":
        w_q = wq.detach()
    else:
        scal = torch.cat([denom, delta], dim=1).to(torch.float32)
        scales = torch.stack([scale_from_moments(moments_plain(rows[i], scal[i]), denom[i, 0])
                              for i in range(n_seg)]).to(leaf.dtype)
        w_q = (scales.reshape((n_seg,) + (1,) * (leaf.ndim - 1)) if stacked
               else scales.reshape(()))
    return encode_ternary(i_t, w_q, dtype=dtype_name(leaf.dtype))


def client_update_payload(params: Pytree, wq_tree: Pytree, cfg: fttq.FTTQConfig, *,
                          fused: bool = True) -> Pytree:
    """The upstream wire payload from trained latent params + w_q tree:
    leaves with a factor → ``TernaryTensor(I_t, w_q)``, others pass."""
    if fused:
        from repro_torch.core.encode import client_payload_fused

        return client_payload_fused(params, wq_tree, cfg)
    wqs = dict(flatten_with_path(wq_tree))

    def one(path, leaf):
        wq = wqs.get(path)
        if wq is None:
            return leaf
        return reference_leaf(leaf, "payload", cfg, wq, fttq._is_stacked(leaf, wq))

    return tree_map_with_path(one, params)


def server_aggregate(updates: list[TernaryUpdate],
                     device: str | torch.device = DEFAULT_DEVICE) -> Pytree:
    """θ_{r+1} = Σ_k |D_k|/Σ|D_k| · dequant(payload_k), the list-based
    reference: every client is dequantized to a dense tree on ``device``
    first, then folded in order."""
    from repro_torch.core.compression import decompress_pytree

    device = resolve_device(device)
    if not updates:
        raise ValueError("server_aggregate: no client updates survived the round")
    total = float(sum(u.n_samples for u in updates))
    # each weight rounds to fp32 before it multiplies, as a Python float
    # does in a jnp product
    weights = [float(np.float32(u.n_samples / total)) for u in updates]
    dense = [decompress_pytree(u.payload, device) for u in updates]
    leaves = [[leaf for _, leaf in flatten_with_path(d)] for d in dense]
    folded = []
    for per_client in zip(*leaves):
        acc = per_client[0] * weights[0]
        for w, leaf in zip(weights[1:], per_client[1:]):
            acc = acc + w * leaf
        folded.append(acc)
    it = iter(folded)
    return tree_map(lambda _: next(it), dense[0])


def server_requantize(global_params: Pytree, cfg: fttq.FTTQConfig,
                      wq_tree: Pytree | None = None, *, fused: bool = True) -> Pytree:
    """Downstream compression of the aggregated model: fixed
    Δ = ``cfg.server_delta`` on layer-wise scaled weights, with the
    broadcast scale at its Prop-4.1 optimum (mean |θ| over the selected
    positions), per layer for leaves with ndim ≥ 3."""
    if fused:
        from repro_torch.core.encode import requantize_fused

        return requantize_fused(global_params, cfg, wq_tree)
    if wq_tree is None:
        stacked = {p: leaf.ndim >= 3 for p, leaf in flatten_with_path(global_params)
                   if fttq.is_quantizable(p, leaf, cfg)}
    else:
        leaves = dict(flatten_with_path(global_params))
        stacked = {p: fttq._is_stacked(leaves[p], wq) for p, wq in flatten_with_path(wq_tree)}

    def one(path, leaf):
        if path not in stacked:
            return leaf
        return reference_leaf(leaf, "server", cfg, stacked=stacked[path])

    return tree_map_with_path(one, global_params)


# --------------------------------------------------------------------------
# Communication accounting (paper Table IV), measured from the wire.
# --------------------------------------------------------------------------


def fedavg_round_bytes(params: Pytree, n_participants: int) -> dict:
    """FP32 FedAvg per-round bytes (upload = download = n·|serialized θ|)."""
    from repro_torch.comm.wire import update_nbytes

    per_client = update_nbytes(params)
    return {"upload": per_client * n_participants,
            "download": per_client * n_participants, "per_client": per_client}


def tfedavg_round_bytes(params: Pytree, n_participants: int, cfg: fttq.FTTQConfig) -> dict:
    """T-FedAvg per-round bytes: serialized ternary wire both directions."""
    from repro_torch.comm.wire import update_nbytes

    per_client = update_nbytes(server_requantize(params, cfg))
    return {"upload": per_client * n_participants,
            "download": per_client * n_participants, "per_client": per_client}
