"""Fused egress encode: quantizable leaves → ternary wire tensors.

Port of ``repro.core.encode``, in its three modes:

  - payload (``client_payload_fused``, the client upload): Δ from the
    config's threshold rule, the trained w_q carried as-is;
  - server (``requantize_fused``, the server broadcast): fixed
    Δ = ``server_delta``, w_q from the same pass's tile moments;
  - codec (``encode_codec_leaves_fused``, ``TernaryCodec``): Δ from the
    threshold rule, w_q from the moments, one whole-leaf scale.

A leaf is encoded as segments: a stacked leaf (ndim ≥ 3 with a per-layer
factor, e.g. an HWIO conv weight with one factor per kernel row) has one
segment per leading index, every other leaf is one segment. Per segment,
``denom = max|θ| + 1e-8`` and Δ come from one batched row reduction over
the leaf. Then each dtype group of the tree (fp32, bf16) goes through ONE
``kernels.quantize_pack_segments`` launch, as the reference drives a dtype
group through one kernel call: a segment table lists every segment of
every leaf of the group (a zero-copy contiguous slice, read in place), its
(denom, Δ) row and the byte offset of its wire bytes in one buffer. A bf16
leaf is encoded in bf16, and its kernel-formed w_q is cast back to bf16. In server and
codec modes the same launch forms every segment's w_q from its tile
moments (the moment tiles restart at every segment, as the reference's
per-layer staging does). The tree's wire bytes and scales (and, in payload
mode, the trained factors) reach the host in one device-to-host copy. A
segment of ``n % 4 ≠ 0`` elements ends mid-byte on the wire, so a ragged
stacked leaf is re-aligned on the host (``_repack_ragged``).

Codes and framing are byte-identical to the reference's; a kernel-computed
scale differs from the reference's in the last bits only, because the tile
sums run in another order (see ROADMAP Queue 3).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import fttq
from repro_torch.core.ternary import TernaryTensor, packed_nbytes
from repro_torch.dtypes import dtype_name
from repro_torch.kernels.quantize_pack import quantize_pack_segments
from repro_torch.tree import flatten_with_path, tree_map_with_path

Pytree = Any


@dataclasses.dataclass
class _Item:
    leaf: torch.Tensor
    mode: str                 # "payload" | "server" | "codec"
    cfg: fttq.FTTQConfig
    wq: Any = None            # the trained factor (payload mode)
    stacked: bool = False


def segment_scalars(rows: torch.Tensor, mode: str, cfg: fttq.FTTQConfig
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(denom, Δ) per segment row of a (L, m) leaf view, each (L, 1) in the
    leaf's dtype: Δ is ``server_delta`` in server mode, else the config's
    threshold rule on the scaled row."""
    denom = fttq.row_denom(rows)
    if mode == "server":
        delta = torch.full_like(denom, cfg.server_delta)
    else:
        delta = fttq.row_threshold(fttq.scaled_abs(rows, denom), cfg.t_k, cfg.threshold_rule)
    return denom, delta


def leaf_scalars(leaf: torch.Tensor, cfg: fttq.FTTQConfig
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-leaf (scal = (denom, Δ) as (2,) fp32, denom in the leaf's
    dtype), Δ by the threshold rule."""
    denom, delta = segment_scalars(leaf.reshape(1, -1), "codec", cfg)
    return torch.cat([denom, delta], dim=1).to(torch.float32)[0], denom[0, 0]


def _repack_ragged(packed_np: np.ndarray, n_layers: int, layer_n: int) -> np.ndarray:
    """The flat wire stream of a stacked leaf whose layer size is not a
    multiple of 4, from per-layer packed planes: unpack each layer's first
    ``layer_n`` codes, concatenate, pad with code 1 (value 0) and repack."""
    per = packed_np.reshape(n_layers, -1)[:, : (layer_n + 3) // 4]
    codes = np.empty((n_layers, per.shape[1] * 4), dtype=np.uint8)
    for j in range(4):
        codes[:, j::4] = (per >> (2 * j)) & 3
    codes = codes[:, :layer_n].reshape(-1)
    pad = (-codes.size) % 4
    if pad:
        codes = np.concatenate([codes, np.ones(pad, dtype=np.uint8)])
    q = codes.reshape(-1, 4)
    return (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)).astype(np.uint8)


def _segments(it: _Item) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The (n_seg, m) segment rows of one leaf and their (denom, Δ) rows as
    (n_seg, 2) fp32."""
    leaf = it.leaf.detach().contiguous()
    n_seg = leaf.shape[0] if it.stacked else 1
    rows = leaf.reshape(n_seg, -1)
    denom, delta = segment_scalars(rows, it.mode, it.cfg)
    return rows, torch.cat([denom, delta], dim=1).to(torch.float32), n_seg


def _encode_items(items: Sequence[_Item]) -> list[TernaryTensor]:
    """Every segment of every leaf through one kernel launch per dtype
    group, then the bytes and scales to the host in one copy. Items share
    one mode and one device; output order matches input."""
    if not items:
        return []
    mode = items[0].mode
    groups: dict[torch.dtype, list[int]] = {}
    for k, it in enumerate(items):
        groups.setdefault(it.leaf.dtype, []).append(k)
    order = [k for ks in groups.values() for k in ks]      # the buffer's order
    segs = {k: _segments(items[k]) for k in order}
    group_rows = [[segs[k][0][i] for k in ks for i in range(segs[k][2])]
                  for ks in groups.values()]
    group_scal = [torch.cat([segs[k][1] for k in ks]) for ks in groups.values()]
    n_scales = 0 if mode == "payload" else sum(s.shape[0] for s in group_scal)
    wqs = {k: items[k].wq.detach() for k in order} if mode == "payload" else {}
    n_wq = sum(w.numel() for w in wqs.values())
    group_bytes = [sum(packed_nbytes(r.numel()) for r in rows) for rows in group_rows]
    nbytes = sum(group_bytes)
    at = -(-nbytes // 4) * 4                     # scales and factors start 4-aligned
    buf = torch.empty(at + 4 * (n_scales + n_wq), dtype=torch.uint8,
                      device=group_scal[0].device)
    floats = buf[at:].view(torch.float32)
    b0 = s0 = 0
    for rows, scal, nb in zip(group_rows, group_scal, group_bytes):
        _, _, scales = quantize_pack_segments(rows, scal, out=buf[b0:b0 + nb],
                                              with_scales=mode != "payload")
        if n_scales:
            floats[s0:s0 + scal.shape[0]].copy_(scales)
        b0, s0 = b0 + nb, s0 + scal.shape[0]
    if wqs:
        floats[n_scales:].copy_(torch.cat([w.reshape(-1).to(torch.float32)
                                           for w in wqs.values()]))
    host = buf.cpu()
    host_floats = host[at:].view(torch.float32)

    out: list = [None] * len(items)
    byte0, seg0, wq0 = 0, 0, n_scales
    for k in order:
        it, (r, _, n_seg) = items[k], segs[k]
        leaf = it.leaf
        layer_n = r.shape[1]
        size = n_seg * packed_nbytes(layer_n)
        packed = host[byte0:byte0 + size]
        byte0 += size
        if n_seg > 1 and layer_n % 4:
            packed = torch.from_numpy(_repack_ragged(packed.numpy(), n_seg, layer_n))
        if mode == "payload":
            w = wqs[k]
            w_q = host_floats[wq0:wq0 + w.numel()].reshape(w.shape).to(w.dtype)
            wq0 += w.numel()
        elif it.stacked:
            w_q = host_floats[seg0:seg0 + n_seg].to(leaf.dtype).reshape(
                (n_seg,) + (1,) * (leaf.ndim - 1))
        else:
            w_q = host_floats[seg0].to(leaf.dtype)
        seg0 += n_seg
        out[k] = TernaryTensor(packed=packed, w_q=w_q, shape=tuple(leaf.shape),
                               dtype=dtype_name(leaf.dtype))
    return out


def _encode_tree(params: Pytree, picks: dict, mode: str, cfg: fttq.FTTQConfig) -> Pytree:
    """Encode the leaves of ``params`` named in ``picks`` (path → (wq,
    stacked)); the rest pass through."""
    items, paths = [], []
    for path, leaf in flatten_with_path(params):
        if path in picks:
            wq, stacked = picks[path]
            items.append(_Item(leaf=leaf, mode=mode, cfg=cfg, wq=wq, stacked=stacked))
            paths.append(path)
    encoded = dict(zip(paths, _encode_items(items)))
    return tree_map_with_path(lambda p, leaf: encoded.get(p, leaf), params)


def client_payload_fused(params: Pytree, wq_tree: Pytree, cfg: fttq.FTTQConfig) -> Pytree:
    """Fused ``core.tfedavg.client_update_payload``: every leaf with a
    trained factor becomes a ternary wire tensor carrying that factor."""
    leaves = dict(flatten_with_path(params))
    picks = {p: (wq, fttq._is_stacked(leaves[p], wq)) for p, wq in flatten_with_path(wq_tree)}
    return _encode_tree(params, picks, "payload", cfg)


def requantize_fused(global_params: Pytree, cfg: fttq.FTTQConfig,
                     wq_tree: Pytree | None = None) -> Pytree:
    """Fused ``core.tfedavg.server_requantize``: fixed Δ = server_delta on
    scaled weights, the broadcast scale from the same pass's moments. The
    leaves and their segments follow ``wq_tree``, or by default the policy
    of ``fttq.init_wq_tree`` (quantizable leaves; ndim ≥ 3 per layer)."""
    if wq_tree is None:
        picks = {path: (None, leaf.ndim >= 3)
                 for path, leaf in flatten_with_path(global_params)
                 if fttq.is_quantizable(path, leaf, cfg)}
    else:
        leaves = dict(flatten_with_path(global_params))
        picks = {p: (None, fttq._is_stacked(leaves[p], wq))
                 for p, wq in flatten_with_path(wq_tree)}
    return _encode_tree(global_params, picks, "server", cfg)


def encode_codec_leaves_fused(leaves: Sequence[torch.Tensor], spec) -> list[TernaryTensor]:
    """``TernaryCodec`` encode over a BATCH of raw leaves (the
    ``compress_pytree`` pre-pass): whole-leaf scale regardless of ndim."""
    return _encode_items([_Item(leaf=leaf, mode="codec", cfg=spec.fttq) for leaf in leaves])
