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
the leaf, then one ``kernels.quantize_pack`` launch reads the segment in
place — a zero-copy contiguous slice — and writes its wire bytes at the
segment's byte offset of the leaf's buffer, and its tile moments, from
which ``w_q`` follows (the moment tiles restart at every segment, as the
reference's per-layer staging does). The reference concatenated a dtype
group into one staging buffer and gave each kernel block its own
(denom, Δ) row; one launch per segment reads the leaf without a staging
copy. A segment of ``n % 4 ≠ 0`` elements ends mid-byte on the wire, so a
ragged stacked leaf is re-aligned on the host (``_repack_ragged``). Wire
bytes and scales reach the host once per leaf, after every launch.

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
from repro_torch.kernels.quantize_pack import quantize_pack, scale_from_moments
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
        delta = fttq.row_threshold(rows / denom, cfg.t_k, cfg.threshold_rule)
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


def _launch(it: _Item):
    """Every segment of one leaf through the kernel; stays on the device."""
    leaf = it.leaf.detach().contiguous()
    n_seg = leaf.shape[0] if it.stacked else 1
    rows = leaf.reshape(n_seg, -1)
    denom, delta = segment_scalars(rows, it.mode, it.cfg)
    scal = torch.cat([denom, delta], dim=1).to(torch.float32)
    seg_bytes = packed_nbytes(rows.shape[1])
    buf = torch.empty(n_seg * seg_bytes, dtype=torch.uint8, device=leaf.device)
    scales = []
    for i in range(n_seg):
        _, moments = quantize_pack(rows[i], scal[i],
                                   out=buf[i * seg_bytes:(i + 1) * seg_bytes])
        if it.mode != "payload":
            scales.append(scale_from_moments(moments, denom[i, 0]))
    if it.mode == "payload":
        w_q = it.wq.detach()
    elif it.stacked:
        w_q = torch.stack(scales).to(leaf.dtype).reshape(
            (n_seg,) + (1,) * (leaf.ndim - 1))
    else:
        w_q = scales[0].to(leaf.dtype)
    return buf, w_q, n_seg, rows.shape[1]


def _encode_items(items: Sequence[_Item]) -> list[TernaryTensor]:
    """Launch every leaf, then bring each leaf's bytes and scale to the
    host. Output order matches input."""
    launched = [_launch(it) for it in items]
    out = []
    for it, (buf, w_q, n_seg, layer_n) in zip(items, launched):
        packed = buf.cpu()
        if n_seg > 1 and layer_n % 4:
            packed = torch.from_numpy(_repack_ragged(packed.numpy(), n_seg, layer_n))
        out.append(TernaryTensor(packed=packed, w_q=w_q.cpu(),
                                 shape=tuple(it.leaf.shape),
                                 dtype=dtype_name(it.leaf.dtype)))
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
