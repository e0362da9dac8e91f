"""Fused egress encode: a batch of leaves → ternary wire tensors.

Port of the codec mode of ``repro.core.encode`` (``encode_codec_leaves_fused``
via ``_encode_items``). Every leaf is one segment with a whole-leaf scale,
as in the codec reference: per leaf, ``denom = max|θ| + 1e-8`` and
``Δ = t_k · mean(|θ / denom|)`` are reduced on the leaf's device, then one
``kernels.quantize_pack`` launch reads the leaf in place and writes its wire
bytes and tile moments, and ``w_q`` follows from the moments. Packed bytes
and scales come to the host once, after every launch of the batch.

The trained-factor ("payload") and fixed-Δ ("server") modes arrive with
the federated slice.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import fttq
from repro_torch.core.ternary import TernaryTensor
from repro_torch.dtypes import dtype_name
from repro_torch.kernels.quantize_pack import quantize_pack, scale_from_moments


def leaf_scalars(leaf: torch.Tensor, cfg: fttq.FTTQConfig
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(scal = (denom, Δ) as (2,) fp32, denom in the leaf's dtype)."""
    denom = fttq.abs_max(leaf) + fttq._EPS
    delta = fttq.fttq_threshold(fttq.scale_layer(leaf, denom), cfg.t_k,
                                cfg.threshold_rule)
    return torch.stack([denom, delta]).to(torch.float32), denom


def _encode_items(leaves: Sequence[torch.Tensor], cfg: fttq.FTTQConfig
                  ) -> list[TernaryTensor]:
    """One kernel launch per leaf; one host copy per output after the
    last launch. Output order matches input."""
    on_device = []
    for leaf in leaves:
        scal, denom = leaf_scalars(leaf, cfg)
        packed, moments = quantize_pack(leaf.contiguous(), scal)
        on_device.append((packed, scale_from_moments(moments, denom).to(leaf.dtype)))
    return [
        TernaryTensor(packed=packed.cpu(), w_q=w_q.cpu(),
                      shape=tuple(leaf.shape), dtype=dtype_name(leaf.dtype))
        for leaf, (packed, w_q) in zip(leaves, on_device)
    ]


def encode_codec_leaves_fused(leaves: Sequence[torch.Tensor], spec) -> list[TernaryTensor]:
    """``TernaryCodec`` encode over a BATCH of raw leaves (the
    ``compress_pytree`` pre-pass): whole-leaf scale regardless of ndim."""
    return _encode_items(leaves, spec.fttq)
