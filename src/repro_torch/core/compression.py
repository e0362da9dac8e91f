"""Codec registry and tree compression, the subset on the serving and
federated paths.

Port of ``repro.core.compression``: ``CodecSpec``, ``CompressionSpec``,
the ``none`` and ``ternary`` codecs, ``compress_pytree`` and
``decompress_pytree``. A codec turns one leaf into a wire leaf and back and
owns a wire record kind byte. The downcast and top-k codecs arrive with
their slice (naming one raises ``NotImplementedError``), and error
feedback with them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import fttq
from repro_torch.core.ternary import TernaryTensor
from repro_torch.dtypes import is_floating
from repro_torch.tree import flatten_with_path, tree_map, tree_map_with_path

Pytree = Any

# Wire record kind bytes (the framing contract with ``comm.wire``).
KIND_RAW = 0
KIND_TERNARY = 1

_NOT_PORTED = ("fp16", "bf16", "topk", "topk16")


class NoneCodec:
    name = "none"
    wire_kind = KIND_RAW
    leaf_type = None

    def encode_leaf(self, leaf, spec):
        return leaf

    def decode_leaf(self, wire_leaf, device="cpu"):
        return _to_tensor(wire_leaf, device)


class TernaryCodec:
    """The paper's FTTQ wire path (2-bit codes + one trained scale), with
    the whole-leaf scale of the codec reference. Leaves encode through the
    fused quantize→pack kernel (``core.encode``)."""

    name = "ternary"
    wire_kind = KIND_TERNARY
    leaf_type = TernaryTensor

    def encode_leaf(self, leaf, spec):
        return self.encode_leaves_batch([leaf], spec)[0]

    def encode_leaves_batch(self, leaves, spec):
        if not spec.fused_encode:
            from repro_torch.core.tfedavg import reference_leaf

            return [reference_leaf(leaf, "codec", spec.fttq) for leaf in leaves]
        from repro_torch.core.encode import encode_codec_leaves_fused

        return encode_codec_leaves_fused(leaves, spec)

    def decode_leaf(self, wire_leaf, device="cpu"):
        return wire_leaf.dequantize(device)


_CODECS = {c.name: c for c in (NoneCodec(), TernaryCodec())}


def get_codec(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(f"codec {name!r} is not ported yet")
    try:
        return _CODECS[name]
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r}; registered: {available_codecs()}"
        ) from None


def available_codecs() -> list[str]:
    return sorted(_CODECS)


def wire_leaf_types() -> tuple[type, ...]:
    return tuple(c.leaf_type for c in _CODECS.values() if c.leaf_type is not None)


def is_wire_leaf(x: Any) -> bool:
    return isinstance(x, wire_leaf_types())


def _to_tensor(leaf, device) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device)
    return torch.as_tensor(leaf, device=device)


def decode_wire_leaf(leaf: Any, device="cpu") -> torch.Tensor:
    """Decode any registered wire leaf to a dense tensor on ``device``."""
    for codec in _CODECS.values():
        if codec.leaf_type is not None and isinstance(leaf, codec.leaf_type):
            return codec.decode_leaf(leaf, device)
    return _to_tensor(leaf, device)


@dataclasses.dataclass(frozen=True)
class CodecSpec:
    """Codec selection for ONE direction of traffic.

    kind:     codec for quantizable (weight-like) leaves.
    residual: codec for the non-quantizable leaves (biases, norms, scalars).
    """

    kind: str = "ternary"
    residual: str = "none"
    fttq: fttq.FTTQConfig = dataclasses.field(default_factory=fttq.FTTQConfig)
    # True → ternary leaves encode through the quantize→pack kernel
    # (core.encode); False → the per-leaf reference chain. Same wire bytes.
    fused_encode: bool = True

    def __post_init__(self):
        for field in ("kind", "residual"):
            get_codec(getattr(self, field))

    @property
    def is_identity(self) -> bool:
        return self.kind == "none" and self.residual == "none"


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """Per-direction codec selection: upstream (client→server) and
    downstream (server→client) compress independently."""

    upstream: CodecSpec = dataclasses.field(default_factory=CodecSpec)
    downstream: CodecSpec = dataclasses.field(default_factory=CodecSpec)

    @classmethod
    def symmetric(cls, kind: str = "ternary", residual: str = "none",
                  **kw) -> "CompressionSpec":
        d = CodecSpec(kind=kind, residual=residual, **kw)
        return cls(upstream=d, downstream=d)


def compress_pytree(tree: Pytree, spec: CodecSpec) -> tuple[Pytree, None]:
    """Compress each leaf per the spec; returns (wire_tree, None).

    Quantizable leaves (``fttq.is_quantizable``) go through ``spec.kind``,
    floating leaves through ``spec.residual``, everything else ships raw.
    Leaves that are already wire leaves pass through. A kind codec with
    ``encode_leaves_batch`` encodes all its raw leaves in one call."""
    if spec.is_identity:
        return tree, None
    kind = get_codec(spec.kind)
    pairs = flatten_with_path(tree, is_leaf=is_wire_leaf)
    pre: dict[tuple, Any] = {}
    batch = getattr(kind, "encode_leaves_batch", None)
    if batch is not None:
        todo = [(path, leaf) for path, leaf in pairs
                if not is_wire_leaf(leaf) and fttq.is_quantizable(path, leaf, spec.fttq)]
        if todo:
            encoded = batch([leaf for _, leaf in todo], spec)
            pre = {path: wire for (path, _), wire in zip(todo, encoded)}

    def one(path, leaf):
        if is_wire_leaf(leaf):
            return leaf
        if path in pre:
            return pre[path]
        if fttq.is_quantizable(path, leaf, spec.fttq):
            codec = kind
        elif is_floating(leaf):
            codec = get_codec(spec.residual)
        else:
            codec = get_codec("none")
        return codec.encode_leaf(leaf, spec)

    return tree_map_with_path(one, tree, is_leaf=is_wire_leaf), None


def decompress_pytree(wire_tree: Pytree, device="cpu") -> Pytree:
    """Decode every wire leaf back to dense tensors on ``device``."""
    return tree_map(lambda leaf: decode_wire_leaf(leaf, device), wire_tree,
                    is_leaf=is_wire_leaf)
