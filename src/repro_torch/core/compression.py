"""Codec registry and tree compression (port of ``repro.core.compression``).

A codec turns one leaf into a *wire leaf* and back, and owns the wire record
kind byte ``comm.wire`` frames it under. Shipped codecs:

  - "none":    identity (raw fp32/bf16 records) — the FedAvg baseline.
  - "ternary": the paper's FTTQ wire format (``TernaryTensor``).
  - "fp16" / "bf16": half-precision downcast (``DowncastTensor``).
  - "topk":    magnitude top-k sparsification (``TopKTensor``: ascending
    flat indices + their values), per Sattler et al. (arXiv:1903.02891).
  - "topk16":  top-k with the surviving values narrowed to fp16.

``CodecSpec`` selects the codecs of ONE direction of traffic: ``kind`` for
quantizable leaves, ``residual`` for the rest; ``CompressionSpec`` pairs an
upstream and a downstream spec. With ``error_feedback`` the caller carries a
residual tree: each leaf is corrected by its residual before the encode and
the new residual is ``corrected − decode(wire)``, whatever the codec.

Top-k selects as ``jax.lax.top_k`` does: among equal magnitudes the lower
index wins (a stable descending sort of |x|, then the first k indices in
ascending order), so the kept set is the reference's on any device. Indices
stay int64 tensors on the leaf's device; the wire writes them as uint32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Protocol, runtime_checkable

import torch

from repro_torch.core import fttq
from repro_torch.core.ternary import TernaryTensor, _as_tensor
from repro_torch.dtypes import dtype_name, is_floating, torch_dtype, xla_op
from repro_torch.tree import flatten_with_path, tree_leaves, tree_map

Pytree = Any

# Wire record kind bytes (the framing contract with ``comm.wire``). RAW and
# TERNARY are wire-v1, DOWNCAST and TOPK v2, TOPK_DELTA (varint-gap indices,
# what encoders emit for a TopKTensor) v3; TOPK stays decodable.
KIND_RAW = 0
KIND_TERNARY = 1
KIND_DOWNCAST = 2
KIND_TOPK = 3
KIND_TOPK_DELTA = 4


# --------------------------------------------------------------------------
# Wire leaves.
# --------------------------------------------------------------------------


@dataclasses.dataclass
class DowncastTensor:
    """A leaf downcast to a narrower float dtype for the wire: ``data`` is
    the fp16/bf16 payload, ``orig_dtype`` the dtype ``restore`` upcasts to."""

    data: Any
    orig_dtype: str = "float32"

    def restore(self, device: str | torch.device = "cpu") -> torch.Tensor:
        return _as_tensor(self.data, device).to(torch_dtype(self.orig_dtype))


@dataclasses.dataclass
class TopKTensor:
    """A top-k sparsified leaf: ascending flat indices over the logical
    shape and the values kept there; every other position decodes to zero.
    ``indices`` is an integer tensor (int64 as encoded, uint32 or int64 as
    decoded; the same values)."""

    indices: Any
    values: Any
    shape: tuple
    dtype: str = "float32"

    @property
    def n_elements(self) -> int:
        return math.prod(self.shape)

    def densify(self, device: str | torch.device = "cpu") -> torch.Tensor:
        dt = torch_dtype(self.dtype)
        idx = _as_tensor(self.indices, device).to(torch.int64)
        flat = torch.zeros(self.n_elements, dtype=dt, device=device)
        flat[idx] = _as_tensor(self.values, device).to(dt)
        return flat.reshape(self.shape)


# --------------------------------------------------------------------------
# The Codec protocol and the registry.
# --------------------------------------------------------------------------


@runtime_checkable
class Codec(Protocol):
    """One leaf-level compression scheme: ``wire_kind`` is the record kind
    ``comm.wire`` frames its leaves under, ``leaf_type`` the wire-leaf class
    ``encode_leaf`` produces (None for a plain tensor, a RAW record). A codec
    may also expose ``encode_leaves_batch(leaves, spec)``: ``compress_pytree``
    then encodes every raw kind leaf of a tree in one call."""

    name: str
    wire_kind: int
    leaf_type: type | None

    def encode_leaf(self, leaf: torch.Tensor, spec: "CodecSpec") -> Any: ...

    def decode_leaf(self, wire_leaf: Any, device="cpu") -> torch.Tensor: ...


_CODECS: dict[str, Codec] = {}


def register_codec(codec: Codec) -> Codec:
    """Add a codec to the registry. Names are unique, and two codecs share a
    wire kind only if they share a leaf type. A leaf type without a wire
    record is refused when ``comm.wire`` meets one."""
    if codec.name in _CODECS:
        raise ValueError(f"codec {codec.name!r} already registered")
    for other in _CODECS.values():
        if other.wire_kind == codec.wire_kind and other.leaf_type is not codec.leaf_type:
            raise ValueError(
                f"codec {codec.name!r} reuses wire kind {codec.wire_kind} of "
                f"{other.name!r} with a different leaf type")
    _CODECS[codec.name] = codec
    return codec


def get_codec(name: str) -> Codec:
    try:
        return _CODECS[name]
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r}; registered: {available_codecs()}"
        ) from None


def available_codecs() -> list[str]:
    return sorted(_CODECS)


def wire_leaf_types() -> tuple[type, ...]:
    """Every registered non-RAW wire leaf class."""
    return tuple({c.leaf_type for c in _CODECS.values() if c.leaf_type is not None})


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


# --------------------------------------------------------------------------
# Specs.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CodecSpec:
    """Codec selection for ONE direction of traffic.

    kind:     codec for quantizable (weight-like) leaves.
    residual: codec for the non-quantizable leaves (biases, norms, scalars).
    """

    kind: str = "ternary"
    residual: str = "none"
    fttq: fttq.FTTQConfig = dataclasses.field(default_factory=fttq.FTTQConfig)
    error_feedback: bool = False
    topk_fraction: float = 0.1     # fraction of elements the top-k codecs keep
    # True → ternary leaves encode through the quantize→pack kernel
    # (core.encode); False → the per-leaf reference chain. Same wire bytes.
    fused_encode: bool = True

    def __post_init__(self):
        for field in ("kind", "residual"):
            name = getattr(self, field)
            if name not in _CODECS:
                raise ValueError(f"unknown compression {field} {name!r}; "
                                 f"registered: {available_codecs()}")
        if not 0.0 < self.topk_fraction <= 1.0:
            raise ValueError(f"topk_fraction must be in (0, 1], got {self.topk_fraction}")

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


# --------------------------------------------------------------------------
# Shipped codecs.
# --------------------------------------------------------------------------


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


def narrow(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to fp16 or bf16 (to nearest even, subnormals kept,
    overflow to ±inf), with the NaN bits XLA writes on every device: fp16
    keeps the sign and the payload's top bits with the quiet bit set, bf16
    writes the quiet NaN 0x7fc0 with the sign. PyTorch's own casts do not
    promise those bits (its CPU's vectorized bf16 cast writes 0xffff), so
    the NaNs are rewritten."""
    y = x.to(dtype).view(torch.int16)
    bits = x.to(torch.float32).view(torch.int32)
    nan = (bits >> 16) & 0x8000
    nan = nan | (0x7E00 | ((bits >> 13) & 0x3FF) if dtype == torch.float16 else 0x7FC0)
    return torch.where(torch.isnan(x), nan.to(torch.int16), y).view(dtype)


class DowncastCodec:
    """Half-precision downcast of the whole leaf."""

    wire_kind = KIND_DOWNCAST
    leaf_type = DowncastTensor

    def __init__(self, name: str, wire_dtype: torch.dtype):
        self.name = name
        self.wire_dtype = wire_dtype

    def encode_leaf(self, leaf, spec):
        return DowncastTensor(data=narrow(leaf, self.wire_dtype),
                              orig_dtype=dtype_name(leaf.dtype))

    def decode_leaf(self, wire_leaf, device="cpu"):
        return wire_leaf.restore(device)


def topk_indices(flat: torch.Tensor, k: int) -> torch.Tensor:
    """The ascending flat indices of the k largest |x|, ties to the lower
    index (``jax.lax.top_k``'s order); int64 on ``flat``'s device."""
    order = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    return torch.sort(order).values


class TopKCodec:
    """Keep the ``spec.topk_fraction`` largest-magnitude entries; the rest
    decode to zero. Leaves frame as TOPK_DELTA (varint gaps)."""

    name = "topk"
    wire_kind = KIND_TOPK_DELTA
    leaf_type = TopKTensor

    def encode_leaf(self, leaf, spec):
        flat = leaf.reshape(-1)
        k = max(1, math.ceil(spec.topk_fraction * flat.numel()))
        idx = topk_indices(flat, k)
        return TopKTensor(indices=idx, values=flat[idx], shape=tuple(leaf.shape),
                          dtype=dtype_name(leaf.dtype))

    def decode_leaf(self, wire_leaf, device="cpu"):
        return wire_leaf.densify(device)


class TopKDowncastCodec(TopKCodec):
    """Top-k with the surviving values narrowed to fp16 on the wire; the
    same ``TopKTensor`` leaf and TOPK_DELTA record as ``TopKCodec``. With
    error feedback the rounding joins the residual."""

    name = "topk16"

    def encode_leaf(self, leaf, spec):
        t = super().encode_leaf(leaf, spec)
        t.values = narrow(t.values, torch.float16)
        return t


register_codec(NoneCodec())
register_codec(TernaryCodec())
register_codec(DowncastCodec("fp16", torch.float16))
register_codec(DowncastCodec("bf16", torch.bfloat16))
register_codec(TopKCodec())
register_codec(TopKDowncastCodec())


# --------------------------------------------------------------------------
# Tree application.
# --------------------------------------------------------------------------


def _device_of(x) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def compress_pytree(tree: Pytree, spec: CodecSpec, residual: Pytree | None = None
                    ) -> tuple[Pytree, Pytree | None]:
    """Compress each leaf per the spec; returns (wire_tree, new_residual).

    Quantizable leaves (``fttq.is_quantizable``) go through ``spec.kind``,
    floating leaves through ``spec.residual``, everything else ships raw.
    Leaves that are already wire leaves pass through (with error feedback
    their residual is a scalar zero, so the residual tree stays aligned).
    With ``spec.error_feedback`` each leaf is first corrected by its
    residual and the new residual is corrected − decode(wire), on the
    leaf's device, both as XLA forms them (``dtypes.xla_op``: a subnormal
    operand or result is a zero), so that the residual carried from round
    to round holds the reference's bits; otherwise the residual returned is
    None. A kind codec
    with ``encode_leaves_batch`` encodes all its raw leaves in one call."""
    if spec.is_identity:
        return tree, residual
    ef = spec.error_feedback
    kind = get_codec(spec.kind)
    pairs = flatten_with_path(tree, is_leaf=is_wire_leaf)
    res_leaves = tree_leaves(residual) if residual is not None else [None] * len(pairs)

    def corrected(leaf, res):
        if not ef:
            return leaf
        leaf = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
        return leaf if res is None else xla_op(torch.add, leaf, res)

    # the batched pre-pass: every raw quantizable leaf in one call
    pre: dict[int, tuple] = {}
    batch = getattr(kind, "encode_leaves_batch", None)
    if batch is not None:
        todo = [(i, corrected(leaf, res))
                for i, ((path, leaf), res) in enumerate(zip(pairs, res_leaves))
                if not is_wire_leaf(leaf) and fttq.is_quantizable(path, leaf, spec.fttq)]
        if todo:
            encoded = batch([x for _, x in todo], spec)
            pre = {i: (x, wire) for (i, x), wire in zip(todo, encoded)}

    out_wire, out_res = [], []
    for i, ((path, leaf), res) in enumerate(zip(pairs, res_leaves)):
        if is_wire_leaf(leaf):
            out_wire.append(leaf)
            out_res.append(torch.zeros(()) if ef else None)
            continue
        if i in pre:
            x, wire = pre[i]
            codec = kind
        else:
            if fttq.is_quantizable(path, leaf, spec.fttq):
                codec = kind
            elif is_floating(leaf):
                codec = get_codec(spec.residual)
            else:
                # step counters, rng keys, masks: a float codec would corrupt them
                codec = get_codec("none")
            x = corrected(leaf, res)
            wire = codec.encode_leaf(x, spec)
        out_wire.append(wire)
        out_res.append(xla_op(torch.sub, x, codec.decode_leaf(wire, _device_of(x))) if ef else None)
    wire_it, res_it = iter(out_wire), iter(out_res)
    wire_tree = tree_map(lambda _: next(wire_it), tree, is_leaf=is_wire_leaf)
    res_tree = tree_map(lambda _: next(res_it), tree, is_leaf=is_wire_leaf) if ef else None
    return wire_tree, res_tree


def decompress_pytree(wire_tree: Pytree, device="cpu") -> Pytree:
    """Decode every wire leaf back to dense tensors on ``device``."""
    return tree_map(lambda leaf: decode_wire_leaf(leaf, device), wire_tree,
                    is_leaf=is_wire_leaf)


def wire_nbytes(wire_tree: Pytree) -> int:
    """Bytes of a compressed tree on the wire, framing included: the size
    ``comm.wire.encode_update`` gives it."""
    from repro_torch.comm.wire import update_nbytes

    return update_nbytes(wire_tree)
