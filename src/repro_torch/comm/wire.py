"""Byte-level wire codec (TFW1) for update payloads.

Port of ``repro.comm.wire``; the byte spec is ``docs/WIRE_FORMAT.md``.
Buffers are byte-identical to the reference's for the same tree.

    HEADER (24 B, little-endian):
      magic "TFW1" | version u16 | flags u16 | n_records u32 | crc32 u32 | body_len u64
    RECORD (one per leaf, in flatten order — dict keys sorted):
      path_len u16 + path (entries "d:<key>", "k:<int key>", "i:<index>"
      joined by "\\x1f") | kind u8 | body
        0 RAW        (v1) dtype/ndim/dims, data_len u64 + raw bytes
        1 TERNARY    (v1) logical dtype/ndim/dims, scale array (dtype/ndim/
                     dims + bytes), packed_len u64 + 2-bit codes (4 per byte)
        2 DOWNCAST   (v2) orig dtype string + the fp16/bf16 payload as RAW
        3 TOPK       (v2) logical dtype/ndim/dims + uint32 indices and values,
                     both RAW-style (decoded only: encoders emit kind 4)
        4 TOPK_DELTA (v3) logical dtype/ndim/dims, k u32, stream_len u64 +
                     the ascending indices as LEB128 varints (the first
                     absolute, then strictly positive gaps), values RAW-style

Record kinds are a registry (``register_record``): each ``WireRecord``
binds a kind byte to a wire-leaf class, its sizing writer and its reader,
with the lowest wire version that may carry it. The header is stamped with
the lowest version that carries every record of the payload, so a
RAW/TERNARY-only buffer stays v1; decoders accept every supported version
and refuse a record newer than its buffer.

``encode_update`` sizes every record from metadata, allocates one buffer
and copies each payload into it once (a device tensor straight from the
card; top-k indices pass through the host for the varint stream);
``update_nbytes`` returns that size without building the buffer.
``decode_update`` returns CPU tensors that are zero-copy views of the
buffer (top-k indices as int64), and raises ``WireError`` on any
corrupted, truncated or malformed input. ``decode_update_leaves`` returns
the flat records for the streaming aggregator, and ``tree_from_records``
rebuilds a tree from them.
"""

from __future__ import annotations

import dataclasses
import struct
import warnings
import zlib
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.compression import (
    KIND_DOWNCAST, KIND_RAW, KIND_TERNARY, KIND_TOPK, KIND_TOPK_DELTA, DowncastTensor,
    TopKTensor, wire_leaf_types,
)
from repro_torch.core.ternary import TernaryTensor
from repro_torch.dtypes import dtype_name, from_numpy, storage_numpy_dtype, to_numpy
from repro_torch.tree import flatten_with_path

Pytree = Any

WIRE_MAGIC = b"TFW1"
WIRE_VERSION = 3
SUPPORTED_VERSIONS = (1, 2, 3)

_HEADER = struct.Struct("<4sHHIIQ")   # magic, version, flags, n_records, crc, body_len
_PATH_SEP = "\x1f"
_INLINE_BYTES = 4096   # payloads this small fold into the record head


class WireError(ValueError):
    """Malformed / corrupted / incompatible wire buffer."""


# --------------------------------------------------------------------------
# Encode: record bodies as (size, parts).
# --------------------------------------------------------------------------


def _path_entries(path) -> list[str]:
    out = []
    for kind, key in path:
        if kind == "i":
            out.append(f"i:{key}")
        elif isinstance(key, str):
            out.append(f"d:{key}")
        elif isinstance(key, (int, np.integer)):
            out.append(f"k:{int(key)}")
        else:
            raise WireError(f"unsupported dict key type {type(key).__name__}")
    return out


def _meta(dtype: str, shape: tuple) -> bytes:
    dt = dtype.encode("ascii")
    dims = struct.pack(f"<B{len(shape)}I", len(shape), *shape) if shape else b"\x00"
    return struct.pack("<B", len(dt)) + dt + dims


def _array_info(x) -> tuple[str, tuple, int]:
    """(dtype name, shape, nbytes) from metadata only."""
    if isinstance(x, torch.Tensor):
        return dtype_name(x.dtype), tuple(x.shape), x.numel() * x.element_size()
    arr = np.asarray(x)
    return dtype_name(arr.dtype), arr.shape, arr.nbytes


def _write_array(view: memoryview, off: int, x, nbytes: int) -> int:
    """Copy the raw bytes of ``x`` into the buffer at ``off`` — a device
    tensor goes straight from the card into the buffer."""
    if nbytes:
        if isinstance(x, torch.Tensor):
            dst = torch.frombuffer(view, dtype=torch.uint8, count=nbytes, offset=off)
            dst.copy_(x.detach().contiguous().reshape(-1).view(torch.uint8))
        else:
            arr = np.ascontiguousarray(x)
            view[off:off + nbytes] = arr.reshape(-1).view(np.uint8).data
    return off + nbytes


def _body(parts: list) -> tuple[int, list]:
    """A record body as (size, parts): ``bytes`` parts and (array, nbytes)
    payloads, the latter copied in at write time unless they are small."""
    parts = [to_numpy(p[0]).tobytes() if isinstance(p, tuple) and p[1] <= _INLINE_BYTES
             else p for p in parts]
    return sum(len(p) if isinstance(p, bytes) else p[1] for p in parts), parts


def _array_parts(x) -> list:
    """A RAW-style array field: meta, u64 length, then the bytes."""
    name, shape, nbytes = _array_info(x)
    return [_meta(name, shape), struct.pack("<Q", nbytes), (x, nbytes)]


def _raw_prepare(leaf) -> tuple[int, list]:
    return _body(_array_parts(leaf))


def _ternary_prepare(t: TernaryTensor) -> tuple[int, list]:
    s_name, s_shape, s_bytes = _array_info(t.w_q)
    p_name, _, p_bytes = _array_info(t.packed)
    if p_name != "uint8":
        raise WireError(f"TernaryTensor.packed must be uint8, got {p_name}")
    return _body([_meta(str(t.dtype), tuple(int(s) for s in t.shape)),
                  _meta(s_name, s_shape), (t.w_q, s_bytes),
                  struct.pack("<Q", p_bytes), (t.packed, p_bytes)])


def _downcast_prepare(t: DowncastTensor) -> tuple[int, list]:
    dt = str(t.orig_dtype).encode("ascii")
    return _body([struct.pack("<B", len(dt)) + dt] + _array_parts(t.data))


def _host_indices(indices) -> np.ndarray:
    """Top-k indices as host uint32 (int64 on the card until here)."""
    idx = to_numpy(indices).reshape(-1)
    if not np.issubdtype(idx.dtype, np.integer):
        raise WireError(f"TopKTensor.indices must be integers, got {idx.dtype}")
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) > 0xFFFFFFFF):
        raise WireError("TopKTensor.indices out of the uint32 range")
    return idx.astype(np.uint32)


def _varint_pack(values: np.ndarray) -> bytes:
    """Ascending uint32 indices → LEB128 stream: the first absolute, then
    the gaps. Strictly ascending is the TopKTensor contract; anything else
    is refused here rather than emitted undecodable. Vectorized."""
    if values.size == 0:
        return b""
    v = values.astype(np.uint64)
    if v.size > 1 and not np.all(values[1:] > values[:-1]):
        raise WireError("TopKTensor indices must be strictly ascending")
    d = np.empty(v.shape, np.uint64)
    d[0] = v[0]
    d[1:] = v[1:] - v[:-1]
    nbytes = np.ones(d.shape, np.int64)          # LEB128 length per gap
    for j in range(1, 6):                        # u32 gaps need ≤ 5 bytes
        nbytes += (d >> np.uint64(7 * j)) > 0
    offsets = np.concatenate([[0], np.cumsum(nbytes)])
    out = np.zeros(int(offsets[-1]), np.uint8)
    for j in range(int(nbytes.max())):
        mask = nbytes > j
        byte = ((d[mask] >> np.uint64(7 * j)) & np.uint64(0x7F)).astype(np.uint8)
        cont = (nbytes[mask] - 1 > j).astype(np.uint8) << 7
        out[offsets[:-1][mask] + j] = byte | cont
    return out.tobytes()


def _topk_delta_prepare(t: TopKTensor) -> tuple[int, list]:
    idx = _host_indices(t.indices)
    stream = _varint_pack(idx)
    head = (_meta(str(t.dtype), tuple(int(s) for s in t.shape))
            + struct.pack("<I", idx.size) + struct.pack("<Q", len(stream)) + stream)
    return _body([head] + _array_parts(t.values))


# --------------------------------------------------------------------------
# Decode.
# --------------------------------------------------------------------------


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if n < 0 or self.pos + n > len(self.buf):
            raise WireError(
                f"truncated wire buffer: need {n} bytes at offset {self.pos}, "
                f"have {len(self.buf) - self.pos}"
            )
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def meta(self) -> tuple[str, tuple]:
        dt = bytes(self.take(self.u8())).decode("ascii")
        ndim = self.u8()
        shape = struct.unpack(f"<{ndim}I", self.take(4 * ndim)) if ndim else ()
        return dt, tuple(shape)

    def array(self, dtype: str, shape: tuple, data: memoryview) -> torch.Tensor:
        try:
            np_dt = storage_numpy_dtype(dtype)
        except TypeError as e:
            raise WireError(f"unknown dtype {dtype!r} in wire record") from e
        n = int(np.prod(shape)) if shape else 1
        if len(data) != n * np_dt.itemsize:
            raise WireError(
                f"record data length {len(data)} != {n}×{np_dt.itemsize} "
                f"for dtype={dtype} shape={shape}"
            )
        arr = np.frombuffer(data, dtype=np_dt).reshape(shape)
        with warnings.catch_warnings():
            # views of an immutable buffer: callers copy before writing
            warnings.filterwarnings("ignore", message=".*not writable.*")
            return from_numpy(arr, dtype)


def _decode_raw(r: _Reader) -> torch.Tensor:
    dtype, shape = r.meta()
    return r.array(dtype, shape, r.take(r.u64()))


def _decode_ternary(r: _Reader) -> TernaryTensor:
    dtype, shape = r.meta()
    s_dtype, s_shape = r.meta()
    try:
        s_size = storage_numpy_dtype(s_dtype).itemsize
    except TypeError as e:
        raise WireError(f"unknown dtype {s_dtype!r} in wire record") from e
    s_n = int(np.prod(s_shape)) if s_shape else 1
    scale = r.array(s_dtype, s_shape, r.take(s_n * s_size))
    n_packed = r.u64()
    packed = r.array("uint8", (n_packed,), r.take(n_packed))
    n = int(np.prod(shape)) if shape else 1
    if n_packed != (n + 3) // 4:
        raise WireError(f"packed size {n_packed} inconsistent with logical shape {shape}")
    return TernaryTensor(packed=packed, w_q=scale, shape=tuple(shape), dtype=dtype)


def _check_dtype(dtype: str) -> None:
    try:
        storage_numpy_dtype(dtype)
    except TypeError as e:
        raise WireError(f"unknown dtype {dtype!r} in wire record") from e


def _decode_downcast(r: _Reader) -> DowncastTensor:
    orig = bytes(r.take(r.u8())).decode("ascii")
    _check_dtype(orig)   # before it reaches restore()
    return DowncastTensor(data=_decode_raw(r), orig_dtype=orig)


def _decode_topk(r: _Reader) -> TopKTensor:
    dtype, shape = r.meta()
    _check_dtype(dtype)
    indices = to_numpy(_decode_raw(r))
    values = _decode_raw(r)
    n = int(np.prod(shape)) if shape else 1
    if tuple(indices.shape) != tuple(values.shape) or indices.ndim != 1:
        raise WireError(f"topk indices/values shapes differ: {indices.shape} vs "
                        f"{tuple(values.shape)}")
    if indices.dtype != np.uint32:
        raise WireError(f"topk indices must be uint32, got {indices.dtype}")
    if indices.size and int(indices.max()) >= n:
        raise WireError(f"topk index out of range for logical shape {shape}")
    return TopKTensor(indices=torch.from_numpy(indices.astype(np.int64)), values=values,
                      shape=tuple(shape), dtype=dtype)


def _varint_unpack(stream, k: int) -> np.ndarray:
    """LEB128 stream → k uint64 values (the gap sequence). Vectorized: the
    continuation bits delimit groups and ``np.add.reduceat`` folds each
    group's 7-bit limbs."""
    b = np.frombuffer(stream, np.uint8)
    if k == 0:
        if b.size:
            raise WireError(f"{b.size} trailing bytes in empty varint stream")
        return np.zeros((0,), np.uint64)
    is_end = (b & 0x80) == 0
    if b.size == 0 or not is_end[-1]:
        raise WireError("unterminated varint in topk delta stream")
    if int(is_end.sum()) != k:
        raise WireError(f"varint stream carries {int(is_end.sum())} values, expected {k}")
    starts = np.flatnonzero(np.concatenate([[True], is_end[:-1]]))
    gid = np.cumsum(np.concatenate([[0], is_end[:-1].astype(np.int64)]))
    pos = np.arange(b.size) - starts[gid]        # limb index within its varint
    if int(pos.max()) > 4:                       # u32 gaps need ≤ 5 limbs
        raise WireError("varint overflows uint32 index range")
    limbs = (b & 0x7F).astype(np.uint64) << (7 * pos).astype(np.uint64)
    return np.add.reduceat(limbs, starts)


def _decode_topk_delta(r: _Reader) -> TopKTensor:
    dtype, shape = r.meta()
    _check_dtype(dtype)
    k = struct.unpack("<I", r.take(4))[0]
    stream = r.take(r.u64())
    n = int(np.prod(shape)) if shape else 1
    gaps = _varint_unpack(stream, k)
    if gaps.size > 1 and not np.all(gaps[1:] > 0):
        raise WireError("topk delta stream not strictly ascending")
    idx = np.cumsum(gaps)
    if idx.size and (int(idx[-1]) >= n or int(idx[-1]) > 0xFFFFFFFF):
        raise WireError(f"topk index {int(idx[-1])} out of range for shape {shape}")
    values = _decode_raw(r)
    if tuple(values.shape) != (k,):
        raise WireError(f"topk values shape {tuple(values.shape)} != index count {k}")
    return TopKTensor(indices=torch.from_numpy(idx.astype(np.int64)), values=values,
                      shape=tuple(shape), dtype=dtype)


# --------------------------------------------------------------------------
# The record registry: kind byte ↔ wire-leaf class ↔ writer and reader.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WireRecord:
    kind: int
    name: str
    leaf_type: type | None              # None: the RAW record of plain arrays
    unpack: Callable[[_Reader], Any]
    min_version: int = WIRE_VERSION     # the oldest wire version that carries it
    encode: bool = True                 # False: decoded forever, never emitted
    prepare: Callable[[Any], tuple[int, list]] | None = None   # body as (size, parts)


_RECORDS: dict[int, WireRecord] = {}


def register_record(record: WireRecord) -> WireRecord:
    """Register a record kind (a new codec's leaves plug in here)."""
    if not 0 <= record.kind <= 0xFF:
        raise ValueError(f"record kind {record.kind} does not fit the u8 field")
    if record.kind in _RECORDS:
        raise ValueError(f"record kind {record.kind} already registered "
                         f"as {_RECORDS[record.kind].name!r}")
    if record.encode and record.prepare is None:
        raise ValueError(f"record kind {record.kind} is emitted but has no prepare")
    _RECORDS[record.kind] = record
    return record


register_record(WireRecord(KIND_RAW, "RAW", None, _decode_raw, min_version=1,
                           prepare=_raw_prepare))
register_record(WireRecord(KIND_TERNARY, "TERNARY", TernaryTensor, _decode_ternary,
                           min_version=1, prepare=_ternary_prepare))
register_record(WireRecord(KIND_DOWNCAST, "DOWNCAST", DowncastTensor, _decode_downcast,
                           min_version=2, prepare=_downcast_prepare))
# raw-u32-index top-k: stored v2 buffers decode forever, encoders emit kind 4
register_record(WireRecord(KIND_TOPK, "TOPK", TopKTensor, _decode_topk, min_version=2,
                           encode=False))
register_record(WireRecord(KIND_TOPK_DELTA, "TOPK_DELTA", TopKTensor, _decode_topk_delta,
                           min_version=3, prepare=_topk_delta_prepare))


def _leaf_test():
    """``is_leaf`` for a flatten: a leaf class of the record registry or of
    the codec registry (a codec leaf without a record is seen as a leaf, so
    ``_record_for_leaf`` refuses it instead of flattening through it)."""
    types = tuple({r.leaf_type for r in _RECORDS.values() if r.leaf_type is not None}
                  | set(wire_leaf_types()))
    return lambda x: isinstance(x, types)


def _record_for_leaf(leaf) -> WireRecord:
    for rec in _RECORDS.values():
        if rec.encode and rec.leaf_type is not None and isinstance(leaf, rec.leaf_type):
            return rec
    if isinstance(leaf, wire_leaf_types()):
        raise WireError(f"wire leaf {type(leaf).__name__} has a registered codec but no "
                        "record kind — call comm.wire.register_record for it")
    return _RECORDS[KIND_RAW]


def _prepare(tree: Pytree) -> tuple[list[list], int, int]:
    """Every record's parts, the buffer's total size, and the lowest wire
    version that carries every record."""
    records, total, version = [], _HEADER.size, min(SUPPORTED_VERSIONS)
    for path, leaf in flatten_with_path(tree, is_leaf=_leaf_test()):
        p = _PATH_SEP.join(_path_entries(path)).encode("utf-8")
        rec = _record_for_leaf(leaf)
        version = max(version, rec.min_version)
        size, parts = rec.prepare(leaf)
        prefix = struct.pack("<H", len(p)) + p + struct.pack("<B", rec.kind)
        records.append([prefix] + parts)
        total += len(prefix) + size
    return records, total, version


def _write(records: list[list], total: int) -> tuple[bytearray, memoryview]:
    """The buffer with every record's parts written after the header."""
    buf = bytearray(total)
    view = memoryview(buf)
    off = _HEADER.size
    for parts in records:
        for part in parts:
            if isinstance(part, bytes):
                view[off:off + len(part)] = part
                off += len(part)
            else:
                off = _write_array(view, off, *part)
    if off != total:  # pragma: no cover - size/writer contract violation
        raise WireError(f"records emitted {off} bytes, sized {total}")
    return buf, view


def _finish(buf: bytearray, view: memoryview, version: int, n_records: int) -> bytes:
    _HEADER.pack_into(buf, 0, WIRE_MAGIC, version, 0, n_records,
                      zlib.crc32(view[_HEADER.size:]), len(buf) - _HEADER.size)
    return bytes(buf)


def encode_update(tree: Pytree) -> bytes:
    """Serialize an update tree into one framed, CRC-protected buffer,
    stamped with the lowest version that carries its records."""
    records, total, version = _prepare(tree)
    return _finish(*_write(records, total), version, len(records))


def update_nbytes(tree: Pytree) -> int:
    """``len(encode_update(tree))`` from the size pass, without the buffer."""
    return _prepare(tree)[1]


def encode_tensor(t: TernaryTensor) -> bytes:
    """One TernaryTensor as the header and a bare TERNARY body (no path, no
    kind byte), stamped v1: the body is unchanged since v1."""
    size, parts = _ternary_prepare(t)
    return _finish(*_write([parts], _HEADER.size + size),
                   _RECORDS[KIND_TERNARY].min_version, 1)


def decode_tensor(data) -> TernaryTensor:
    """Inverse of ``encode_tensor`` (CRC-checked)."""

    def decode(d):
        body, _, _ = _check_header(d, expect_records=1)
        r = _Reader(body)
        t = _decode_ternary(r)
        if r.pos != len(body):
            raise WireError(f"{len(body) - r.pos} trailing bytes after tensor record")
        return t

    return _guarded(decode, data)


def _check_header(data, expect_records: int | None = None) -> tuple[memoryview, int, int]:
    """Validate framing and integrity; returns (record section, n_records,
    the buffer's wire version)."""
    if len(data) < _HEADER.size:
        raise WireError(f"buffer too short for header: {len(data)} B")
    magic, version, _flags, n_records, crc, body_len = _HEADER.unpack_from(data)
    if magic != WIRE_MAGIC:
        raise WireError(f"bad magic {magic!r} (expected {WIRE_MAGIC!r})")
    if version not in SUPPORTED_VERSIONS:
        raise WireError(f"wire version {version} not supported (have {SUPPORTED_VERSIONS})")
    body = memoryview(data)[_HEADER.size:]
    if len(body) != body_len:
        raise WireError(f"body length {len(body)} != header body_len {body_len}")
    if zlib.crc32(body) != crc:
        raise WireError("CRC32 mismatch: payload corrupted in transit")
    if expect_records is not None and n_records != expect_records:
        raise WireError(f"expected {expect_records} records, header says {n_records}")
    return body, n_records, version


def _parse_entry(e: str) -> tuple[str, Any]:
    tag, _, key = e.partition(":")
    if tag == "d":
        return ("d", key)
    if tag in ("k", "i"):
        try:
            return (tag, int(key))
        except ValueError as err:
            raise WireError(f"bad integer path entry {key!r}") from err
    raise WireError(f"bad path entry {e!r}")


def _insert(root: dict, entries: list[str], leaf) -> None:
    node = root
    for i, e in enumerate(entries):
        key = _parse_entry(e)
        if i == len(entries) - 1:
            if key in node and isinstance(node[key], dict):
                raise WireError(f"path collision at {e!r}: leaf under container")
            node[key] = leaf
        else:
            nxt = node.setdefault(key, {})
            if not isinstance(nxt, dict):
                raise WireError(f"path collision at {e!r}: container under leaf")
            node = nxt


def _containerize(node):
    """('i', n) nodes → lists; ('d', s) / ('k', n) nodes → dicts."""
    if not isinstance(node, dict):
        return node
    tags = {t for t, _ in node}
    if "i" in tags:
        if tags != {"i"}:
            raise WireError("mixed sequence and dict entries at one node")
        idxs = sorted(k for _, k in node)
        if idxs != list(range(len(idxs))):
            raise WireError(f"non-contiguous sequence indices {idxs}")
        return [_containerize(node[("i", i)]) for i in idxs]
    return {k: _containerize(v) for (_, k), v in node.items()}


def _decode_records(data) -> list[tuple[str, Any]]:
    body, n_records, version = _check_header(data)
    r = _Reader(body)
    pairs = []
    for _ in range(n_records):
        path = bytes(r.take(r.u16())).decode("utf-8")
        kind = r.u8()
        rec = _RECORDS.get(kind)
        if rec is None:
            raise WireError(f"unknown record kind {kind}")
        if version < rec.min_version:
            raise WireError(f"record kind {rec.name} requires wire v{rec.min_version}, "
                            f"buffer is v{version}")
        pairs.append((path, rec.unpack(r)))
    if r.pos != len(body):
        raise WireError(f"{len(body) - r.pos} trailing bytes after last record")
    return pairs


def _guarded(fn, data):
    try:
        return fn(data)
    except WireError:
        raise
    except (struct.error, ValueError, TypeError, OverflowError,
            UnicodeDecodeError) as e:
        raise WireError(f"malformed wire buffer: {e}") from e


def decode_update(data) -> Pytree:
    """Inverse of ``encode_update``: the tree, with CPU tensors that view
    ``data``. Dicts come back as dicts, sequences as lists; a single leaf
    with an empty path decodes to the bare leaf."""
    return _guarded(lambda d: tree_from_records(_decode_records(d)), data)


def decode_update_leaves(data) -> list[tuple[str, Any]]:
    """The flat (path, leaf) records in wire order, without rebuilding
    containers: the streaming aggregator reads records straight off the
    buffer. Arrays are zero-copy CPU tensors viewing ``data``."""
    return _guarded(_decode_records, data)


def tree_leaf_paths(tree: Pytree) -> list[tuple[str, Any]]:
    """(wire path, leaf) pairs of a tree: the path strings ``encode_update``
    stamps on its records, in record order."""
    return [(_PATH_SEP.join(_path_entries(p)), leaf)
            for p, leaf in flatten_with_path(tree, is_leaf=_leaf_test())]


def tree_from_records(pairs: list[tuple[str, Any]]) -> Pytree:
    """Rebuild the tree from (path, leaf) records, with the container
    normalization of ``decode_update``."""
    root: dict = {}
    for path, leaf in pairs:
        if not path:
            if len(pairs) != 1:
                raise WireError("empty path in multi-record update")
            return leaf
        _insert(root, path.split(_PATH_SEP), leaf)
    return _containerize(root)
