"""Byte-level wire codec (TFW1) for update payloads: RAW and TERNARY records.

Port of ``repro.comm.wire``; the byte spec is ``docs/WIRE_FORMAT.md``.
Buffers are byte-identical to the reference's for the same tree.

    HEADER (24 B, little-endian):
      magic "TFW1" | version u16 | flags u16 | n_records u32 | crc32 u32 | body_len u64
    RECORD (one per leaf, in flatten order — dict keys sorted):
      path_len u16 + path (entries "d:<key>", "k:<int key>", "i:<index>"
      joined by "\\x1f") | kind u8 | body
        0 RAW      dtype/ndim/dims, data_len u64 + raw bytes
        1 TERNARY  logical dtype/ndim/dims, scale array (dtype/ndim/dims +
                   bytes), packed_len u64 + 2-bit codes (4 per byte)

A RAW/TERNARY payload is stamped v1, the lowest version that carries it.
Kinds 2–4 (downcast, top-k) arrive with their codecs; decoding one raises
``NotImplementedError``.

``encode_update`` sizes every record from metadata, allocates one buffer
and copies each payload into it once (a device tensor straight from the
card); ``update_nbytes`` returns that size without building the buffer.
``decode_update`` returns CPU tensors that are zero-copy views of the
buffer, and raises ``WireError`` on any corrupted, truncated or malformed
input. ``decode_update_leaves`` returns the flat records for the streaming
aggregator, and ``tree_from_records`` rebuilds a tree from them.
"""

from __future__ import annotations

import struct
import warnings
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.core.compression import KIND_RAW, KIND_TERNARY, is_wire_leaf
from repro_torch.core.ternary import TernaryTensor
from repro_torch.dtypes import dtype_name, from_numpy, storage_numpy_dtype, to_numpy
from repro_torch.tree import flatten_with_path

Pytree = Any

WIRE_MAGIC = b"TFW1"
SUPPORTED_VERSIONS = (1, 2, 3)
_V1 = 1
_NOT_PORTED_KINDS = {2: "DOWNCAST", 3: "TOPK", 4: "TOPK_DELTA"}

_HEADER = struct.Struct("<4sHHIIQ")   # magic, version, flags, n_records, crc, body_len
_PATH_SEP = "\x1f"
_INLINE_BYTES = 4096   # payloads this small fold into the record head


class WireError(ValueError):
    """Malformed / corrupted / incompatible wire buffer."""


# --------------------------------------------------------------------------
# Encode.
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


def _record_parts(leaf) -> tuple[int, list]:
    """A record body as (size, parts): ``bytes`` parts and (array, nbytes)
    payloads, the latter copied in at write time."""
    if isinstance(leaf, TernaryTensor):
        s_name, s_shape, s_bytes = _array_info(leaf.w_q)
        p_name, _, p_bytes = _array_info(leaf.packed)
        if p_name != "uint8":
            raise WireError(f"TernaryTensor.packed must be uint8, got {p_name}")
        parts = [_meta(str(leaf.dtype), tuple(int(s) for s in leaf.shape)),
                 _meta(s_name, s_shape), (leaf.w_q, s_bytes),
                 struct.pack("<Q", p_bytes), (leaf.packed, p_bytes)]
    else:
        name, shape, nbytes = _array_info(leaf)
        parts = [_meta(name, shape), struct.pack("<Q", nbytes), (leaf, nbytes)]
    parts = [to_numpy(p[0]).tobytes() if isinstance(p, tuple) and p[1] <= _INLINE_BYTES
             else p for p in parts]
    size = sum(len(p) if isinstance(p, bytes) else p[1] for p in parts)
    return size, parts


def _prepare(tree: Pytree) -> tuple[list[list], int]:
    """Every record's parts, and the buffer's total size."""
    records, total = [], _HEADER.size
    for path, leaf in flatten_with_path(tree, is_leaf=is_wire_leaf):
        p = _PATH_SEP.join(_path_entries(path)).encode("utf-8")
        kind = KIND_TERNARY if isinstance(leaf, TernaryTensor) else KIND_RAW
        size, parts = _record_parts(leaf)
        prefix = struct.pack("<H", len(p)) + p + struct.pack("<B", kind)
        records.append([prefix] + parts)
        total += len(prefix) + size
    return records, total


def encode_update(tree: Pytree) -> bytes:
    """Serialize an update tree into one framed, CRC-protected buffer."""
    records, total = _prepare(tree)
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
    _HEADER.pack_into(buf, 0, WIRE_MAGIC, _V1, 0, len(records),
                      zlib.crc32(view[_HEADER.size:]), total - _HEADER.size)
    return bytes(buf)


def update_nbytes(tree: Pytree) -> int:
    """``len(encode_update(tree))`` from the size pass, without the buffer."""
    return _prepare(tree)[1]


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


_DECODERS = {KIND_RAW: _decode_raw, KIND_TERNARY: _decode_ternary}


def _check_header(data) -> tuple[memoryview, int]:
    """Validate framing and integrity; returns (record section, n_records)."""
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
    return body, n_records


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
    body, n_records = _check_header(data)
    r = _Reader(body)
    pairs = []
    for _ in range(n_records):
        path = bytes(r.take(r.u16())).decode("utf-8")
        kind = r.u8()
        if kind in _NOT_PORTED_KINDS:
            raise NotImplementedError(
                f"wire record kind {_NOT_PORTED_KINDS[kind]} is not ported yet")
        if kind not in _DECODERS:
            raise WireError(f"unknown record kind {kind}")
        pairs.append((path, _DECODERS[kind](r)))
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
            for p, leaf in flatten_with_path(tree, is_leaf=is_wire_leaf)]


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
