"""A plain reader of the TFW1 update buffer (``docs/WIRE_FORMAT.md`` §1):
the header, its CRC and length, and RAW, TERNARY and DOWNCAST records. It
reads what the program shipped so that the reference can judge it; any
departure from the format raises ``ValueError``."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

_HEADER = struct.Struct("<4sHHIIQ")
_DTYPES = {"float32": np.float32, "float16": np.float16, "bfloat16": np.uint16,
           "uint8": np.uint8, "int8": np.int8, "int32": np.int32, "int64": np.int64,
           "uint32": np.uint32}


class _Cursor:
    def __init__(self, data: memoryview):
        self.data, self.at = data, 0

    def take(self, n: int) -> memoryview:
        if self.at + n > len(self.data):
            raise ValueError("record runs past the buffer")
        out = self.data[self.at:self.at + n]
        self.at += n
        return out

    def unpack(self, fmt: str):
        s = struct.Struct("<" + fmt)
        return s.unpack(self.take(s.size))

    def meta(self) -> tuple[str, tuple]:
        (n,) = self.unpack("B")
        dtype = bytes(self.take(n)).decode("ascii")
        (ndim,) = self.unpack("B")
        return dtype, self.unpack(f"{ndim}I") if ndim else ()

    def array(self, dtype: str, shape: tuple, nbytes: int | None = None) -> torch.Tensor:
        count = int(np.prod(shape)) if shape else 1
        want = count * np.dtype(_DTYPES[dtype]).itemsize
        if nbytes is not None and nbytes != want:
            raise ValueError(f"array of {dtype}{list(shape)} holds {nbytes} bytes, want {want}")
        raw = np.frombuffer(bytes(self.take(want)), dtype=_DTYPES[dtype]).reshape(shape)
        t = torch.from_numpy(raw.copy())
        return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _codes(packed: np.ndarray, n: int) -> np.ndarray:
    c = np.stack([(packed >> (2 * j)) & 3 for j in range(4)], axis=1).reshape(-1)
    if np.any(c[:n] == 3):
        raise ValueError("reserved ternary code 3 on the wire")
    return c[:n].astype(np.int8) - 1


def decode(blob: bytes) -> dict:
    """{path: ("raw", tensor) | ("ternary", codes int8, scales) |
    ("downcast", tensor as shipped, original dtype)}, paths joined by "/"."""
    view = memoryview(blob)
    if len(view) < _HEADER.size:
        raise ValueError("buffer shorter than its header")
    magic, version, flags, n_records, crc, body_len = _HEADER.unpack(view[:_HEADER.size])
    body = view[_HEADER.size:]
    if magic != b"TFW1" or version not in (1, 2, 3) or flags != 0:
        raise ValueError(f"bad header {magic!r} v{version} flags {flags}")
    if len(body) != body_len or zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise ValueError("body length or CRC does not match the header")
    cur, out = _Cursor(body), {}
    for _ in range(n_records):
        (plen,) = cur.unpack("H")
        path = "/".join(e.split(":", 1)[1] for e in bytes(cur.take(plen)).decode().split("\x1f"))
        (kind,) = cur.unpack("B")
        if kind == 0:
            dtype, shape = cur.meta()
            (n,) = cur.unpack("Q")
            out[path] = ("raw", cur.array(dtype, shape, n))
        elif kind == 1:
            _, shape = cur.meta()
            s_dtype, s_shape = cur.meta()
            scales = cur.array(s_dtype, s_shape)
            (n,) = cur.unpack("Q")
            count = int(np.prod(shape)) if shape else 1
            if n != -(-count // 4):
                raise ValueError(f"{path}: {n} packed bytes for {count} codes")
            packed = np.frombuffer(bytes(cur.take(n)), dtype=np.uint8)
            out[path] = ("ternary", torch.from_numpy(_codes(packed, count).reshape(shape)),
                         scales.reshape(-1))
        elif kind == 2 and version >= 2:
            (n,) = cur.unpack("B")
            orig = bytes(cur.take(n)).decode("ascii")
            dtype, shape = cur.meta()
            (nb,) = cur.unpack("Q")
            out[path] = ("downcast", cur.array(dtype, shape, nb), orig)
        else:
            raise ValueError(f"{path}: record kind {kind} in a v{version} buffer")
    if cur.at != len(body):
        raise ValueError("trailing bytes after the last record")
    return out
