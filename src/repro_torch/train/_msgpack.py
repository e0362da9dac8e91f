"""The part of MessagePack that a train checkpoint uses.

The reference writes checkpoints with ``msgpack.packb(obj, use_bin_type=True)``
and reads them with ``msgpack.unpackb(data, raw=False)``. The port carries
this small subset instead of depending on the ``msgpack`` package: nil,
bool, int (to 64 bits), str, bin, array and map.
``packb`` writes the bytes ``msgpack`` writes for these types (the smallest
encoding of each int, length and count; str8 for strings of 32 to 255
bytes), and ``unpackb`` returns what ``msgpack`` returns: ``bytes`` for bin,
``str`` for str, lists for arrays and dicts for maps.
"""

from __future__ import annotations

import struct


def packb(obj) -> bytes:
    out: list[bytes] = []
    _pack(obj, out)
    return b"".join(out)


def _header(n: int, small_tag: int | None, small_limit: int, tags: tuple[int, int, int],
            out: list) -> None:
    """A length or count ``n``: a fix form below ``small_limit`` (when the
    type has one), else the 8-, 16- or 32-bit form in ``tags`` (None for a
    form the type lacks)."""
    if small_tag is not None and n < small_limit:
        out.append(bytes((small_tag | n,)))
    elif tags[0] is not None and n < 1 << 8:
        out.append(struct.pack(">BB", tags[0], n))
    elif n < 1 << 16:
        out.append(struct.pack(">BH", tags[1], n))
    elif n < 1 << 32:
        out.append(struct.pack(">BI", tags[2], n))
    else:
        raise ValueError(f"msgpack length {n} exceeds 2^32 - 1")


def _pack_int(n: int, out: list) -> None:
    if 0 <= n < 1 << 7:
        out.append(bytes((n,)))
    elif -32 <= n < 0:
        out.append(struct.pack(">b", n))
    elif n >= 0:
        for tag, fmt, limit in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                                (0xCE, ">BI", 1 << 32), (0xCF, ">BQ", 1 << 64)):
            if n < limit:
                out.append(struct.pack(fmt, tag, n))
                return
        raise OverflowError(f"int {n} exceeds 64 bits")
    else:
        for tag, fmt, limit in ((0xD0, ">Bb", 1 << 7), (0xD1, ">Bh", 1 << 15),
                                (0xD2, ">Bi", 1 << 31), (0xD3, ">Bq", 1 << 63)):
            if n >= -limit:
                out.append(struct.pack(fmt, tag, n))
                return
        raise OverflowError(f"int {n} exceeds 64 bits")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _header(len(data), None, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _header(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _header(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r} object")


_FIXED = {  # tag: (struct format, size) of the int that follows a tag
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LENGTH = {  # tag: (kind, size of the length that follows)
    0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
    0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
    0xDC: ("array", 2), 0xDD: ("array", 4), 0xDE: ("map", 2), 0xDF: ("map", 4),
}


def unpackb(data) -> object:
    view = memoryview(data)
    obj, end = _unpack(view, 0)
    if end != len(view):
        raise ValueError(f"extra data: {len(view) - end} bytes after the object")
    return obj


def _unpack(view: memoryview, pos: int):
    tag = view[pos]
    pos += 1
    if tag < 0x80:
        return tag, pos
    if tag >= 0xE0:
        return tag - 0x100, pos
    if tag < 0x90:
        return _unpack_items("map", tag & 0x0F, view, pos)
    if tag < 0xA0:
        return _unpack_items("array", tag & 0x0F, view, pos)
    if tag < 0xC0:
        return _unpack_items("str", tag & 0x1F, view, pos)
    if tag == 0xC0:
        return None, pos
    if tag in (0xC2, 0xC3):
        return tag == 0xC3, pos
    if tag in _FIXED:
        fmt, size = _FIXED[tag]
        return struct.unpack_from(fmt, view, pos)[0], pos + size
    if tag in _LENGTH:
        kind, size = _LENGTH[tag]
        n = int.from_bytes(view[pos:pos + size], "big")
        return _unpack_items(kind, n, view, pos + size)
    raise ValueError(f"unsupported msgpack type byte 0x{tag:02x}")


def _unpack_items(kind: str, n: int, view: memoryview, pos: int):
    if kind in ("bin", "str"):
        if pos + n > len(view):
            raise ValueError("truncated msgpack data")
        raw = view[pos:pos + n]
        return (bytes(raw) if kind == "bin" else str(raw, "utf-8")), pos + n
    if kind == "array":
        items = []
        for _ in range(n):
            item, pos = _unpack(view, pos)
            items.append(item)
        return items, pos
    out = {}
    for _ in range(n):
        key, pos = _unpack(view, pos)
        out[key], pos = _unpack(view, pos)
    return out, pos
