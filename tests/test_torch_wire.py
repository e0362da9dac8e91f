"""Port vs reference: TFW1 buffers byte-identical for the same numpy tree of
RAW and TERNARY leaves, the frozen v1 capture decodes, the size pass equals
the buffer length, and corrupted or truncated buffers raise ``WireError``.
Then record kinds 2–4 (DOWNCAST, the decode-only TOPK, TOPK_DELTA with its
LEB128 gaps) against the reference's buffers, the lowest-version stamp, the
varint ``WireError`` cases, and the single-tensor ``encode_tensor``."""

import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import wire as jwire
from repro.core.ternary import TernaryTensor as JTernary
from repro_torch.comm.wire import (
    _HEADER, WireError, _varint_pack, decode_update, encode_update, update_nbytes,
)
from repro_torch.core.ternary import TernaryTensor, pack2bit

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "wire_v1_update.bin")


def _trees(seed: int):
    """The same update as a reference (jax) tree and a port (torch) tree."""
    rng = np.random.default_rng(seed)
    it2 = rng.integers(-1, 2, size=(17, 9)).astype(np.int8)
    it3 = rng.integers(-1, 2, size=(3, 8, 6)).astype(np.int8)
    wq2 = np.float32(0.625)
    wq3 = rng.uniform(0.1, 1.0, size=(3, 1, 1)).astype(np.float32)
    raws = {
        "bias": rng.normal(size=(7,)).astype(np.float32),
        "table": rng.normal(size=(40, 33)).astype(np.float32),   # > inline size
        "step": np.int32(12),
        "mask": rng.integers(0, 2, size=(5,)).astype(np.bool_),
        "ids": rng.integers(0, 100, size=(4,)).astype(np.int64),
        "half": rng.normal(size=(3, 2)).astype(np.float16),
    }

    def jt(it, wq):
        from repro.core.ternary import pack2bit as jpack

        return JTernary(packed=np.asarray(jpack(jnp.asarray(it))), w_q=wq,
                        shape=it.shape, dtype="float32")

    def tt(it, wq):
        return TernaryTensor(packed=pack2bit(torch.from_numpy(it)),
                             w_q=torch.from_numpy(np.array(wq)), shape=it.shape)

    jtree = {"blocks": [{"w": jt(it2, wq2), "b": raws["bias"]},
                        {"w": jt(it3, wq3)}],
             "embed": {"table": raws["table"]}, "meta": {3: raws["step"], 1: raws["ids"]},
             "mask": raws["mask"], "half": raws["half"]}
    ttree = {"half": torch.from_numpy(raws["half"]), "mask": torch.from_numpy(raws["mask"]),
             "meta": {1: torch.from_numpy(raws["ids"]), 3: torch.tensor(12, dtype=torch.int32)},
             "embed": {"table": torch.from_numpy(raws["table"])},
             "blocks": [{"b": torch.from_numpy(raws["bias"]), "w": tt(it2, wq2)},
                        {"w": tt(it3, wq3)}]}
    return jtree, ttree


@pytest.mark.parametrize("seed", [0, 1])
def test_encode_update_byte_identical_to_reference(seed):
    jtree, ttree = _trees(seed)
    ref = jwire.encode_update(jtree)
    got = encode_update(ttree)
    assert _HEADER.unpack_from(got)[1] == 1   # RAW/TERNARY only: stamped v1
    assert got == ref
    assert update_nbytes(ttree) == len(got)


def test_numpy_leaves_encode_like_tensors():
    _, ttree = _trees(2)
    as_numpy = {"half": ttree["half"].numpy(), "mask": ttree["mask"].numpy(),
                "meta": {k: v.numpy() for k, v in ttree["meta"].items()},
                "embed": {"table": ttree["embed"]["table"].numpy()},
                "blocks": ttree["blocks"]}
    assert encode_update(as_numpy) == encode_update(ttree)


def test_roundtrip_bit_exact_and_bare_leaf():
    jtree, ttree = _trees(3)
    back = decode_update(encode_update(ttree))
    assert encode_update(back) == encode_update(ttree)
    w = back["blocks"][1]["w"]
    assert isinstance(w, TernaryTensor) and w.shape == (3, 8, 6)
    np.testing.assert_array_equal(w.dequantize().numpy(),
                                  np.asarray(jtree["blocks"][1]["w"].dequantize()))
    assert back["meta"][3].item() == 12
    leaf = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert torch.equal(decode_update(encode_update(leaf)), leaf)


def test_bfloat16_leaves_roundtrip():
    x = torch.randn(4, 5).to(torch.bfloat16)
    back = decode_update(encode_update({"x": x}))["x"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, x)
    assert encode_update({"x": x}) == jwire.encode_update(
        {"x": jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)})


def test_frozen_v1_capture_decodes():
    with open(FIXTURE, "rb") as f:
        blob = f.read()
    assert _HEADER.unpack_from(blob)[1] == 1
    tree = decode_update(blob)
    rng = np.random.default_rng(42)
    i_t0 = rng.integers(-1, 2, size=(17, 9)).astype(np.int8)
    b0 = np.arange(7, dtype=np.float32) / 8.0
    i_t1 = rng.integers(-1, 2, size=(33,)).astype(np.int8)
    b1 = rng.normal(size=(3, 2)).astype(np.float32)
    head = rng.integers(0, 100, size=(4,)).astype(np.int32)
    w0, w1 = tree["blocks"][0]["w"], tree["blocks"][1]["w"]
    np.testing.assert_array_equal(w0.ternary().numpy(), i_t0)
    assert float(w0.w_q) == 0.625
    np.testing.assert_array_equal(tree["blocks"][0]["b"].numpy(), b0)
    np.testing.assert_array_equal(w1.ternary().numpy(), i_t1)
    assert w1.dtype == "bfloat16" and w1.dequantize().dtype == torch.bfloat16
    np.testing.assert_array_equal(tree["blocks"][1]["b"].numpy(), b1)
    np.testing.assert_array_equal(tree["head"].numpy(), head)
    assert encode_update(tree) == blob   # re-encodes to the same bytes


def test_every_truncation_raises_wire_error():
    _, ttree = _trees(4)
    blob = encode_update(ttree)
    for cut in range(0, len(blob)):
        with pytest.raises(WireError):
            decode_update(blob[:cut])


def test_every_bit_flip_raises_wire_error():
    blob = encode_update({"w": torch.arange(8.0), "t": TernaryTensor(
        packed=pack2bit(torch.tensor([1, 0, -1, 1, 1], dtype=torch.int8)),
        w_q=torch.tensor(0.5), shape=(5,))})
    for pos in range(len(blob)):
        if pos in (6, 7):   # the reserved flags field, unchecked like the reference
            continue
        for bit in range(8):
            bad = bytearray(blob)
            bad[pos] ^= 1 << bit
            if _HEADER.unpack_from(bad)[1] in (2, 3):
                continue    # RAW/TERNARY records are valid in v2/v3 buffers too
            with pytest.raises(WireError):
                decode_update(bytes(bad))


def test_malformed_records_raise_wire_error():
    blob = encode_update({"w": torch.arange(4.0)})
    body = bytearray(blob[_HEADER.size:])
    body[5] = 9   # kind byte: after path_len (2 B) and the path "d:w" (3 B)
    import zlib

    magic, ver, fl, n, _, bl = _HEADER.unpack_from(blob)
    bad = _HEADER.pack(magic, ver, fl, n, zlib.crc32(bytes(body)), bl) + bytes(body)
    with pytest.raises(WireError, match="unknown record kind"):
        decode_update(bad)
    extra = _HEADER.pack(magic, ver, fl, n + 1, zlib.crc32(blob[_HEADER.size:]), bl) \
        + blob[_HEADER.size:]
    with pytest.raises(WireError, match="truncated"):
        decode_update(extra)
    assert struct.calcsize("<4sHHIIQ") == _HEADER.size == 24


# --------------------------------------------------------------------------
# Record kinds 2–4, the record registry and version stamping.
# --------------------------------------------------------------------------


def _codec_trees(seed: int):
    """The same update with DOWNCAST (fp16 and bf16) and TOPK_DELTA (fp32
    and fp16 values) records beside RAW and TERNARY ones, as a reference
    tree and a port tree."""
    from repro.core import compression as jcomp
    from repro_torch.core import compression as comp

    rng = np.random.default_rng(seed)
    leaves = {"a": rng.normal(size=(20, 9)).astype(np.float32),
              "b": rng.normal(size=(33,)).astype(np.float32),
              "c": rng.normal(size=(6, 70)).astype(np.float32),
              "d": rng.normal(size=(1500,)).astype(np.float32)}
    specs = {"a": "fp16", "b": "bf16", "c": "topk", "d": "topk16"}
    jtree, ttree = {}, {}
    for name, kind in specs.items():
        jleaf = jcomp.get_codec(kind).encode_leaf(
            jnp.asarray(leaves[name]), jcomp.CodecSpec(kind=kind, topk_fraction=0.3))
        tleaf = comp.get_codec(kind).encode_leaf(
            torch.from_numpy(leaves[name]), comp.CodecSpec(kind=kind, topk_fraction=0.3))
        jtree[name], ttree[name] = jleaf, tleaf
    base_j, base_t = _trees(seed)
    jtree["base"], ttree["base"] = base_j, base_t
    return jtree, ttree


@pytest.mark.parametrize("seed", [0, 1])
def test_codec_records_byte_identical_to_reference(seed):
    """Kinds 2 and 4 beside kinds 0 and 1: the same buffer as the
    reference, stamped v3, decoding back to the same leaves and bytes."""
    from repro_torch.core.compression import DowncastTensor, TopKTensor

    jtree, ttree = _codec_trees(seed)
    blob = encode_update(ttree)
    assert blob == jwire.encode_update(jtree)
    assert _HEADER.unpack_from(blob)[1] == 3 and update_nbytes(ttree) == len(blob)
    back = decode_update(blob)
    assert isinstance(back["a"], DowncastTensor) and back["a"].data.dtype == torch.float16
    assert back["b"].data.dtype == torch.bfloat16 and back["b"].orig_dtype == "float32"
    for name in ("c", "d"):
        assert isinstance(back[name], TopKTensor) and back[name].indices.dtype == torch.int64
        np.testing.assert_array_equal(back[name].indices.numpy(),
                                      np.asarray(jtree[name].indices))
        assert torch.equal(back[name].values, ttree[name].values)
    assert back["d"].values.dtype == torch.float16
    assert encode_update(back) == blob


def test_minimal_version_stamping():
    """RAW/TERNARY-only traffic stays v1, byte for byte; a downcast record
    bumps the header to v2, a delta top-k record to v3."""
    from repro.core import compression as jcomp
    from repro_torch.core import CodecSpec, compress_pytree

    assert _HEADER.unpack_from(encode_update({"w": torch.ones(4, 4)}))[1] == 1
    jtree, ttree = _trees(5)
    assert encode_update(ttree) == jwire.encode_update(jtree)
    assert _HEADER.unpack_from(encode_update(ttree))[1] == 1
    for residual, version in (("fp16", 2), ("bf16", 2), ("topk", 3), ("topk16", 3)):
        tree, _ = compress_pytree({"b": torch.arange(24.0)}, CodecSpec(kind="none",
                                                                      residual=residual))
        jtree2, _ = jcomp.compress_pytree({"b": jnp.arange(24.0)},
                                          jcomp.CodecSpec(kind="none", residual=residual))
        blob = encode_update(tree)
        assert _HEADER.unpack_from(blob)[1] == version and blob == jwire.encode_update(jtree2)


def test_newer_record_in_older_buffer_is_rejected():
    """A v1 header carrying a v2 record, or a v2 header carrying a v3
    record, is malformed — as the reference's decoder says."""
    import zlib

    from repro_torch.core import CodecSpec, compress_pytree

    for residual, stamp, need in (("fp16", 1, 2), ("topk", 2, 3)):
        tree, _ = compress_pytree({"b": torch.arange(6.0)}, CodecSpec(kind="none",
                                                                     residual=residual))
        blob = encode_update(tree)
        magic, ver, fl, n, crc, bl = _HEADER.unpack_from(blob)
        old = _HEADER.pack(magic, stamp, fl, n, crc, bl) + blob[_HEADER.size:]
        for decode in (decode_update, jwire.decode_update):
            with pytest.raises((WireError, jwire.WireError), match=f"requires wire v{need}"):
                decode(old)
        assert zlib.crc32(blob[_HEADER.size:]) == crc


def _topk_leaves(indices, n, seed=3):
    from repro.core.compression import TopKTensor as JTopK
    from repro_torch.core.compression import TopKTensor

    idx = np.asarray(indices, np.uint32)
    vals = np.random.default_rng(seed).normal(size=idx.shape).astype(np.float32)
    return (JTopK(indices=jnp.asarray(idx), values=jnp.asarray(vals), shape=(n,)),
            TopKTensor(indices=torch.from_numpy(idx.astype(np.int64)),
                       values=torch.from_numpy(vals), shape=(n,)))


def test_topk_delta_byte_identical_and_fuzz_roundtrip():
    """Index 0, runs of gap 1, multi-byte gaps and every density: the
    reference's varint stream, decoding back to the same indices."""
    rng = np.random.default_rng(11)
    sets = [([0, 1, 2, 130, 16512, 2097300], 1 << 22)]
    for n, k in ((1, 1), (5, 3), (257, 17), (4096, 1000), (4096, 4096), (1 << 20, 9)):
        sets.append((np.sort(rng.choice(n, size=k, replace=False)), n))
    for idx, n in sets:
        jt, t = _topk_leaves(idx, n, seed=len(idx))
        blob = encode_update({"x": t})
        assert blob == jwire.encode_update({"x": jt})
        back = decode_update(blob)["x"]
        np.testing.assert_array_equal(back.indices.numpy(), np.asarray(idx, np.int64))
        assert back.shape == (n,) and back.dtype == "float32"
    first = np.asarray(sets[0][0], np.uint32)
    assert _varint_pack(first) == jwire._varint_pack(first)


def test_topk_varint_streams_raise_wire_error():
    """The encoder refuses non-ascending indices; CRC-valid but broken
    streams (a zero gap, an index past the shape, an unterminated varint, a
    count mismatch, a gap past uint32) raise ``WireError``, as the
    reference's do."""
    import zlib

    from repro_torch.comm.wire import _varint_unpack

    for bad in ([5, 2], [2, 2]):
        with pytest.raises(WireError, match="strictly ascending"):
            encode_update({"x": _topk_leaves(bad, 8)[1]})
    with pytest.raises(WireError, match="uint32"):
        from repro_torch.core.compression import TopKTensor

        encode_update({"x": TopKTensor(indices=torch.tensor([-1, 2]),
                                       values=torch.ones(2), shape=(8,))})
    blob = encode_update({"x": _topk_leaves([2, 5], 8)[1]})
    body = bytearray(blob[_HEADER.size:])
    pos = bytes(body).find(b"\x02\x03")
    assert pos > 0

    def fixed(b):
        magic, ver, fl, n, _, _ = _HEADER.unpack_from(blob)
        return _HEADER.pack(magic, ver, fl, n, zlib.crc32(bytes(b)), len(b)) + bytes(b)

    for byte, match in ((0x00, "ascending"), (0x7F, "out of range")):
        bad = bytearray(body)
        bad[pos + 1] = byte
        for decode in (decode_update, jwire.decode_update):
            with pytest.raises((WireError, jwire.WireError), match=match):
                decode(fixed(bad))
    for stream, k, match in ((b"\x82", 1, "unterminated"), (b"\x02\x03", 3, "carries 2"),
                             (b"\xff\xff\xff\xff\xff\x01", 1, "overflows"),
                             (b"\x01", 0, "trailing")):
        with pytest.raises(WireError, match=match):
            _varint_unpack(stream, k)
        with pytest.raises(jwire.WireError, match=match):
            jwire._varint_unpack(stream, k)


def test_legacy_topk_v2_buffer_decodes():
    """A v2 buffer framed with the raw-u32 TOPK record (kind 3), built by
    the reference's ``_topk_body``: the port decodes it (int64 indices,
    the same values) and never emits kind 3."""
    import zlib

    jt, t = _topk_leaves([1, 4, 6], 9)
    path = b"d:x"
    record = struct.pack("<H", len(path)) + path + struct.pack("<B", 3) + jwire._topk_body(jt)
    blob = _HEADER.pack(b"TFW1", 2, 0, 1, zlib.crc32(record), len(record)) + record
    back = decode_update(blob)["x"]
    assert back.indices.dtype == torch.int64
    np.testing.assert_array_equal(back.indices.numpy(), [1, 4, 6])
    assert torch.equal(back.values, t.values)
    assert encode_update({"x": back})[_HEADER.size + 2 + len(path)] == 4   # re-emitted as kind 4
    bad = bytearray(record)
    bad[bytes(record).find(struct.pack("<3I", 1, 4, 6)) + 8] = 9     # the last index 9 ≥ n
    blob = _HEADER.pack(b"TFW1", 2, 0, 1, zlib.crc32(bytes(bad)), len(bad)) + bytes(bad)
    with pytest.raises(WireError, match="out of range"):
        decode_update(blob)


def test_record_registry_guards():
    from repro_torch.comm.wire import _RECORDS, WireRecord, register_record

    assert {k: (r.name, r.min_version, r.encode) for k, r in _RECORDS.items()} == {
        k: (r.name, r.min_version, r.encode) for k, r in jwire._RECORDS.items()}
    with pytest.raises(ValueError, match="already registered"):
        register_record(WireRecord(0, "RAW2", None, lambda r: None, prepare=lambda x: x))
    with pytest.raises(ValueError, match="u8"):
        register_record(WireRecord(256, "BIG", None, lambda r: None, prepare=lambda x: x))


def test_encode_tensor_matches_reference():
    """``to_bytes`` is the reference's single-tensor buffer (header and a
    bare TERNARY body, stamped v1); ``from_bytes`` inverts it and raises
    ``WireError`` on corruption."""
    from repro_torch.comm.wire import decode_tensor, encode_tensor

    jtree, ttree = _trees(6)
    for jt, t in ((jtree["blocks"][0]["w"], ttree["blocks"][0]["w"]),
                  (jtree["blocks"][1]["w"], ttree["blocks"][1]["w"])):
        blob = t.to_bytes()
        assert blob == encode_tensor(t) == jt.to_bytes()
        assert _HEADER.unpack_from(blob)[1] == 1
        back = TernaryTensor.from_bytes(blob)
        assert torch.equal(back.packed, t.packed) and torch.equal(back.w_q, t.w_q)
        assert back.shape == tuple(t.shape)
        for cut in (0, 10, len(blob) - 1):
            with pytest.raises(WireError):
                decode_tensor(blob[:cut])
    with pytest.raises(WireError, match="expected 1 records"):
        decode_tensor(encode_update({"a": ttree["blocks"][0]["w"], "b": ttree["half"]}))


def test_every_truncation_of_a_codec_buffer_raises_wire_error():
    _, ttree = _codec_trees(2)
    blob = encode_update({k: ttree[k] for k in "abcd"})
    for cut in range(0, len(blob), 7):
        with pytest.raises(WireError):
            decode_update(blob[:cut])
