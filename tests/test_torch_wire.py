"""Port vs reference: TFW1 buffers byte-identical for the same numpy tree of
RAW and TERNARY leaves, the frozen v1 capture decodes, the size pass equals
the buffer length, and corrupted or truncated buffers raise ``WireError``."""

import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import wire as jwire
from repro.core.ternary import TernaryTensor as JTernary
from repro_torch.comm.wire import (
    _HEADER, WireError, decode_update, encode_update, update_nbytes,
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
