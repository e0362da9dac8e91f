"""Port vs reference: the codec registry (``core.compression``).

The cases of ``tests/test_codecs.py`` on the port, and each codec against
the JAX package on the same numpy tree: the wire buffers of ``fp16``,
``bf16``, ``topk`` and ``topk16`` (alone and as the residual codec, with
and without error feedback, over three encodes that carry the residual)
are sha256-identical, and the decodes and residuals bit-identical. The
tree holds top-k ties on purpose: zeros, −0.0 and repeated magnitudes.
The downcasts equal XLA's casts bit for bit at fp16-subnormal magnitudes,
at overflow, at bf16 ties and on NaNs (PyTorch's own casts write other NaN
bits; ``compression.narrow`` rewrites them). The ternary codec's scale
comes from tile sums summed in another order than XLA's (ROADMAP Queue 3),
so its codes are held exactly and its scale and residual within rtol 1e-6.
The asymmetric fp16-upstream run and the fp16 FedAvg run give the
reference's bytes exactly.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import ChannelConfig as JChannelConfig
from repro.comm import encode_update as jencode_update
from repro.core import compression as jcomp
from repro.core.ternary import encode_ternary as jencode_ternary
from repro.data import partition_iid as jpartition_iid
from repro.data import synthetic_classification as jsynthetic
from repro.fed import FedConfig as JFedConfig
from repro.fed import run_federated as jrun_federated
from repro.models.paper_models import init_mlp_mnist as jinit_mlp
from repro.models.paper_models import mlp_mnist as jmlp
from repro.optim import adam as jadam
from repro_torch.comm import WireError, decode_update, encode_update, update_nbytes
from repro_torch.comm.channel import ChannelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import (
    CodecSpec, CompressionSpec, DowncastTensor, TopKTensor, available_codecs,
    compress_pytree, decompress_pytree, get_codec, register_codec, wire_nbytes,
)
from repro_torch.core import compression as comp
from repro_torch.core.ternary import TernaryTensor, encode_ternary
from repro_torch.data.federated import partition_iid
from repro_torch.fed import FedConfig, run_federated
from repro_torch.models.paper_models import mlp_mnist
from repro_torch.optim import adam
from repro_torch.tree import flatten_with_path, path_str

torch.set_num_threads(1)

CODECS = ("fp16", "bf16", "topk", "topk16")


def _np_tree(seed: int = 0) -> dict:
    """A weight, a bias and a norm scale, with top-k ties in the weight."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(48, 24)).astype(np.float32)
    w[0, :6] = 0.0
    w[1, :4] = -0.0
    w[2, :3] = 0.5
    w[3, :3] = -0.5
    return {"layer": {"w": w, "bias": (0.1 * rng.normal(size=(24,))).astype(np.float32)},
            "norm_scale": (np.arange(8.0) / 8.0).astype(np.float32)}


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _ttree(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _sha(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()


def _bits(x) -> bytes:
    return (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)).tobytes()


def test_registry_ships_the_reference_codecs():
    assert available_codecs() == jcomp.available_codecs()
    assert {"none", "ternary", "fp16", "bf16", "topk", "topk16"} <= set(available_codecs())
    for name in available_codecs():
        assert get_codec(name).wire_kind == jcomp.get_codec(name).wire_kind, name
    with pytest.raises(ValueError, match="unknown codec"):
        get_codec("gzip")
    with pytest.raises(ValueError, match="unknown compression"):
        CodecSpec(kind="gzip")
    with pytest.raises(ValueError, match="topk_fraction"):
        CodecSpec(kind="topk", topk_fraction=0.0)
    with pytest.raises(ValueError, match="topk_fraction"):
        CodecSpec(kind="topk", topk_fraction=1.5)


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("kind,residual", [(k, r) for k in CODECS + ("none",)
                                           for r in ("none", "fp16", "topk")
                                           if (k, r) != ("none", "none")])
def test_codec_matches_reference(kind, residual, ef):
    """Three encodes of the same tree, each carrying the last residual:
    the buffers sha256-identical, decodes and residuals bit-identical."""
    tree = _np_tree(1)
    jspec = jcomp.CodecSpec(kind=kind, residual=residual, topk_fraction=0.3,
                            error_feedback=ef)
    spec = CodecSpec(kind=kind, residual=residual, topk_fraction=0.3, error_feedback=ef)
    jres = res = None
    for step in range(3):
        jwire, jres = jcomp.compress_pytree(_jtree(tree), jspec, residual=jres)
        wire, res = compress_pytree(_ttree(tree), spec, residual=res)
        blob = encode_update(wire)
        assert _sha(blob) == _sha(jencode_update(jwire)), (kind, residual, ef, step)
        assert wire_nbytes(wire) == len(blob) == jcomp.wire_nbytes(jwire)
        dec = decompress_pytree(decode_update(blob))
        for (path, got), want in zip(flatten_with_path(dec), jax.tree_util.tree_leaves(
                jcomp.decompress_pytree(jwire))):
            assert got.dtype == torch.float32 and _bits(got) == _bits(want), path
        if not ef:
            assert res is None and jres is None
            continue
        for (path, got), want in zip(flatten_with_path(res), jax.tree_util.tree_leaves(jres)):
            assert _bits(got) == _bits(want), (path, step)


@pytest.mark.parametrize("fused", [True, False])
def test_ternary_codec_error_feedback_matches_reference(fused):
    """The ternary codec with error feedback: codes exact, the whole-leaf
    scale and the residual within rtol 1e-6 (the scale's tile sums run in
    another order than XLA's)."""
    tree = _np_tree(2)
    jspec = jcomp.CodecSpec(kind="ternary", error_feedback=True, fused_encode=fused)
    spec = CodecSpec(kind="ternary", error_feedback=True, fused_encode=fused)
    jres = res = None
    for _ in range(3):
        jwire, jres = jcomp.compress_pytree(_jtree(tree), jspec, residual=jres)
        wire, res = compress_pytree(_ttree(tree), spec, residual=res)
        got, want = wire["layer"]["w"], jwire["layer"]["w"]
        assert isinstance(got, TernaryTensor)
        np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
        np.testing.assert_allclose(got.w_q.numpy(), np.asarray(want.w_q), rtol=1e-6)
        for (path, r), jr in zip(flatten_with_path(res), jax.tree_util.tree_leaves(jres)):
            np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6, atol=1e-6,
                                       err_msg=path_str(path))
    # the raw-shipped norm scale round-trips exactly: a zero residual
    assert float(res["norm_scale"].abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["fp16", "bf16"])
def test_downcast_edge_values_match_xla(kind):
    """fp16 subnormals (6e-8, 6.1e-5), overflow (65520 → inf), round-to-
    nearest-even ties in both formats, fp32 subnormals, ±inf and NaNs with
    and without payloads and signs: the wire payload bits equal XLA's."""
    vals = np.array([6e-8, -6e-8, 6.1e-5, 3e-8, 2.9e-8, 65504, 65519.99, 65520, -65520,
                     1e-40, 0.0, -0.0, np.inf, -np.inf, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8,
                     1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 3.0e38], np.float32)
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FA00000, 0xFFA00001],
                    np.uint32).view(np.float32)
    x = np.concatenate([vals, nans, np.random.default_rng(0).normal(size=1000).astype(
        np.float32) * 1e-3])
    wire, _ = compress_pytree({"b": torch.from_numpy(x)}, CodecSpec(kind="none", residual=kind))
    jwire, _ = jcomp.compress_pytree({"b": jnp.asarray(x)},
                                     jcomp.CodecSpec(kind="none", residual=kind))
    got = wire["b"].data.view(torch.uint16).numpy()
    want = np.asarray(jwire["b"].data).view(np.uint16)
    bad = [(float(v), hex(a), hex(b)) for v, a, b in zip(x, got, want) if a != b]
    assert not bad, bad[:8]
    assert wire["b"].data.dtype == {"fp16": torch.float16, "bf16": torch.bfloat16}[kind]
    assert encode_update(wire) == jencode_update(jwire)


def test_topk_ties_match_lax_top_k():
    """Ties (zeros, ±0.0, repeated magnitudes, NaN, ±inf) keep the lower
    index, as ``jax.lax.top_k`` does, at every k."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=500).astype(np.float32)
    a[::3], a[1::5] = 0.0, -0.0
    b = np.round(rng.normal(size=500), 1).astype(np.float32)
    c = rng.normal(size=500).astype(np.float32)
    c[::11], c[5], c[7], c[9] = np.nan, np.inf, -np.inf, -np.nan
    d = np.array([1, -1, 1, -1, 2, -2, 0, -0.0] * 4, np.float32)
    for x in (a, b, c, d, np.zeros(64, np.float32)):
        for k in sorted({1, 3, 8, 50, 333, x.size} & set(range(1, x.size + 1))):
            _, want = jax.lax.top_k(jnp.abs(jnp.asarray(x)), k)
            got = comp.topk_indices(torch.from_numpy(x), k)
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy(), np.sort(np.asarray(want)))


@pytest.mark.parametrize("kind", ["fp16", "bf16"])
def test_downcast_roundtrip_bitexact(kind):
    tree = _np_tree(1)
    wire, _ = compress_pytree(_ttree(tree), CodecSpec(kind=kind, residual=kind))
    back = decode_update(encode_update(wire))
    for a, b in ((wire["layer"]["w"], back["layer"]["w"]),
                 (wire["layer"]["bias"], back["layer"]["bias"])):
        assert isinstance(a, DowncastTensor) and isinstance(b, DowncastTensor)
        assert a.orig_dtype == b.orig_dtype == "float32"
        assert torch.equal(a.data, b.data)
    dec = decompress_pytree(back)
    assert dec["layer"]["w"].dtype == torch.float32
    assert update_nbytes(wire) < 0.6 * update_nbytes(_ttree(tree))


def test_topk_roundtrip_bitexact_and_sparse_decode():
    tree = _np_tree(2)
    wire, _ = compress_pytree(_ttree(tree), CodecSpec(kind="topk", residual="topk",
                                                      topk_fraction=0.125))
    t = wire["layer"]["w"]
    assert isinstance(t, TopKTensor) and t.n_elements == 48 * 24
    assert t.indices.numel() == int(np.ceil(0.125 * 48 * 24))
    back = decode_update(encode_update(wire))["layer"]["w"]
    assert back.indices.dtype == torch.int64
    assert torch.equal(back.indices, t.indices) and torch.equal(back.values, t.values)
    dec = decompress_pytree({"w": back})["w"].reshape(-1)
    orig = torch.from_numpy(tree["layer"]["w"]).reshape(-1)
    idx = t.indices
    assert torch.equal(dec[idx], orig[idx])
    mask = torch.ones(orig.numel(), dtype=torch.bool)
    mask[idx] = False
    assert bool((dec[mask] == 0).all())
    assert bool((orig[mask].abs() <= orig[idx].abs().min()).all())


def test_mixed_spec_quantizable_vs_residual_split():
    tree = _np_tree(3)
    wire, _ = compress_pytree(_ttree(tree), CodecSpec(kind="ternary", residual="fp16"))
    assert isinstance(wire["layer"]["w"], TernaryTensor)
    assert isinstance(wire["layer"]["bias"], DowncastTensor)
    assert isinstance(wire["norm_scale"], DowncastTensor)
    dec = decompress_pytree(decode_update(encode_update(wire)))
    np.testing.assert_allclose(dec["layer"]["bias"].numpy(), tree["layer"]["bias"],
                               rtol=2e-3, atol=2e-4)


def test_residual_codec_never_touches_non_float_leaves():
    """Step counters, rng keys and masks ship raw under every lossy
    residual codec, in the reference's bytes."""
    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(16, 8)).astype(np.float32),
            "step": np.asarray(100_000, np.int32),
            "rng": np.asarray([4059202431, 2870008242], np.uint32),
            "mask": np.asarray([True, False, True])}
    for residual in ("fp16", "bf16", "topk"):
        wire, _ = compress_pytree(_ttree(tree), CodecSpec(kind="none", residual=residual))
        jwire, _ = jcomp.compress_pytree(_jtree(tree), jcomp.CodecSpec(kind="none",
                                                                       residual=residual))
        assert encode_update(wire) == jencode_update(jwire), residual
        dec = decompress_pytree(decode_update(encode_update(wire)))
        assert int(dec["step"]) == 100_000, residual
        np.testing.assert_array_equal(dec["rng"].numpy(), tree["rng"])
        np.testing.assert_array_equal(dec["mask"].numpy(), tree["mask"])


def test_register_codec_rejects_duplicates_and_unframed_leaves():
    class FakeCodec:
        name = "fp16"
        wire_kind = comp.KIND_DOWNCAST
        leaf_type = DowncastTensor

    with pytest.raises(ValueError, match="already registered"):
        register_codec(FakeCodec())

    class KindThief:
        name = "kind-thief-test"
        wire_kind = comp.KIND_TERNARY
        leaf_type = DowncastTensor

    with pytest.raises(ValueError, match="reuses wire kind"):
        register_codec(KindThief())

    class OrphanLeaf:
        def __init__(self, data):
            self.data = data

    class OrphanCodec:
        name = "orphan-test"
        wire_kind = 200
        leaf_type = OrphanLeaf

        def encode_leaf(self, leaf, spec):
            return OrphanLeaf(leaf)

        def decode_leaf(self, leaf, device="cpu"):
            return leaf.data.to(device)

    register_codec(OrphanCodec())
    try:
        # a codec leaf without a wire record fails loudly at encode
        with pytest.raises(WireError, match="no .*record kind"):
            encode_update({"x": OrphanLeaf(torch.ones(3))})
        assert torch.equal(comp.decode_wire_leaf(OrphanLeaf(torch.ones(3))), torch.ones(3))
    finally:
        del comp._CODECS["orphan-test"]
    assert available_codecs() == jcomp.available_codecs()


def test_compress_finishes_partially_compressed_tree():
    """A QAT payload's ternary leaves pass through untouched; only the raw
    leaves get the residual codec, and with error feedback the passed
    leaf's residual is a scalar zero."""
    i_t = torch.from_numpy(np.random.default_rng(0).integers(-1, 2, (16, 8)).astype(np.int8))
    payload = {"w": encode_ternary(i_t, torch.tensor(0.5)), "b": torch.arange(4.0)}
    wire, _ = compress_pytree(payload, CodecSpec(kind="ternary", residual="bf16"))
    assert wire["w"] is payload["w"]
    assert isinstance(wire["b"], DowncastTensor)
    jpayload = {"w": jencode_ternary(jnp.asarray(i_t.numpy()), jnp.float32(0.5)),
                "b": jnp.arange(4.0)}
    spec = dict(kind="ternary", residual="bf16", error_feedback=True)
    wire, res = compress_pytree(payload, CodecSpec(**spec))
    jwire, jres = jcomp.compress_pytree(jpayload, jcomp.CodecSpec(**spec))
    assert encode_update(wire) == jencode_update(jwire)
    assert res["w"].shape == () and float(res["w"]) == 0.0
    assert _bits(res["b"]) == _bits(jres["b"])


def test_error_feedback_generic_over_codecs():
    """Error feedback makes the running mean of repeated top-k encodes
    converge on the input."""
    g = torch.from_numpy(np.random.default_rng(7).normal(size=(32, 16)).astype(np.float32))
    spec = CodecSpec(kind="topk", topk_fraction=0.2, error_feedback=True)
    res, acc, n = None, torch.zeros(32, 16), 15
    for _ in range(n):
        wire, res = compress_pytree({"w": g}, spec, residual=res)
        acc += decompress_pytree(wire)["w"]
    ef_err = float((acc / n - g).abs().mean())
    assert ef_err < 0.35 * float(g.abs().mean()) * 0.8   # plain top-k drops 80%


def test_nbytes_wire_derives_scale_bytes_from_wq_dtype():
    i_t = torch.from_numpy(np.random.default_rng(1).integers(-1, 2, (4, 8, 8)).astype(np.int8))
    t32 = encode_ternary(i_t, torch.ones((4, 1, 1)))
    t16 = encode_ternary(i_t, torch.ones((4, 1, 1), dtype=torch.bfloat16))
    packed = t32.packed.numel()
    assert t32.nbytes_wire() == packed + 4 * 4
    assert t16.nbytes_wire() == packed + 4 * 2
    scalar = encode_ternary(torch.tensor([1, -1, 0], dtype=torch.int8),
                            torch.tensor(0.5, dtype=torch.float16))
    assert scalar.nbytes_wire() == scalar.packed.numel() + 2
    jscalar = jencode_ternary(jnp.asarray([1, -1, 0], jnp.int8), jnp.float16(0.5))
    assert scalar.nbytes_wire() == jscalar.nbytes_wire()
    assert TernaryTensor(packed=np.zeros(3, np.uint8), w_q=0.5, shape=(9,)).nbytes_wire() == 11


# --------------------------------------------------------------------------
# The per-direction split through the servers, against the reference runs.
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fed_task():
    x, y, xt, yt = jsynthetic(jax.random.PRNGKey(0), 240, 10, 784, noise=3.0, n_test=50)
    return x, y, jinit_mlp(jax.random.PRNGKey(1))


def _runs(fed_task, jcfg_kw: dict, cfg_kw: dict):
    x, y, jparams = fed_task
    common = dict(participation=1.0, local_epochs=1, batch_size=32, rounds=2)
    ref = jrun_federated(jmlp, jparams, jpartition_iid(x, y, 4), JFedConfig(
        channel=JChannelConfig(mean_bandwidth_bytes_s=1e6), **common, **jcfg_kw),
        jadam(1e-3), lambda p: (0.0, 0.0), eval_every=2)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")

    def port(**kw):
        return run_federated(mlp_mnist, params, partition_iid(x, y, 4), FedConfig(
            channel=ChannelConfig(mean_bandwidth_bytes_s=1e6), **common, **kw), adam(1e-3),
            lambda p: (0.0, 0.0), eval_every=2, device="cpu")

    return ref, port(**cfg_kw), port


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_asymmetric_direction_bytes(fed_task, mode):
    """fp16 residuals upstream only: the reference's bytes and times
    exactly; upload shrinks and download holds against the port's
    ternary-both-ways run."""
    base = dict(algorithm="tfedavg", mode=mode, seed=3)
    up = dict(kind="ternary", residual="fp16")
    down = dict(kind="ternary", residual="none")
    ref, got, port = _runs(
        fed_task,
        dict(base, compression=jcomp.CompressionSpec(upstream=jcomp.CodecSpec(**up),
                                                     downstream=jcomp.CodecSpec(**down))),
        dict(base, compression=CompressionSpec(upstream=CodecSpec(**up),
                                               downstream=CodecSpec(**down))))
    assert got.upload_bytes == ref.upload_bytes
    assert got.download_bytes == ref.download_bytes
    assert got.round_times == ref.round_times
    plain = port(**base)
    assert got.upload_bytes < plain.upload_bytes
    assert got.download_bytes == plain.download_bytes


def test_fedavg_with_downcast_both_ways(fed_task):
    """FedAvg over an fp16 wire: the reference's bytes exactly, ~2× under
    the port's fp32 FedAvg run."""
    base = dict(algorithm="fedavg", seed=4)
    ref, got, port = _runs(
        fed_task, dict(base, compression=jcomp.CompressionSpec.symmetric("fp16", "fp16")),
        dict(base, compression=CompressionSpec.symmetric("fp16", "fp16")))
    assert (got.upload_bytes, got.download_bytes) == (ref.upload_bytes, ref.download_bytes)
    assert got.round_times == ref.round_times
    r32 = port(**base)
    assert 1.8 < r32.upload_bytes / got.upload_bytes < 2.2
    assert 1.8 < r32.download_bytes / got.download_bytes < 2.2


@pytest.mark.parametrize("kind", ["sign_flip", "scale_blowup", "gaussian", "nan_poison",
                                  "collude"])
def test_poisoned_codec_leaves_match_reference(kind):
    """An attacker's poison on downcast, top-k and raw leaves (fp16, bf16,
    fp32) gives the reference's blob byte for byte, and the content gate
    gives the reference's verdict on it (a bf16 payload is not checked,
    as numpy does not count it as floating)."""
    from repro.fed.attackers import AttackConfig as JAttackConfig
    from repro.fed.attackers import poison_blob as jpoison_blob
    from repro.fed.defense import DefenseConfig as JDefenseConfig
    from repro.fed.defense import UpdateGate as JUpdateGate
    from repro_torch.fed import AttackConfig, DefenseConfig, UpdateGate, poison_blob

    tree = _np_tree(4)
    tree["raw16"] = tree["layer"]["bias"][:5].astype(np.float16)
    for spec in (dict(kind="topk16", residual="fp16", topk_fraction=0.2),
                 dict(kind="bf16", residual="topk", topk_fraction=0.5)):
        wire, _ = compress_pytree(_ttree(tree), CodecSpec(**spec))
        jwire, _ = jcomp.compress_pytree(_jtree(tree), jcomp.CodecSpec(**spec))
        blob = encode_update(wire)
        assert blob == jencode_update(jwire)
        got = poison_blob(blob, AttackConfig(kind=kind, n_attackers=1, seed=2), 3, round_idx=1)
        want = jpoison_blob(blob, JAttackConfig(kind=kind, n_attackers=1, seed=2), 3,
                            round_idx=1)
        assert got == want, (kind, spec)
        verdicts = []
        for gate_cls, cfg_cls, ref in ((UpdateGate, DefenseConfig, wire),
                                       (JUpdateGate, JDefenseConfig, jwire)):
            gate = gate_cls(cfg_cls(enabled=True), ref)
            verdicts.append([(v.ok, v.reason) for v in map(gate.check, (blob, got))])
        assert verdicts[0] == verdicts[1], (kind, spec, verdicts)
        assert verdicts[0][0] == (True, "")
