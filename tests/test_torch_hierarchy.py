"""Port vs reference: the client → edge → root tier (``fed.hierarchy``).

The cases of ``tests/test_hierarchy.py`` on the port: edge placement, the
config guards, the lossless tier bit for bit against a flat aggregator on
integer-valued fp32 inputs, real ternary payloads within 1e-5, cohort adds,
a requantizing edge against ``server_requantize``, and the byte ledger
across folds. Then the sync and async servers with two edges against the
JAX runs on the MLP: bytes, simulated times and the tier's telemetry and
ledger exactly, the global model within ``PARAM_ATOL`` per element with
the flips allowance of ``test_torch_fed.py`` (a requantizing edge takes its
scale from tile sums summed in another order than XLA's, so a code may flip
where a value sits within an ulp of Δ).

The reference's mixed-codec variant of the general-inputs case (fp16
residuals on every other client) waits for the port's downcast codecs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.wire import encode_update as jencode_update
from repro.core import FTTQConfig as JFTTQConfig
from repro.core import fttq as jfttq
from repro.core.tfedavg import client_update_payload as jclient_update_payload
from repro.data import partition_iid as jpartition_iid
from repro.data import synthetic_classification as jsynthetic
from repro.fed import FedConfig as JFedConfig
from repro.fed import run_federated as jrun_federated
from repro.fed.hierarchy import EdgeTier as JEdgeTier
from repro.fed.hierarchy import HierarchyConfig as JHierarchyConfig
from repro.fed.hierarchy import edge_of as jedge_of
from repro.models.paper_models import init_mlp_mnist as jinit_mlp
from repro.models.paper_models import mlp_mnist as jmlp
from repro.optim import adam as jadam
from repro_torch.comm.wire import encode_update
from repro_torch.convert import params_from_jax
from repro_torch.core.fttq import FTTQConfig
from repro_torch.core.tfedavg import server_requantize
from repro_torch.data.federated import partition_iid
from repro_torch.fed import EdgeTier, HierarchyConfig, edge_of, edges_of
from repro_torch.fed.aggregator import Aggregator
from repro_torch.fed.simulation import FedConfig, run_federated
from repro_torch.models.paper_models import mlp_mnist
from repro_torch.optim import adam
from repro_torch.tree import flatten_with_path, path_str

torch.set_num_threads(1)

CFG = FTTQConfig()
PARAM_ATOL = 2e-6                    # as tests/test_torch_fed.py
FLIPS_PER_ELEMENT = 1e-4


def _flat(tree) -> dict:
    return {path_str(p): leaf for p, leaf in flatten_with_path(tree)}


def _jflat(tree) -> dict:
    return {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_bit_identical(a, b) -> None:
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for path, x in fa.items():
        assert x.dtype == fb[path].dtype, path
        assert torch.equal(x, fb[path]), path


def _exact_tree(rng) -> dict:
    """Integer-valued fp32 leaves, so every sum and mean below is exact in
    fp32: ragged (n % 4 ≠ 0), stacked, bias and an int counter."""
    def ints(shape):
        return rng.integers(-8, 9, size=shape).astype(np.float32)

    return {"enc": {"w": ints((17, 9)), "b": ints((9,))},
            "stack": {"w": ints((3, 8, 12))},
            "head": {"w": ints((12, 5))},
            "steps": np.asarray(7, np.int32)}


def _blob(tree: dict) -> bytes:
    """The port's wire buffer of a numpy tree; the reference's is the same."""
    blob = encode_update(jax.tree_util.tree_map(torch.from_numpy, tree))
    assert blob == jencode_update(jax.tree_util.tree_map(jnp.asarray, tree))
    return blob


# --------------------------------------------------------------------------
# Edge placement and guards.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("assignment", ["mod", "block"])
def test_edges_of_matches_edge_of_and_reference(assignment):
    cfg = HierarchyConfig(n_edges=7, assignment=assignment)
    jcfg = JHierarchyConfig(n_edges=7, assignment=assignment)
    ids = np.arange(100)
    vec = edges_of(ids, 100, cfg)
    assert vec.tolist() == [edge_of(int(k), 100, cfg) for k in ids]
    assert vec.tolist() == [jedge_of(int(k), 100, jcfg) for k in ids]
    assert vec.min() >= 0 and vec.max() < 7


def test_hierarchy_config_guards(monkeypatch):
    assert not HierarchyConfig().enabled
    assert HierarchyConfig(n_edges=4).enabled
    with pytest.raises(ValueError, match="n_edges"):
        EdgeTier(HierarchyConfig(n_edges=0), CFG, 10, device="cpu")
    for fn in (edge_of, edges_of):
        with pytest.raises(ValueError, match="assignment"):
            fn(0, 10, HierarchyConfig(n_edges=2, assignment="nope"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EdgeTier(HierarchyConfig(n_edges=2), CFG, 10)


# --------------------------------------------------------------------------
# Tier equivalence.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_edges,assignment", [(1, "mod"), (2, "mod"), (4, "mod"),
                                                (2, "block")])
def test_lossless_tier_bit_identical_to_flat(n_edges, assignment):
    """requantize_at_edge=False on exact fp32 inputs: the 2-tier mean equals
    one flat aggregator over the union of clients and the reference tier,
    bit for bit."""
    rng = np.random.default_rng(0)
    n_clients = 8
    blobs = [_blob(_exact_tree(rng)) for _ in range(n_clients)]
    hier = dict(n_edges=n_edges, requantize_at_edge=False, assignment=assignment,
                edge_chunk_c=4)
    flat = Aggregator(chunk_c=4, device="cpu")
    tier = EdgeTier(HierarchyConfig(**hier), CFG, n_clients, device="cpu")
    jtier = JEdgeTier(JHierarchyConfig(**hier), JFTTQConfig(), n_clients)
    for k, b in enumerate(blobs):
        flat.add(b, weight=1.0)
        tier.add(k, b, weight=1.0)
        jtier.add(k, b, weight=1.0)
    mean_tier, info = tier.fold()
    jmean, jinfo = jtier.fold()
    assert info == jinfo and info["edges_active"] == n_edges
    _assert_bit_identical(flat.finalize(), mean_tier)
    want = _jflat(jmean)
    for path, leaf in _flat(mean_tier).items():
        np.testing.assert_array_equal(leaf.numpy(), want[path], err_msg=path)
    assert tier.telemetry() == jtier.telemetry()


def test_lossless_tier_close_to_flat_on_ternary_payloads():
    """Real ternary client payloads (made by the reference) and general fp
    inputs: the 2-tier mean within 1e-5 of the flat one and of the
    reference tier."""
    jcfg = JFTTQConfig()
    blobs = []
    for c in range(6):
        k = jax.random.split(jax.random.PRNGKey(c), 3)
        params = {"enc": {"w": jax.random.normal(k[0], (17, 9))},
                  "stack": {"w": jax.random.normal(k[1], (3, 8, 12))},
                  "head": {"b": jax.random.normal(k[2], (5,))}}
        blobs.append(jencode_update(jclient_update_payload(
            params, jfttq.init_wq_tree(params, jcfg), jcfg)))
    hier = dict(n_edges=3, requantize_at_edge=False)
    flat = Aggregator(chunk_c=4, device="cpu")
    tier = EdgeTier(HierarchyConfig(**hier), CFG, len(blobs), device="cpu")
    jtier = JEdgeTier(JHierarchyConfig(**hier), jcfg, len(blobs))
    for k, b in enumerate(blobs):
        for agg in (flat, tier, jtier):
            if isinstance(agg, Aggregator):
                agg.add(b, weight=10.0 + 3 * k)
            else:
                agg.add(k, b, weight=10.0 + 3 * k)
    want_flat, got = _flat(flat.finalize()), _flat(tier.fold()[0])
    want_ref = _jflat(jtier.fold()[0])
    assert want_flat.keys() == got.keys() == want_ref.keys()
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf.numpy(), want_flat[path].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=path)
        np.testing.assert_allclose(leaf.numpy(), want_ref[path], rtol=1e-5, atol=1e-5,
                                   err_msg=path)


def test_lossless_tier_close_to_flat_on_mixed_codec_payloads():
    """The general-inputs case with fp16 residual leaves on every other
    client (a mixed-codec fold: the fp16 records take the dense fallback):
    the 2-tier mean within 1e-5 of the flat one and of the reference tier."""
    from repro.core import compression as jcomp

    jcfg = JFTTQConfig()
    spec = jcomp.CodecSpec(kind="ternary", residual="fp16", fttq=jcfg)
    blobs = []
    for c in range(6):
        k = jax.random.split(jax.random.PRNGKey(c), 3)
        params = {"enc": {"w": jax.random.normal(k[0], (17, 9))},
                  "stack": {"w": jax.random.normal(k[1], (3, 8, 12))},
                  "head": {"b": jax.random.normal(k[2], (5,))}}
        payload = jclient_update_payload(params, jfttq.init_wq_tree(params, jcfg), jcfg)
        if c % 2:
            payload, _ = jcomp.compress_pytree(payload, spec)
        blobs.append(jencode_update(payload))
    hier = dict(n_edges=3, requantize_at_edge=False)
    flat = Aggregator(chunk_c=4, device="cpu")
    tier = EdgeTier(HierarchyConfig(**hier), CFG, len(blobs), device="cpu")
    jtier = JEdgeTier(JHierarchyConfig(**hier), jcfg, len(blobs))
    for k, b in enumerate(blobs):
        flat.add(b, weight=10.0 + 3 * k)
        tier.add(k, b, weight=10.0 + 3 * k)
        jtier.add(k, b, weight=10.0 + 3 * k)
    want_flat, got = _flat(flat.finalize()), _flat(tier.fold()[0])
    want_ref = _jflat(jtier.fold()[0])
    assert want_flat.keys() == got.keys() == want_ref.keys()
    for path, leaf in got.items():
        assert leaf.dtype == torch.float32, path
        np.testing.assert_allclose(leaf.numpy(), want_flat[path].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=path)
        np.testing.assert_allclose(leaf.numpy(), want_ref[path], rtol=1e-5, atol=1e-5,
                                   err_msg=path)


def test_cohort_add_equals_individual_adds():
    """add_cohort(w = Σ w_k, n) folds like n adds of the byte-identical blob
    (power-of-two weights keep the sums exact) and books n× the bytes."""
    rng = np.random.default_rng(3)
    blob = _blob(_exact_tree(rng))
    other = _blob(_exact_tree(rng))
    a = EdgeTier(HierarchyConfig(n_edges=2), CFG, 8, device="cpu")
    for k in (0, 2, 4, 6):
        a.add(k, blob, weight=2.0)
    a.add(1, other, weight=4.0)
    b = EdgeTier(HierarchyConfig(n_edges=2), CFG, 8, device="cpu")
    b.add_cohort(0, blob, weight=8.0, n_clients=4)
    b.add(1, other, weight=4.0)
    assert a.pending_clients == b.pending_clients == 5
    _assert_bit_identical(a.fold()[0], b.fold()[0])
    ta, tb = a.telemetry(), b.telemetry()
    assert ta["client_to_edge_bytes"] == tb["client_to_edge_bytes"] == 4 * len(blob) + len(other)
    assert ta["clients_per_edge"] == tb["clients_per_edge"] == [4, 1]


# --------------------------------------------------------------------------
# Edge requantization.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False])
def test_requantize_tier_single_edge_matches_server_requantize(fused):
    """One requantizing edge: its fold is server_requantize(edge mean) over
    the wire, folded by a root aggregator, bit for bit."""
    rng = np.random.default_rng(1)
    blobs = [_blob(_exact_tree(rng)) for _ in range(4)]
    flat = Aggregator(chunk_c=4, device="cpu")
    tier = EdgeTier(HierarchyConfig(n_edges=1), CFG, 4, fused_encode=fused, device="cpu")
    for k, b in enumerate(blobs):
        flat.add(b, weight=1.0)
        tier.add(k, b, weight=1.0)
    root = Aggregator(chunk_c=16, device="cpu")
    root.add(encode_update(server_requantize(flat.finalize(), CFG, fused=fused)), weight=4.0)
    _assert_bit_identical(root.finalize(), tier.fold()[0])


def test_requantize_shrinks_upstream_bytes_as_the_reference():
    """The edge→root hop ships 2-bit codes: far fewer bytes than the dense
    record, and exactly the reference tier's count both ways."""
    rng = np.random.default_rng(5)
    blob = _blob({"w1": rng.normal(size=(64, 64)).astype(np.float32),
                  "w2": rng.normal(size=(64, 32)).astype(np.float32)})
    outs = {}
    for requant in (False, True):
        tier = EdgeTier(HierarchyConfig(n_edges=1, requantize_at_edge=requant), CFG, 4,
                        device="cpu")
        jtier = JEdgeTier(JHierarchyConfig(n_edges=1, requantize_at_edge=requant),
                          JFTTQConfig(), 4)
        for c in range(4):
            tier.add(c, blob, weight=1.0)
            jtier.add(c, blob, weight=1.0)
        tier.fold()
        jtier.fold()
        outs[requant] = int(tier.upstream_bytes.sum())
        assert outs[requant] == int(jtier.upstream_bytes.sum())
    assert outs[True] < outs[False] / 3, outs


def test_ledger_balances_and_accumulates_across_folds():
    rng = np.random.default_rng(2)
    blob = _blob(_exact_tree(rng))
    tier = EdgeTier(HierarchyConfig(n_edges=2), CFG, 8, device="cpu")
    jtier = JEdgeTier(JHierarchyConfig(n_edges=2), JFTTQConfig(), 8)
    for round_ in range(3):
        for k in range(6):
            tier.add(k, blob, weight=1.0, staleness=float(round_))
            jtier.add(k, blob, weight=1.0, staleness=float(round_))
        tier.fold()
        jtier.fold()
    tier.note_quarantined(123)
    jtier.note_quarantined(123)
    t = tier.telemetry()
    assert t == jtier.telemetry()
    assert t["ledger_balanced"]
    assert t["client_to_edge_bytes"] == 3 * 6 * len(blob)
    assert t["edge_to_root_bytes"] == t["root_ingest_bytes"] > 0
    assert t["folds"] == 3 and sum(t["clients_per_edge"]) == 18
    assert sum(t["bytes_per_edge"]) == t["client_to_edge_bytes"]
    assert sum(t["upstream_bytes_per_edge"]) == t["edge_to_root_bytes"]
    assert t["mean_staleness_per_edge"] == [1.0, 1.0]
    assert (t["quarantined_updates"], t["quarantined_bytes"]) == (1, 123)
    with pytest.raises(ValueError, match="no client updates"):
        tier.fold()


# --------------------------------------------------------------------------
# Both servers with the tier on, against the JAX runs.
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def task():
    x, y, xt, yt = jsynthetic(jax.random.PRNGKey(0), 360, 10, 784, noise=3.0, n_test=100)
    return x, y, jinit_mlp(jax.random.PRNGKey(1))


def _recording(seen, to_numpy):
    def eval_fn(params):
        seen.append({path_str(p): to_numpy(leaf) for p, leaf in flatten_with_path(params)})
        return 0.0, 0.0

    return eval_fn


@pytest.mark.parametrize("mode,requant", [("sync", True), ("async", True), ("async", False)])
def test_servers_with_the_tier_match_reference(task, mode, requant):
    x, y, jparams = task
    common = dict(algorithm="tfedavg", mode=mode, participation=1.0, local_epochs=1,
                  batch_size=32, rounds=3, buffer_k=3, seed=2)
    hier = dict(n_edges=2, requantize_at_edge=requant)
    ref_params, got_params = [], []
    ref = jrun_federated(jmlp, jparams, jpartition_iid(x, y, 6),
                         JFedConfig(hierarchy=JHierarchyConfig(**hier), **common), jadam(2e-3),
                         _recording(ref_params, np.asarray), eval_every=1)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    got = run_federated(mlp_mnist, params, partition_iid(x, y, 6),
                        FedConfig(hierarchy=HierarchyConfig(**hier), **common), adam(2e-3),
                        _recording(got_params, lambda t: t.numpy().copy()), eval_every=1,
                        device="cpu")
    hier_t = got.telemetry["hierarchy"]
    assert hier_t == ref.telemetry["hierarchy"]
    assert hier_t["ledger_balanced"] and hier_t["folds"] == 3
    assert got.upload_bytes == ref.upload_bytes == (hier_t["client_to_edge_bytes"]
                                                    + hier_t["edge_to_root_bytes"])
    assert got.download_bytes == ref.download_bytes
    assert got.round_times == ref.round_times
    assert got.participants_per_round == ref.participants_per_round
    assert got.transfer_summary == ref.transfer_summary
    if mode == "async":
        assert got.staleness_per_agg == ref.staleness_per_agg
        assert got.telemetry["staleness_hist"] == ref.telemetry["staleness_hist"]
    else:
        assert (got.telemetry["upload_bytes_per_round"]
                == ref.telemetry["upload_bytes_per_round"])
    assert len(got_params) == len(ref_params) == 3
    for r, (want, have) in enumerate(zip(ref_params, got_params)):
        assert sorted(have) == sorted(want)
        for path, a in have.items():
            gap = np.abs(a - want[path])
            allowed = int(FLIPS_PER_ELEMENT * a.size) if a.ndim >= 2 else 0
            assert int((gap > PARAM_ATOL).sum()) <= allowed, (r, path, float(gap.max()))
