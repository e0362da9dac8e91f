"""Port vs reference: the adaptive compression controller
(``fed.controller``) and mixed-codec folds.

The cases of ``tests/test_controller.py`` that need no federated run (the
runs are in ``test_torch_controller_runs.py``), plus:

  - the policy is a pure function of its observations, and one fed-in
    sequence of observations gives the reference's rung sequence
    (``CompressionController``) and trajectory (``FleetCohortController``);
  - one controller's uploads of the same trained trees are the reference's
    blobs sha256 for sha256, on every aggressive rung, with bit-identical
    residuals whose norms agree within rtol 1e-9;
  - the mixed-codec ``Aggregator`` bit for bit against the reference's on
    the same blobs, in both upload orders, and reused after a mixed round.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fed.controller as jcontroller_mod
from repro.comm import encode_update as jencode_update
from repro.core import compression as jcomp
from repro.core import fttq as jfttq
from repro.fed import Aggregator as JAggregator
from repro.fed import ControllerConfig as JControllerConfig
from repro.fed import FedConfig as JFedConfig
from repro_torch.comm import decode_update, encode_update
from repro_torch.core import CodecSpec, compress_pytree, decompress_pytree
from repro_torch.core.fttq import init_wq_tree
from repro_torch.fed import (
    Aggregator, CompressionController, ControllerConfig, FedConfig, FleetCohortController,
    make_controller,
)
from repro_torch.fed.controller import LADDER, tree_l2
from repro_torch.tree import flatten_with_path, path_str

torch.set_num_threads(1)


def _np_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"layer": {"w": rng.normal(size=(48, 24)).astype(np.float32),
                      "bias": (0.1 * rng.normal(size=(24,))).astype(np.float32)},
            "norm_scale": (np.arange(8.0) / 8.0).astype(np.float32)}


def _ttree(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


# --------------------------------------------------------------------------
# Error feedback.
# --------------------------------------------------------------------------


def test_error_feedback_residual_roundtrip():
    """Σ decode_t = n·tree − residual_n: the running mean of the decodes
    beats a one-shot encode, and the carried residual stays bounded."""
    tree = _ttree(_np_tree(2))
    ef_spec = CodecSpec(kind="topk", topk_fraction=0.1, error_feedback=True)
    acc = jax.tree_util.tree_map(torch.zeros_like, tree)
    res, n = None, 6
    for _ in range(n):
        wire, res = compress_pytree(tree, ef_spec, residual=res)
        dec = decompress_pytree(wire)
        acc = jax.tree_util.tree_map(torch.add, acc, dec)
    mean = jax.tree_util.tree_map(lambda a: a / n, acc)

    def rel_err(got):
        return tree_l2(jax.tree_util.tree_map(torch.sub, got, tree)) / tree_l2(tree)

    one_shot, no_res = compress_pytree(tree, CodecSpec(kind="topk", topk_fraction=0.1))
    assert no_res is None
    assert rel_err(mean) < rel_err(decompress_pytree(one_shot))
    for _ in range(2 * n):
        _, res = compress_pytree(tree, ef_spec, residual=res)
    assert tree_l2(res) < tree_l2(tree) / ef_spec.topk_fraction


def test_error_feedback_off_matches_legacy_bytes():
    tree = _ttree(_np_tree(5))
    spec = CodecSpec(kind="topk16", topk_fraction=0.2)
    (wire_a, res_a), (wire_b, res_b) = compress_pytree(tree, spec), compress_pytree(tree, spec)
    assert res_a is None and res_b is None
    assert encode_update(wire_a) == encode_update(wire_b)


def test_residual_tree_shapes_match_input():
    tree = _ttree(_np_tree(7))
    _, res = compress_pytree(tree, CodecSpec(kind="ternary", error_feedback=True))
    for (_, got), (_, want) in zip(flatten_with_path(res), flatten_with_path(tree)):
        assert got.shape == want.shape
    assert float(res["norm_scale"].abs().max()) == 0.0


# --------------------------------------------------------------------------
# The policy.
# --------------------------------------------------------------------------


def test_controller_policy_is_pure_function_of_observations():
    fed = FedConfig(controller=ControllerConfig(warmup_encodes=1, divergence_high=0.05,
                                                slow_factor=0.5))

    def drive():
        c = CompressionController(fed.controller, fed)
        rungs = []
        for r in range(5):
            c.note_round(r)
            c.observe_upload(0, 10_000, 1.0)     # slow client
            c.observe_upload(1, 10_000, 0.01)    # fast client
            rungs.append((c.select(0), c.select(1)))
            for k in (0, 1):
                c._encodes[k] = c._encodes.get(k, 0) + 1
        return rungs

    first = drive()
    assert first == drive()
    assert first[0] == ("ternary", "ternary")
    assert first[-1] == ("topk16", "ternary")
    assert all(rung in LADDER for pair in first for rung in pair)


def test_select_sequence_matches_reference():
    """One seeded stream of goodput and divergence observations over five
    clients through both controllers: the same rung at every step."""
    kw = dict(warmup_encodes=2, divergence_high=0.05, slow_factor=0.5, fast_factor=1.5,
              aggressive_rung="topk", fidelity_rung="bf16", ewma=0.3)
    c = CompressionController(ControllerConfig(**kw), FedConfig())
    jc = jcontroller_mod.CompressionController(JControllerConfig(**kw), JFedConfig())
    rng = np.random.default_rng(0)
    base = rng.normal(size=(32, 8)).astype(np.float32)
    seen = []
    for step in range(60):
        k = int(rng.integers(0, 5))
        nbytes, seconds = int(rng.integers(1_000, 50_000)), float(rng.uniform(0.01, 2.0))
        moved = base + float(rng.choice([0.01, 0.2])) * rng.normal(size=base.shape).astype(
            np.float32)
        for ctrl, conv in ((c, torch.from_numpy), (jc, jnp.asarray)):
            ctrl.note_round(step // 10)
            ctrl.observe_upload(k, nbytes, seconds)
            ctrl._observe_divergence(k, {"w": conv(moved)}, {"w": conv(base)})
        rung = c.select(k)
        assert rung == jc.select(k), step
        seen.append(rung)
        for ctrl in (c, jc):
            ctrl._encodes[k] = ctrl._encodes.get(k, 0) + 1
    assert c._goodput == jc._goodput
    for k in c._divergence:
        assert c._divergence[k] == pytest.approx(jc._divergence[k], rel=1e-9)
    assert {"ternary", "topk", "bf16"} <= set(seen)


def test_fleet_controller_matches_reference():
    """Fast, then slow, then fast rounds with seeded jitter: the same rung
    trajectory and telemetry as the reference."""
    kw = dict(warmup_encodes=2, slow_factor=0.5, ewma=0.4)
    f, jf = FleetCohortController(ControllerConfig(**kw)), \
        jcontroller_mod.FleetCohortController(JControllerConfig(**kw))
    rng = np.random.default_rng(1)
    for step in range(30):
        seconds = float(rng.uniform(0.5, 1.5)) * (4.0 if 10 <= step < 20 else 1.0)
        obs = (int(rng.integers(900_000, 1_100_000)), seconds if step != 5 else 0.0)
        assert f.select() == jf.select()
        f.observe_round(*obs)
        jf.observe_round(*obs)
    assert f.telemetry() == jf.telemetry()
    assert f.rung_per_round[:2] == ["ternary", "ternary"]
    assert "topk16" in f.rung_per_round[10:20] and f.rung_per_round[-1] == "ternary"


def test_controller_config_validation():
    for bad, match in ((dict(aggressive_rung="gzip"), "ladder"), (dict(ewma=1.5), "ewma"),
                       (dict(residual_codec="nope"), "residual_codec"),
                       (dict(fidelity_rung="none"), "ladder")):
        with pytest.raises(ValueError, match=match):
            ControllerConfig(**bad)
        with pytest.raises(ValueError, match=match):
            JControllerConfig(**bad)
    assert LADDER == jcontroller_mod.LADDER
    assert make_controller(FedConfig(controller=None)) is None
    assert make_controller(FedConfig(controller=ControllerConfig(enabled=False))) is None


@pytest.mark.parametrize("rung", [r for r in LADDER if r != "ternary"])
def test_client_payload_matches_reference_on_the_same_trees(rung):
    """The same trained trees through both controllers: a warmup ternary
    upload (the trained w_q), then two uploads on ``rung`` carrying the
    residual — the blobs sha256-identical, the residuals bit-identical and
    their norms within rtol 1e-9."""
    kw = dict(warmup_encodes=1, divergence_high=1e9, aggressive_rung=rung,
              residual_codec="fp16", topk_fraction=0.1)
    ctrl = CompressionController(ControllerConfig(**kw), FedConfig())
    jctrl = jcontroller_mod.CompressionController(JControllerConfig(**kw), JFedConfig())
    start = _np_tree(0)
    for step in range(3):
        trained = jax.tree_util.tree_map(
            lambda a: (a + 0.05 * np.random.default_rng(step).normal(size=a.shape)).astype(
                np.float32), start)
        wq = init_wq_tree(_ttree(trained), ctrl.fed.fttq)
        jwq = jfttq.init_wq_tree(jax.tree_util.tree_map(jnp.asarray, trained), jctrl.fed.fttq)
        # the same w_q on both sides: the port's factor is within an ulp of XLA's
        wq = {"layer": {"w": torch.from_numpy(np.array(jwq["layer"]["w"])), "bias": None},
              "norm_scale": None}
        blob = ctrl.client_payload(0, _ttree(trained), wq, _ttree(start))
        jblob = jctrl.client_payload(0, jax.tree_util.tree_map(jnp.asarray, trained), jwq,
                                     jax.tree_util.tree_map(jnp.asarray, start))
        assert blob == jblob, (rung, step)
        for (path, r), jr in zip(flatten_with_path(ctrl._residual[0]),
                                 jax.tree_util.tree_leaves(jctrl._residual[0])):
            assert r.numpy().tobytes() == np.asarray(jr).tobytes(), (rung, step, path)
    tel, jtel = ctrl.telemetry(), jctrl.telemetry()
    np.testing.assert_allclose(tel.pop("residual_l2_per_round"),
                               jtel.pop("residual_l2_per_round"), rtol=1e-9)
    assert tel == jtel
    assert tel["rung_counts_per_round"] == [{"ternary": 1, rung: 2}]


# --------------------------------------------------------------------------
# Mixed-codec rounds through the Aggregator.
# --------------------------------------------------------------------------


def _client_blob(seed: int, kind: str) -> bytes:
    """A reference-encoded upload of a weight and a bias under ``kind``."""
    rng = np.random.default_rng(seed)
    tree = {"w": jnp.asarray(rng.normal(size=(16, 8)).astype(np.float32)),
            "bias": jnp.asarray(rng.normal(size=(8,)).astype(np.float32))}
    wire, _ = jcomp.compress_pytree(tree, jcomp.CodecSpec(kind=kind, topk_fraction=0.25))
    return jencode_update(wire)


def _assert_equal_folds(got, want):
    for path, leaf in flatten_with_path(got):
        ref = np.asarray(want[path_str(path)])
        assert leaf.dtype == torch.float32
        assert leaf.numpy().tobytes() == ref.tobytes(), path_str(path)


@pytest.mark.parametrize("kinds", [("ternary", "topk16", "ternary", "fp16"),
                                   ("topk16", "ternary", "ternary"),
                                   ("fp16", "ternary", "topk", "bf16", "ternary")])
def test_mixed_codec_round_matches_reference(kinds):
    """The fold's table is planned from the first upload: a ternary first
    folds the later ternary uploads on the kernel and the rest through the
    dense fallback; a top-k or fp16 first puts every upload in the
    fallback. Either way bit for bit with the reference Aggregator."""
    blobs = [_client_blob(i, kind) for i, kind in enumerate(kinds)]
    weights = [1.0, 3.0, 2.5, 7.0, 0.5][:len(blobs)]
    agg, jagg = Aggregator(chunk_c=2, device="cpu"), JAggregator(chunk_c=2, rule="mean")
    for blob, w in zip(blobs, weights):
        agg.add(blob, weight=w)
        jagg.add(blob, weight=w)
    got, want = agg.finalize(), jagg.finalize()
    _assert_equal_folds(got, {k: v for k, v in want.items()})
    dense = [decompress_pytree(decode_update(b)) for b in blobs]
    ref = {k: sum(w * d[k] for w, d in zip(weights, dense)) / sum(weights) for k in got}
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(), rtol=1e-5, atol=1e-6)


def test_mixed_codec_reset_keeps_pure_ternary_rounds_exact():
    """A reused aggregator that saw a mixed round folds a later pure
    ternary round bit for bit like a fresh one, and like the reference
    reused the same way (whose mixed fold is waited on before its reset
    zeroes the fallback it still reads; ROADMAP Queue 3)."""
    t_blobs = [_client_blob(i, "ternary") for i in range(2)]
    fresh = Aggregator(chunk_c=4, device="cpu")
    for b in t_blobs:
        fresh.add(b, weight=1.0)
    want = fresh.finalize()
    reused, jreused = Aggregator(chunk_c=4, device="cpu"), JAggregator(chunk_c=4)
    for agg in (reused, jreused):
        agg.add(t_blobs[0], weight=1.0)
        agg.add(_client_blob(1, "fp16"), weight=1.0)
    mixed = reused.finalize(reset=True)
    jmixed = jax.block_until_ready(jreused.finalize())
    jreused.reset()
    _assert_equal_folds(mixed, jmixed)
    for agg in (reused, jreused):
        for b in t_blobs:
            agg.add(b, weight=1.0)
    got = reused.finalize()
    assert got["w"].numpy().tobytes() == want["w"].numpy().tobytes()
    _assert_equal_folds(got, jreused.finalize())


def test_mixed_codec_robust_rules_refuse():
    agg = Aggregator(chunk_c=4, device="cpu", rule="majority")
    agg.add(_client_blob(0, "ternary"), weight=1.0)
    with pytest.raises(ValueError, match="mixed wire kinds"):
        agg.add(_client_blob(0, "fp16"), weight=1.0)


def test_controller_spec_carries_the_run_settings():
    fed = FedConfig(fused_encode=False, controller=ControllerConfig(topk_fraction=0.2,
                                                                   residual_codec="bf16"))
    ctrl = make_controller(fed)
    spec = ctrl.spec_for("topk")
    assert spec == CodecSpec(kind="topk", residual="bf16", fttq=fed.fttq, topk_fraction=0.2,
                             fused_encode=False)
    assert ctrl.spec_for("topk") is spec and not spec.error_feedback
