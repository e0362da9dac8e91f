"""The batched serve loop, port vs reference: the LRU dequant cache's
accounting, the engine's artifact (wire bytes, packed and lazy byte counts
equal to the reference engine's), its logits (within 1e-5 of the one-shot
packed deploy and of the reference engine), its cache counters after the
same forwards, and ``run_closed_loop`` under a fixed service time, whose
``LoadReport`` equals the reference's in every field. The first eleven
cases are the reference's ``tests/test_serve_loop.py`` on the port."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve_loop as jsl
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.compression import DowncastTensor
from repro_torch.core.fttq import FTTQConfig
from repro_torch.launch import serve_loop as sl
from repro_torch.launch.serve import ternary_deploy
from repro_torch.models import transformer as tf

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reference():
    """The reference's demo model, and the port's copy of it."""
    jcfg, jparams = jsl.demo_model(d_model=32, n_layers=2)
    cfg = tf.ModelConfig(**dataclasses.asdict(jcfg))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def tiny():
    return sl.demo_model(d_model=32, n_layers=2, device="cpu")


@pytest.fixture(scope="module")
def engine(tiny):
    cfg, params = tiny
    return sl.ServeEngine(cfg, params, max_batch=4, device="cpu")


def _wire_leaf(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return x, DowncastTensor(data=x.to(torch.float16), orig_dtype="float32")


# --------------------------------------------------------------------------
# The reference's cases.
# --------------------------------------------------------------------------


def test_cache_hit_miss_eviction_accounting():
    _dense_a, wire_a = _wire_leaf((8, 8), 1)   # 256 B dense
    _dense_b, wire_b = _wire_leaf((8, 8), 2)
    cache = sl.LRUDequantCache(capacity_bytes=300)   # holds exactly one
    out = cache.get("a", wire_a)
    np.testing.assert_array_equal(out.numpy(), wire_a.restore().numpy())
    assert (cache.hits, cache.misses, cache.evictions) == (0, 1, 0)
    cache.get("a", wire_a)
    assert cache.hits == 1
    cache.get("b", wire_b)                        # evicts a
    assert cache.evictions == 1 and cache.live_bytes <= 300
    cache.get("a", wire_a)                        # miss again: was evicted
    assert cache.misses == 3
    stats = cache.stats()
    assert stats["entries"] == 1 and 0 < stats["hit_rate"] < 1


def test_cache_capacity_zero_never_retains():
    _dense, wire = _wire_leaf((4, 4))
    cache = sl.LRUDequantCache(0)
    for _ in range(3):
        cache.get("k", wire)
    assert cache.hits == 0 and cache.misses == 3
    assert cache.live_bytes == 0 and cache.evictions == 3


def test_cache_oversized_leaf_still_served():
    _dense, wire = _wire_leaf((32, 32))           # 4 KiB dense
    cache = sl.LRUDequantCache(16)
    out = cache.get("big", wire)
    np.testing.assert_array_equal(out.numpy(), wire.restore().numpy())
    assert cache.live_bytes <= 16 and cache.evictions == 1


def test_cache_rejects_negative_capacity():
    with pytest.raises(ValueError, match="capacity_bytes"):
        sl.LRUDequantCache(-1)


def test_engine_logits_match_one_shot_deploy(tiny, engine):
    """The lazy-leaf engine serves the same function as
    ``ternary_deploy(packed=True, residual="fp16")``: same artifact, same
    kernels."""
    cfg, params = tiny
    served, wire_bytes, _, _ = ternary_deploy(params, FTTQConfig(), packed=True,
                                              residual="fp16", device="cpu")
    assert engine.wire_bytes == wire_bytes
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 6)))
    le = engine.forward(toks)
    lr, _, _ = tf.forward(cfg, served, toks)
    np.testing.assert_allclose(le.numpy(), lr.numpy(), rtol=1e-5, atol=1e-5)


def test_engine_packed_weights_stay_2bit(engine):
    assert 0 < engine.packed_weight_bytes < engine.lazy_wire_bytes_dense
    toks = torch.zeros((1, 4), dtype=torch.int64)
    engine.forward(toks)
    engine.forward(toks)            # the second forward hits the warm cache
    assert engine.stats()["cache"]["hits"] > 0


def test_engine_rejects_oversized_batch(engine, tiny):
    cfg, params = tiny
    with pytest.raises(ValueError, match="max_batch"):
        engine.forward(torch.zeros((engine.max_batch + 1, 4), dtype=torch.int64))
    with pytest.raises(ValueError, match="max_batch"):
        sl.ServeEngine(cfg, params, max_batch=0, device="cpu")


def test_engine_tight_cache_still_correct(tiny):
    """A cache too small for one leaf decodes every forward: slower, never
    wrong, never over budget."""
    cfg, params = tiny
    tight = sl.ServeEngine(cfg, params, max_batch=2, cache_capacity_bytes=64, device="cpu")
    roomy = sl.ServeEngine(cfg, params, max_batch=2, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 5)))
    np.testing.assert_allclose(tight.forward(toks).numpy(), roomy.forward(toks).numpy(),
                               rtol=1e-6, atol=1e-6)
    assert tight.cache.live_bytes <= 64
    assert tight.cache.evictions > 0


def test_closed_loop_report_sanity(engine):
    rep = sl.run_closed_loop(engine, n_requests=6, offered_qps=500.0, prompt_len=4, seed=1)
    assert rep.n_requests == 6
    assert rep.p99_ms >= rep.p50_ms > 0
    assert rep.mean_ms > 0 and rep.wall_s > 0
    assert 1.0 <= rep.mean_batch <= engine.max_batch
    assert rep.achieved_qps > 0
    row = rep.row()
    assert row["offered_qps"] == 500.0 and "cache" in row


def test_closed_loop_batches_under_pressure(tiny):
    cfg, params = tiny
    eng = sl.ServeEngine(cfg, params, max_batch=4, device="cpu")
    rep = sl.run_closed_loop(eng, n_requests=8, offered_qps=10_000.0, prompt_len=4, seed=2)
    assert rep.mean_batch > 1.5


def test_closed_loop_validates_args(engine):
    with pytest.raises(ValueError):
        sl.run_closed_loop(engine, n_requests=0, offered_qps=1.0)
    with pytest.raises(ValueError):
        sl.run_closed_loop(engine, n_requests=1, offered_qps=0.0)


# --------------------------------------------------------------------------
# Against the reference engine.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("capacity", [1 << 24, 64])
def test_engine_matches_reference_engine(reference, capacity):
    jcfg, jparams, cfg, params = reference
    jeng = jsl.ServeEngine(jcfg, jparams, max_batch=4, cache_capacity_bytes=capacity)
    eng = sl.ServeEngine(cfg, params, max_batch=4, cache_capacity_bytes=capacity,
                         device="cpu")
    for key in ("wire_bytes", "packed_weight_bytes", "lazy_wire_bytes_dense", "max_batch"):
        assert eng.stats()[key] == jeng.stats()[key], key
    assert eng._lazy_keys == jeng._lazy_keys
    assert "['embed']['table']" in eng._lazy_keys
    rng = np.random.default_rng(7)
    for b in (1, 4, 2):
        toks = rng.integers(0, cfg.vocab_size, (b, 5)).astype(np.int32)
        got = eng.forward(torch.from_numpy(toks))
        want = jeng.forward(jnp.asarray(toks))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert eng.stats() == jeng.stats()


def test_closed_loop_report_equals_reference_under_a_fixed_service_time(reference,
                                                                         monkeypatch):
    """With the clock of both modules replaced by one that advances 7 ms a
    reading, both loops see the same service times, so the same arrivals
    (one rng, drawn in the reference's order) give the same report."""

    def fixed_clock():
        state = {"t": 0.0}

        def perf_counter():
            state["t"] += 0.007
            return state["t"]
        return types.SimpleNamespace(perf_counter=perf_counter)

    jcfg, jparams, cfg, params = reference
    for qps, cap in ((50.0, 1 << 24), (5_000.0, 64)):
        jeng = jsl.ServeEngine(jcfg, jparams, max_batch=4, cache_capacity_bytes=cap)
        eng = sl.ServeEngine(cfg, params, max_batch=4, cache_capacity_bytes=cap,
                             device="cpu")
        monkeypatch.setattr(jsl, "time", fixed_clock())
        monkeypatch.setattr(sl, "time", fixed_clock())
        want = jsl.run_closed_loop(jeng, n_requests=8, offered_qps=qps, prompt_len=4, seed=3)
        got = sl.run_closed_loop(eng, n_requests=8, offered_qps=qps, prompt_len=4, seed=3)
        assert got.row() == want.row()
        assert got.wall_s == pytest.approx(0.007 * round(8 / got.mean_batch))


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "hubert-xlarge", "gemma3-4b"])
def test_engine_serves_the_packed_families(arch):
    cfg = get_reduced(arch)
    eng = sl.ServeEngine(cfg, tf.init_params(cfg, seed=0, device="cpu"), max_batch=2,
                         device="cpu")
    logits = eng.forward(torch.zeros((2, 4), dtype=torch.int64))
    assert tuple(logits.shape) == (2, 4, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-370m", "zamba2-1.2b"])
def test_engine_refuses_moe_and_ssm(arch):
    cfg = get_reduced(arch)
    with pytest.raises(ValueError, match="routes those weights elsewhere"):
        sl.ServeEngine(cfg, {}, device="cpu")


def test_cli_runs_on_the_cpu(capsys):
    assert sl.main(["--device", "cpu", "--requests", "5", "--qps", "100"]) == 0
    out = capsys.readouterr().out
    assert '"device": "cpu"' in out and '"n_requests": 5' in out


def test_keystr_matches_jax():
    path = (("d", "embed"), ("d", "table"))
    assert sl.keystr(path) == jax.tree_util.keystr(
        (jax.tree_util.DictKey("embed"), jax.tree_util.DictKey("table")))
    assert sl.keystr((("d", "blocks"), ("i", 3))) == jax.tree_util.keystr(
        (jax.tree_util.DictKey("blocks"), jax.tree_util.SequenceKey(3)))
