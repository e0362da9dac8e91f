"""Port vs reference: the vectorized fleet simulator (``fed.fleet.run_fleet``)
and the batched channel draws it runs on (``Channel.transfer_batch``,
``compute_time_batch``, ``_loss_penalty_batch``).

The batch channel: every case of ``tests/test_fleet.py`` and
``tests/test_channel.py`` that draws a batch gives the reference's seconds,
log, summary and rng state after the calls, exactly; where the batch is
stream-compatible with the scalar calls (lossless, ``compat``, one lossy
transfer, Gilbert–Elliott penalties) the port's batch also equals its own
scalar calls.

``run_fleet``: each case runs the reference and the port on the same numpy
params (``convert.params_from_jax``). A pool slot's scale comes from
``init_wq``'s sums, which XLA and PyTorch add in different orders (ROADMAP
Queue 3), so the port's pool holds the reference's codes and framing byte
for byte and its scales within ``SCALE_RTOL``. The port therefore runs
twice: on its own pool, where the rounds, participants, drops, round
times, bytes and telemetry (transfer summary, tier ledger, defense counts,
controller rungs, staleness histogram) equal the reference's exactly and
the final update is within ``PARAM_ATOL`` per element (with the flips
allowance below); and on the
reference's pool bytes, where the final update is bit for bit the
reference's on the mean, majority and lossless paths. A requantizing edge
takes its scale from tile sums in another order than XLA's, so under such
a tier the final update is held within ``PARAM_ATOL`` with the flips
allowance of ``tests/test_torch_fed.py`` (a code may flip where a value
sits within an ulp of Δ).

The reference's long-lived ``Aggregator`` races its own ``reset()``
(ROADMAP Queue 3): its folds here wait for their result first
(``settled_reference``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.fed.fleet as jfleet
from repro.comm import channel as jchannel
from repro.comm.wire import decode_update_leaves as jdecode_update_leaves
from repro.core.compression import TopKTensor as JTopKTensor
from repro.core.ternary import TernaryTensor as JTernaryTensor
from repro.fed import Aggregator as JAggregator
from repro.fed import AttackConfig as JAttackConfig
from repro.fed import ControllerConfig as JControllerConfig
from repro.fed import DefenseConfig as JDefenseConfig
from repro.fed import FedConfig as JFedConfig
from repro.fed import FleetConfig as JFleetConfig
from repro.fed import HierarchyConfig as JHierarchyConfig
from repro.fed import run_fleet as jrun_fleet
from repro.fed.availability import AvailabilityConfig as JAvailabilityConfig
from repro.models.paper_models import init_mlp_mnist as jinit_mlp
from repro_torch.comm import channel
from repro_torch.comm.wire import decode_update_leaves
from repro_torch.convert import params_from_jax
from repro_torch.core import TopKTensor
from repro_torch.core.ternary import TernaryTensor
from repro_torch.fed import (
    AttackConfig, ControllerConfig, DefenseConfig, FedConfig, FleetConfig, HierarchyConfig,
    run_fleet,
)
from repro_torch.fed import fleet
from repro_torch.fed.availability import AvailabilityConfig
from repro_torch.tree import flatten_with_path, path_str

torch.set_num_threads(1)

PARAM_ATOL = 2e-6                    # as tests/test_torch_fed.py
FLIPS_PER_ELEMENT = 1e-4
SCALE_RTOL = 1e-6                    # init_wq's sums (tests/test_torch_fttq.py)


@pytest.fixture
def settled_reference(monkeypatch):
    """The reference Aggregator's ``finalize(reset=True)`` with its result
    computed before ``reset()`` zeroes the fallback accumulators."""
    plain = JAggregator.finalize

    def finalize(self, *, reset=False):
        out = jax.block_until_ready(plain(self, reset=False))
        if reset:
            self.reset()
        return out

    monkeypatch.setattr(JAggregator, "finalize", finalize)


# --------------------------------------------------------------------------
# The batch channel.
# --------------------------------------------------------------------------

IDS = np.array([3, 0, 7, 7, 12])
NBYTES = np.array([1000, 50_000, 0, 777, 123_456])
GE = {"loss_model": "gilbert_elliott", "chunk_bytes": 2048, "ge_p_good_bad": 0.01,
      "ge_p_bad_good": 0.08, "ge_loss_good": 0.0, "ge_loss_bad": 0.5,
      "bandwidth_sigma": 0.0, "latency_jitter_s": 0.0}
GE_NBYTES = np.array([150_000, 0, 80_000, 300_000])


def _scalar_up(ch, ids, nbytes):
    return np.array([ch.transfer(int(k), int(n), "up") for k, n in zip(ids, nbytes)])


def _ge_scalar_penalties(ch, nbytes):
    pens = [ch._ge_loss_penalty(int(n)) for n in nbytes]
    return [np.array([p[i] for p in pens]) for i in range(3)]


def _ledger(ch):
    ch.transfer(0, 4096, "up")
    return [ch.transfer_batch([1, 2, 3], [4096] * 3, "up")]


def _share_nic(ch):
    return [ch.transfer_batch([0], [1_000_000], "down", share_nic=True),
            ch.transfer_batch(np.arange(10), [1_000_000] * 10, "down", share_nic=True)]


def _ge_untouched(ch):
    ch.transfer(0, 100_000, "down")
    ch.transfer_timed(1, 50_000, 3.0, "up")
    ch.transfer_concurrent([2, 3], [10_000, 20_000], "down")
    return [ch.transfer_batch(np.arange(4), np.full(4, 30_000), "up")]


# case → (ChannelConfig kwargs, seed, batched calls, the same through scalar
# calls where the batch is stream-compatible with them, else None)
BATCH_CASES = {
    "lossless_stream": (
        {}, 5,
        lambda ch: [ch.transfer_batch(IDS, NBYTES, "up"), ch.transfer_batch([1], [10], "down")],
        lambda ch: [_scalar_up(ch, IDS, NBYTES), np.array([ch.transfer(1, 10, "down")])]),
    "compat_iid": (
        {"loss_rate": 0.3, "chunk_bytes": 1024}, 9,
        lambda ch: [ch.transfer_batch([0, 2, 5], [10_000, 3_000, 100_000], "up", compat=True)],
        lambda ch: [_scalar_up(ch, [0, 2, 5], [10_000, 3_000, 100_000])]),
    "compat_gilbert_elliott": (
        GE, 3,
        lambda ch: [ch.transfer_batch(np.arange(4), GE_NBYTES, "up", compat=True)],
        lambda ch: [_scalar_up(ch, np.arange(4), GE_NBYTES)]),
    "single_lossy": (
        {"loss_rate": 0.4, "chunk_bytes": 512}, 3,
        lambda ch: [ch.transfer_batch([4], [nb], "up") for nb in (100, 512, 5000, 0)],
        lambda ch: [_scalar_up(ch, [4], [nb]) for nb in (100, 512, 5000, 0)]),
    "iid_batch": (
        {"loss_rate": 0.3, "chunk_bytes": 700, "retransmit_backoff": 1.7}, 11,
        lambda ch: [ch.transfer_batch(IDS, NBYTES, "up"),
                    ch.transfer_batch(np.arange(16), np.arange(16) * 977, "down", share_nic=True)],
        None),
    "iid_no_backoff": (
        {"loss_rate": 0.25, "chunk_bytes": 1000, "retransmit_backoff": 1.0}, 2,
        lambda ch: [ch.transfer_batch(IDS, NBYTES, "up")], None),
    "gilbert_elliott_penalties": (
        GE, 3, lambda ch: list(ch._loss_penalty_batch(GE_NBYTES)),
        lambda ch: _ge_scalar_penalties(ch, GE_NBYTES)),
    "gilbert_elliott_lossless": (
        {**GE, "ge_loss_bad": 0.0, "retransmit_timeout_s": 9.9, "latency_jitter_s": 0.01}, 5,
        _ge_untouched, None),
    "ledger_merged": ({"loss_rate": 0.2, "chunk_bytes": 256}, 1, _ledger, None),
    "share_nic": (
        {"server_bandwidth_bytes_s": 1e6, "bandwidth_sigma": 0.0, "latency_jitter_s": 0.0}, 2,
        _share_nic, None),
    "compute_time_batch": (
        {}, 7, lambda ch: [ch.compute_time_batch(np.array([0, 3, 9]), np.array([100, 250, 400]))],
        lambda ch: [np.array([ch.compute_time(k, n) for k, n in ((0, 100), (3, 250), (9, 400))])]),
}


def _chan(mod, kw: dict, seed: int):
    return mod.Channel(mod.ChannelConfig(**kw), 16, seed=seed)


def _assert_same_channel(got, ref) -> None:
    assert got.summary() == ref.summary()
    assert [dataclasses.astuple(e) for e in got.log] == [
        dataclasses.astuple(e) for e in ref.log]
    assert got._rng.bit_generator.state == ref._rng.bit_generator.state


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_batch_channel_matches_reference(case):
    kw, seed, batched, scalar = BATCH_CASES[case]
    ref, got = _chan(jchannel, kw, seed), _chan(channel, kw, seed)
    want, out = batched(ref), batched(got)
    assert len(out) == len(want)
    for a, b in zip(out, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    _assert_same_channel(got, ref)
    if scalar is not None:
        twin = _chan(channel, kw, seed)
        for a, b in zip(out, scalar(twin)):
            np.testing.assert_array_equal(a, b)
        # the twin logs per event where the batch meters its ledger
        assert got.summary() == twin.summary()
        assert got._rng.bit_generator.state == twin._rng.bit_generator.state


def test_batch_channel_ledger_and_loss_are_real():
    """What the parity cases rest on: a lossy batch retransmits, the merged
    summary counts both ledgers, and a shared NIC slows every flow."""
    ch = _chan(channel, BATCH_CASES["ledger_merged"][0], 1)
    _ledger(ch)
    s = ch.summary()
    assert s["n_transfers"] == 4 and s["total_bytes"] == 4 * 4096
    assert s["retrans_bytes"] > 0 and 0 < s["goodput_fraction"] < 1.0
    lone, shared = _share_nic(_chan(channel, BATCH_CASES["share_nic"][0], 2))
    assert shared.min() > 5 * lone[0]


@pytest.mark.parametrize("kw,match", [
    ({"loss_model": "bursty?"}, "loss_model"),
    ({"loss_rate": 1.0}, "loss_rate"),
    ({**GE, "ge_loss_bad": 1.0}, "ge_loss_bad"),
    ({**GE, "ge_p_bad_good": 1.5}, "ge_p_bad_good"),
])
def test_batch_channel_validation_matches_reference(kw, match):
    for mod in (jchannel, channel):
        with pytest.raises(ValueError, match=match):
            _chan(mod, kw, 0).transfer_batch(np.array([0]), np.array([1000]), "up")


# --------------------------------------------------------------------------
# run_fleet against the reference.
# --------------------------------------------------------------------------


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"dense": {"w": rng.standard_normal((64, 32)).astype(np.float32),
                      "b": np.zeros(32, np.float32)},
            "head": {"w": rng.standard_normal((32, 10)).astype(np.float32)}}


def _defense_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"dense": {"w": rng.standard_normal((48, 16)).astype(np.float32),
                      "b": np.zeros(16, np.float32)}}


def _mlp_params():
    return jax.tree_util.tree_map(np.asarray, jinit_mlp(jax.random.PRNGKey(1)))


NESTED = {
    "availability": (JAvailabilityConfig, AvailabilityConfig),
    "hierarchy": (JHierarchyConfig, HierarchyConfig),
    "channel": (jchannel.ChannelConfig, channel.ChannelConfig),
    "attack": (JAttackConfig, AttackConfig),
    "defense": (JDefenseConfig, DefenseConfig),
    "controller": (JControllerConfig, ControllerConfig),
}
DIURNAL = {"availability": {"kind": "diurnal"}}
FLEET = dict(n_clients=2000, rounds=2, participation=0.05, **DIURNAL)
DEFENDED = dict(n_clients=400, rounds=2, participation=0.2,
                attack={"kind": "nan_poison", "n_attackers": 120, "seed": 5},
                defense={"enabled": True})
CONTROLLED = dict(algorithm="tfedavg", n_clients=64, participation=0.25, rounds=4, seed=0)

# case → (params, FedConfig kwargs, FleetConfig kwargs, final-update standard
# on the reference's pool: "exact", or "flips" under a requantizing tier)
RUNS = {
    "sync_flat": (_params, FLEET, {}, "exact"),
    "sync_tier": (_params, {**FLEET, "seed": 1, "hierarchy": {"n_edges": 8}}, {}, "flips"),
    "sync_tier_lossless": (
        _params, {**FLEET, "seed": 1,
                  "hierarchy": {"n_edges": 8, "requantize_at_edge": False}}, {}, "exact"),
    "sync_compat": (
        _params, {**FLEET, "n_clients": 200, "participation": 0.1},
        {"compat": True, "share_nic": False}, "exact"),
    "sync_compat_lossy": (
        _params, {**FLEET, "n_clients": 200, "participation": 0.1,
                  "channel": {"loss_rate": 0.2, "chunk_bytes": 1024}}, {"compat": True}, "exact"),
    "sync_deadline": (
        _params, {**FLEET, "channel": {"deadline_s": 0.3, "bandwidth_sigma": 2.0,
                                       "compute_speed_sigma": 1.0}}, {}, "exact"),
    "sync_trace": (
        _params, {**FLEET, "n_clients": 300,
                  "availability": {"kind": "trace", "mean_on_s": 60.0, "mean_off_s": 30.0,
                                   "horizon_s": 600.0}}, {}, "exact"),
    "async_tier": (
        _params, {**FLEET, "mode": "async", "rounds": 3, "buffer_k": 16, "max_concurrency": 64,
                  "hierarchy": {"n_edges": 4}}, {}, "flips"),
    "async_drop": (
        _params, {**FLEET, "mode": "async", "rounds": 4, "buffer_k": 8, "max_concurrency": 128,
                  "max_staleness": 1, "staleness_policy": "drop"}, {}, "exact"),
    "async_downweight": (
        _params, {**FLEET, "mode": "async", "rounds": 4, "buffer_k": 8, "max_concurrency": 128,
                  "max_staleness": 1, "staleness_policy": "downweight"}, {}, "exact"),
    "defense_flat": (_defense_params, DEFENDED, {}, "exact"),
    "defense_tier": (_defense_params, {**DEFENDED, "hierarchy": {"n_edges": 4}}, {}, "flips"),
    "defense_async": (_defense_params, {**DEFENDED, "mode": "async", "rounds": 3,
                                        "buffer_k": 8}, {}, "exact"),
    "defense_off": (_defense_params, {**DEFENDED, "attack": None,
                                      "defense": {"enabled": False}}, {}, "exact"),
    "majority_collude": (
        _defense_params, {**DEFENDED, "attack": {"kind": "collude", "n_attackers": 100, "seed": 5},
                          "defense": {"enabled": True, "rule": "majority"}}, {}, "exact"),
    "controller_sync": (
        _mlp_params, {**CONTROLLED, "controller": {"warmup_encodes": 1, "slow_factor": 10.0}},
        {"update_pool": 2}, "exact"),
    "controller_async": (
        _mlp_params, {**CONTROLLED, "mode": "async", "buffer_k": 4,
                      "controller": {"warmup_encodes": 1, "slow_factor": 10.0}},
        {"update_pool": 2}, "exact"),
    "controller_off": (
        _mlp_params, {**CONTROLLED, "controller": {"enabled": False}}, {"update_pool": 2},
        "exact"),
}


def _configs(fed_kw: dict, fleet_kw: dict):
    jkw, kw = {}, {}
    for key, value in fed_kw.items():
        if key in NESTED and isinstance(value, dict):
            jkw[key], kw[key] = (cls(**value) for cls in NESTED[key])
        else:
            jkw[key] = kw[key] = value
    return (JFedConfig(**jkw), JFleetConfig(**fleet_kw)), (FedConfig(**kw), FleetConfig(**fleet_kw))


def _recording(monkeypatch, module, pools: list):
    plain = module._payload_pool

    def recording(*a, **kw):
        pools.append(plain(*a, **kw))
        return pools[-1]

    monkeypatch.setattr(module, "_payload_pool", recording)


def _runs(monkeypatch, case: str):
    """The reference run, the port on its own pool, and the port on the
    reference's pool bytes; with the pools each encoded."""
    make, fed_kw, fleet_kw, _ = RUNS[case]
    params = make()
    (jcfg, jfl), (cfg, fl) = _configs(fed_kw, fleet_kw)
    ref_pools, pools = [], []
    _recording(monkeypatch, jfleet, ref_pools)
    ref = jrun_fleet(params, jcfg, jfl)
    _recording(monkeypatch, fleet, pools)
    own = run_fleet(params_from_jax(params, "cpu"), cfg, fl, device="cpu")
    given = iter(ref_pools)
    monkeypatch.setattr(fleet, "_payload_pool", lambda *a, **kw: next(given))
    same = run_fleet(params_from_jax(params, "cpu"), cfg, fl, device="cpu")
    return ref, own, same, ref_pools, pools


def _assert_same_numbers(got, ref) -> None:
    for field in ("rounds_run", "participants_per_round", "dropped_per_round", "round_times",
                  "upload_bytes", "download_bytes"):
        assert getattr(got, field) == getattr(ref, field), field
    assert got.total_time_s == ref.total_time_s
    assert got.telemetry == ref.telemetry


def _assert_same_pool(got: list, want: list) -> None:
    """Framing, codes and every other record (raw leaves, a top-k rung's
    indices and values) byte for byte; ternary scales within
    ``SCALE_RTOL``."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        got_pairs, want_pairs = decode_update_leaves(g), jdecode_update_leaves(w)
        assert [p for p, _ in got_pairs] == [p for p, _ in want_pairs]
        for (path, a), (_, b) in zip(got_pairs, want_pairs):
            if isinstance(b, JTernaryTensor):
                assert isinstance(a, TernaryTensor), path
                assert np.array_equal(a.packed.numpy(), np.asarray(b.packed)), path
                np.testing.assert_allclose(a.w_q.numpy(), np.asarray(b.w_q), rtol=SCALE_RTOL,
                                           atol=0, err_msg=path)
            else:
                assert _record_bytes(a) == _record_bytes(b), path


def _record_bytes(leaf) -> bytes:
    if isinstance(leaf, (TopKTensor, JTopKTensor)):     # indices by value (int64 vs uint32)
        idx = leaf.indices.numpy() if isinstance(leaf, TopKTensor) else leaf.indices
        return np.asarray(idx, np.int64).tobytes() + _record_bytes(leaf.values)
    if isinstance(leaf, torch.Tensor):
        return leaf.numpy().tobytes()
    return np.asarray(leaf).tobytes()


def _assert_update(got, ref, standard: str) -> None:
    want = {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]}
    mine = {path_str(p): leaf.numpy() for p, leaf in flatten_with_path(got)}
    assert mine.keys() == want.keys()
    for path, a in mine.items():
        b = want[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if standard == "exact":
            assert a.tobytes() == b.tobytes(), path
        else:
            gap = np.abs(a.astype(np.float64) - b)
            allowed = int(FLIPS_PER_ELEMENT * a.size) if a.ndim >= 2 else 0
            assert int((gap > PARAM_ATOL).sum()) <= allowed, (path, float(gap.max()))


@pytest.mark.parametrize("case", list(RUNS))
def test_run_fleet_matches_reference(case, monkeypatch, settled_reference):
    ref, own, same, ref_pools, pools = _runs(monkeypatch, case)
    assert len(pools) == len(ref_pools) >= 1
    for (got, got_sizes), (want, want_sizes) in zip(pools, ref_pools):
        _assert_same_pool(got, want)
        assert got_sizes.tolist() == want_sizes.tolist()
    _assert_same_numbers(own, ref)
    _assert_same_numbers(same, ref)
    _assert_update(own.final_update, ref.final_update, "flips")
    _assert_update(same.final_update, ref.final_update, RUNS[case][3])


def test_run_fleet_paths_are_exercised(monkeypatch, settled_reference):
    """The cases above reach what they are named for: drops, staleness
    drops and discounts, quarantines, the vote, the controller's rungs, and
    compat equal to the vectorized fleet when lossless; a disabled defense
    and a disabled controller equal the fleet that never names them."""
    def port(case, **fleet_kw):
        _, fed_kw, base_kw, _ = RUNS[case]
        _, (cfg, fl) = _configs(fed_kw, {**base_kw, **fleet_kw})
        return run_fleet(params_from_jax(RUNS[case][0](), "cpu"), cfg, fl, device="cpu")

    assert sum(port("sync_deadline").dropped_per_round) > 0
    compat, vec = port("sync_compat"), port("sync_compat", compat=False)
    assert (compat.round_times, compat.upload_bytes) == (vec.round_times, vec.upload_bytes)
    assert port("sync_compat_lossy").telemetry["retrans_bytes"] > 0
    assert port("async_drop").telemetry["dropped_updates"] > 0
    down = port("async_downweight")
    assert down.telemetry["dropped_updates"] == 0 and len(down.telemetry["staleness_hist"]) > 2
    for case in ("defense_flat", "defense_tier", "defense_async"):
        d = port(case).telemetry["defense"]
        assert d["ledger_balanced"] and d["quarantined_updates"] > 0, case
    collude = port("majority_collude")
    assert collude.telemetry["defense"]["quarantined_updates"] == 0
    assert all(torch.isfinite(leaf).all() for _, leaf in flatten_with_path(collude.final_update))
    rungs = port("controller_sync").telemetry["controller"]["rung_per_round"]
    assert rungs[0] == "ternary" and "topk16" in rungs
    assert "topk16" in port("controller_async").telemetry["controller"]["rung_per_round"]

    for case, legacy_kw in (("defense_off", dict(n_clients=400, rounds=2, participation=0.2)),
                            ("controller_off", CONTROLLED)):
        off = port(case)
        _, (cfg, fl) = _configs(legacy_kw, RUNS[case][2])
        legacy = run_fleet(params_from_jax(RUNS[case][0](), "cpu"), cfg, fl, device="cpu")
        _assert_same_numbers(off, legacy)
        for (pa, a), (pb, b) in zip(flatten_with_path(off.final_update),
                                    flatten_with_path(legacy.final_update)):
            assert pa == pb and torch.equal(a, b)
        assert "defense" not in off.telemetry and "controller" not in off.telemetry


def test_run_fleet_guards(monkeypatch):
    params = params_from_jax(_params(), "cpu")
    with pytest.raises(ValueError, match="mode"):
        run_fleet(params, FedConfig(mode="semi-sync"), device="cpu")
    with pytest.raises(ValueError, match="rule 'mean'"):
        run_fleet(params, FedConfig(n_clients=50, rounds=1, controller=ControllerConfig(),
                                    defense=DefenseConfig(enabled=True, rule="majority")),
                  device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_fleet(params, FedConfig(n_clients=50, rounds=1))
