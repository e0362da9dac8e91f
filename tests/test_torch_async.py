"""Port vs reference: the buffered-asynchronous T-FedAvg / FedAvg server
end to end on the paper's MLP (the task of ``test_torch_fed.py``), from the
same initial weights, data and seed; and the event queue against
``heapq``.

What the channel, the event queue and the rng decide is identical: bytes,
the time between mixes, staleness, drops, retransmissions, the
``buffer_k`` trajectory and the gate's counts. Training and the fold run in
another framework's float order, so the global model after every mix is
held to the reference's within ``PARAM_ATOL`` per element, with one code
flip in 10,000 elements allowed on quantized leaves, as for the sync round.
The sound port stays within 1.46e-6 of it in every case (the largest gap:
``cap_drop``'s last mix). Two faults planted in a copy of the port are
caught: the staleness exponent's sign flipped (``cap_downweight``: from
the third mix, the first whose buffer holds a stale arrival, 82.8% of
``fc0/w`` is outside ``PARAM_ATOL``, max gap 7.2e-5, 2.7e-3 over all
leaves) and η left out of the mix (``mixing``: 99.96% of ``fc0/w`` from
the first mix, max gap 3.7e-2)."""

import dataclasses
import heapq

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import ChannelConfig as JChannelConfig
from repro.data import partition_iid as jpartition_iid
from repro.data import synthetic_classification as jsynthetic
from repro.fed import AvailabilityConfig as JAvailabilityConfig
from repro.fed import FedConfig as JFedConfig
from repro.fed import run_federated as jrun_federated
from repro.fed.attackers import AttackConfig as JAttackConfig
from repro.fed.defense import DefenseConfig as JDefenseConfig
from repro.models.paper_models import init_mlp_mnist as jinit_mlp
from repro.models.paper_models import mlp_mnist as jmlp
from repro.optim import adam as jadam
from repro_torch.comm.channel import ChannelConfig
from repro_torch.convert import params_from_jax
from repro_torch.data.federated import partition_iid
from repro_torch.fed import EventHeap, async_server
from repro_torch.fed.attackers import AttackConfig
from repro_torch.fed.availability import AvailabilityConfig
from repro_torch.fed.defense import DefenseConfig
from repro_torch.fed.simulation import FedConfig, PhaseTimer, run_federated
from repro_torch.launch.federated import main as federated_main
from repro_torch.launch.federated import make_eval_fn
from repro_torch.models.paper_models import mlp_mnist
from repro_torch.optim import adam
from repro_torch.tree import flatten_with_path, path_str

torch.set_num_threads(1)

PARAM_ATOL = 2e-6                    # as tests/test_torch_fed.py; sound gap 1.46e-6
FLIPS_PER_ELEMENT = 1e-4
CHANNEL = {"mean_bandwidth_bytes_s": 1e6, "deadline_s": 0.09}
STALE = {"mean_bandwidth_bytes_s": 3e5, "bandwidth_sigma": 2.0, "compute_speed_sigma": 1.5}
MIXES = 4


@pytest.fixture(scope="module")
def mlp_setup():
    x, y, xt, yt = jsynthetic(jax.random.PRNGKey(0), 360, 10, 784, noise=3.0, n_test=200)
    return x, y, xt, yt, jinit_mlp(jax.random.PRNGKey(1))


def _jax_eval(xt, yt):
    xt_j, yt_j = jnp.asarray(xt), jnp.asarray(yt)

    def eval_fn(p):
        return float(jnp.mean(jnp.argmax(jmlp(p, xt_j), -1) == yt_j)), 0.0

    return eval_fn


def _recording(eval_fn, seen, to_numpy):
    """``eval_fn`` that first keeps the global model it scores, per mix."""

    def wrapped(params):
        seen.append({path_str(p): to_numpy(leaf) for p, leaf in flatten_with_path(params)})
        return eval_fn(params)

    return wrapped


def _configs(case: str) -> tuple[dict, dict]:
    """(reference kwargs, port kwargs) of one case, beyond the shared ones."""
    chan = dict(CHANNEL)
    both, ref, got = {}, {}, {}
    if case == "fedavg":
        both["algorithm"] = "fedavg"
    elif case in ("cap_drop", "cap_downweight"):
        chan.update(STALE)
        both.update(max_staleness=1, staleness_policy=case[4:])
    elif case.startswith("adaptive"):
        both.update(adaptive_buffer=True, buffer_k=1,
                    target_mix_latency_s=float(case.split("_")[1]))
    elif case == "nic_cap":
        chan["server_bandwidth_bytes_s"] = 2e4
    elif case == "mixing":
        chan.update(STALE)
        both["mixing_rate"] = 0.7
    elif case == "list_fold":
        chan.update(STALE)
        both["fused_aggregation"] = False
    elif case == "diurnal_loss":
        chan.update(loss_rate=0.05, chunk_bytes=1024)
        avail = dict(kind="diurnal", period_s=0.4, floor=0.2, n_cohorts=2)
        ref["availability"] = JAvailabilityConfig(**avail)
        got["availability"] = AvailabilityConfig(**avail)
    elif case == "trace_wait":
        # short sessions empty the fleet at times, so a refill waits for the
        # next change while the event clock prunes the capped NIC's window
        chan["server_bandwidth_bytes_s"] = 2e5
        avail = dict(kind="trace", mean_on_s=0.1, mean_off_s=0.5, horizon_s=50.0)
        ref["availability"] = JAvailabilityConfig(**avail)
        got["availability"] = AvailabilityConfig(**avail)
    elif case == "defended":
        attack = dict(kind="sign_flip", n_attackers=2, seed=1)
        ref.update(attack=JAttackConfig(**attack),
                   defense=JDefenseConfig(enabled=True, rule="majority"))
        got.update(attack=AttackConfig(**attack),
                   defense=DefenseConfig(enabled=True, rule="majority"))
    elif case != "tfedavg":
        raise ValueError(case)
    ref.update(both, channel=JChannelConfig(**chan))
    got.update(both, channel=ChannelConfig(**chan))
    return ref, got


def _run_both(setup, ref_kw: dict, got_kw: dict):
    """Both async runs, each with the global model after every mix."""
    x, y, xt, yt, jparams = setup
    common = dict(algorithm="tfedavg", mode="async", n_clients=6, participation=1.0,
                  local_epochs=1, batch_size=16, rounds=MIXES, buffer_k=2, seed=3)
    ref_params, got_params = [], []
    ref = jrun_federated(jmlp, jparams, jpartition_iid(x, y, 6),
                         JFedConfig(**{**common, **ref_kw}), jadam(1e-3),
                         _recording(_jax_eval(xt, yt), ref_params, np.asarray), eval_every=1)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    timer = PhaseTimer("cpu")
    got = run_federated(mlp_mnist, params, partition_iid(x, y, 6),
                        FedConfig(**{**common, **got_kw}), adam(1e-3),
                        _recording(make_eval_fn(mlp_mnist, xt, yt, torch.device("cpu")),
                                   got_params, lambda t: t.numpy().copy()),
                        eval_every=1, device="cpu", timer=timer)
    ref.params, got.params = ref_params, got_params
    return ref, got, timer


TELEMETRY_KEYS = ("staleness_hist", "dropped_updates", "dropped_update_bytes",
                  "buffer_k_per_agg", "retrans_bytes", "retries", "goodput_fraction",
                  "availability")


def assert_same_async_run(ref, got, quantized: bool = True) -> None:
    """Everything the channel, the events and the rng decide, exactly; the
    global model after every mix within ``PARAM_ATOL`` (and the flips
    allowance on quantized leaves). The gaps are printed first."""
    assert got.upload_bytes == ref.upload_bytes
    assert got.download_bytes == ref.download_bytes
    assert got.rounds_run == ref.rounds_run
    assert got.round_times == ref.round_times
    assert got.participants_per_round == ref.participants_per_round
    assert got.staleness_per_agg == ref.staleness_per_agg
    assert got.dropped_per_round == ref.dropped_per_round
    assert got.transfer_summary == ref.transfer_summary
    for key in TELEMETRY_KEYS:
        assert got.telemetry[key] == ref.telemetry[key], key
    assert ("defense" in got.telemetry) == ("defense" in ref.telemetry)
    if "defense" in ref.telemetry:
        assert got.telemetry["defense"] == ref.telemetry["defense"]
    assert len(got.params) == len(ref.params) == ref.rounds_run
    for r, (want, have) in enumerate(zip(ref.params, got.params)):
        assert sorted(have) == sorted(want)
        gaps = {path: np.abs(a - want[path]) for path, a in have.items()}
        print(f"mix {r}: max |global - reference| "
              f"{max(float(g.max()) for g in gaps.values()):.3e}")
        for path, gap in gaps.items():
            outside = int((gap > PARAM_ATOL).sum())
            allowed = int(FLIPS_PER_ELEMENT * gap.size) if quantized and gap.ndim >= 2 else 0
            assert outside <= allowed, (
                f"mix {r} {path}: {outside} elements off by more than {PARAM_ATOL} "
                f"(max {gap.max():.3e})")


CASES = ["tfedavg", "fedavg", "cap_drop", "cap_downweight", "adaptive_0", "adaptive_10",
         "nic_cap", "mixing", "list_fold", "diurnal_loss", "trace_wait", "defended"]


@pytest.mark.parametrize("case", CASES)
def test_async_run_matches_reference(mlp_setup, case, monkeypatch):
    waits = []
    plain_draw_one = async_server.draw_one

    def draw_one(avail, t, n, rng):
        k = plain_draw_one(avail, t, n, rng)
        waits.append(k < 0)
        return k

    monkeypatch.setattr(async_server, "draw_one", draw_one)
    ref_kw, got_kw = _configs(case)
    ref, got, timer = _run_both(mlp_setup, ref_kw, got_kw)
    assert_same_async_run(ref, got, quantized=case != "fedavg")
    tel = got.telemetry
    # each case reaches what it is there for
    if case == "cap_drop":
        assert tel["dropped_updates"] > 0 and tel["dropped_update_bytes"] > 0
    if case in ("cap_downweight", "mixing", "list_fold"):
        assert max(got.staleness_per_agg) > 1
    if case == "adaptive_10":
        assert max(tel["buffer_k_per_agg"]) > 1
    if case == "diurnal_loss":
        assert tel["retrans_bytes"] > 0 and tel["availability"] == "diurnal"
    if case == "trace_wait":
        assert any(waits)
    if case == "defended":
        assert tel["defense"]["ledger_balanced"]
        assert tel["defense"]["passed_updates"] == len(got.staleness_per_agg)
    assert len(timer.rounds) == MIXES
    assert {"train", "encode", "wire", "aggregate"} <= set(timer.rounds[0])
    if case != "fedavg":
        assert "requantize" in timer.rounds[0]


def test_nic_cap_stretches_time_not_bytes(mlp_setup):
    """A capped NIC makes async uploads contend: bytes stay, simulated
    transfer seconds grow (the port's runs; parity is the case above)."""
    _, got_wide = _configs("tfedavg")
    _, got_narrow = _configs("nic_cap")
    x, y, xt, yt, jparams = mlp_setup
    runs = []
    for kw in (got_wide, got_narrow):
        params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
        cfg = FedConfig(algorithm="tfedavg", mode="async", participation=1.0, local_epochs=1,
                        batch_size=16, rounds=2, buffer_k=2, seed=3, **kw)
        runs.append(run_federated(mlp_mnist, params, partition_iid(x, y, 6), cfg, adam(1e-3),
                                  lambda p: (0.0, 0.0), eval_every=2, device="cpu"))
    wide, narrow = runs
    assert narrow.upload_bytes == wide.upload_bytes
    assert narrow.download_bytes == wide.download_bytes
    assert narrow.transfer_summary["total_seconds"] > wide.transfer_summary["total_seconds"]


def test_async_config_errors(mlp_setup):
    x, y, xt, yt, jparams = mlp_setup
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    clients = partition_iid(x, y, 6)
    for kw, err in (({"mode": "async", "staleness_policy": "bogus"}, "staleness_policy"),
                    ({"mode": "bogus"}, "unknown federated mode")):
        with pytest.raises(ValueError, match=err):
            run_federated(mlp_mnist, params, clients, FedConfig(**kw), adam(1e-3),
                          lambda p: (0.0, 0.0), device="cpu")


def test_fedconfig_async_fields_match_reference():
    """The async and tier fields, with the reference's names and defaults."""
    names = ("buffer_k", "max_concurrency", "staleness_exponent", "mixing_rate",
             "max_staleness", "staleness_policy", "adaptive_buffer", "target_mix_latency_s")
    ref, got = JFedConfig(), FedConfig()
    for name in names:
        assert getattr(got, name) == getattr(ref, name), name
    assert dataclasses.asdict(got.hierarchy) == dataclasses.asdict(ref.hierarchy)
    assert not got.hierarchy.enabled


def test_async_cli_runs_and_rejects_a_deadline(capsys):
    res = federated_main(["--device", "cpu", "--mode", "async", "--buffer-k", "3",
                          "--rounds", "2", "--clients", "4", "--max-staleness", "2",
                          "--adaptive-buffer"])
    for algo in ("fedavg", "tfedavg"):
        assert res[algo].rounds_run == 2
        assert len(res[algo].telemetry["buffer_k_per_agg"]) == 2
    assert res["fedavg"].upload_bytes > 10 * res["tfedavg"].upload_bytes
    assert "buffer_k trajectory" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        federated_main(["--device", "cpu", "--mode", "async", "--deadline", "0.3"])


# --------------------------------------------------------------------------
# The event queue.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_event_heap_pops_in_heapq_order(seed):
    """Seeded times on a coarse grid (many ties), pushed one at a time and
    in bulk between pops: every pop equals heapq's on (time, seq)."""
    rng = np.random.default_rng(seed)
    heap, ref = EventHeap(capacity=2), []
    seq = 0
    popped = 0
    for step in range(300):
        op = rng.integers(4)
        if op == 0 and len(heap):
            t, s, payload = heap.pop()
            assert (t, s, payload) == heapq.heappop(ref)
            popped += 1
        elif op == 1:
            k = int(rng.integers(0, 6))
            times = np.round(rng.uniform(0, 10, size=k))
            heap.push_many(times, [f"b{step}.{i}" for i in range(k)])
            for i, t in enumerate(times):
                heapq.heappush(ref, (float(t), seq, f"b{step}.{i}"))
                seq += 1
        else:
            t = float(np.round(rng.uniform(0, 10)))
            assert heap.push(t, f"p{step}") == seq
            heapq.heappush(ref, (t, seq, f"p{step}"))
            seq += 1
        assert len(heap) == len(ref)
        if ref:
            assert heap.peek_time() == ref[0][0]
    while ref:
        assert heap.pop() == heapq.heappop(ref)
        popped += 1
    assert popped > 100
    with pytest.raises(IndexError):
        heap.pop()
    with pytest.raises(IndexError):
        heap.peek_time()
    with pytest.raises(ValueError):
        heap.push_many(np.zeros(2), ["one"])
