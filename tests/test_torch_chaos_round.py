"""Port vs reference: chaos rounds over real sockets (``fed.mp_server``
with ``comm.faults.ChaosProxy``), the port's clients as spawn processes on
the CPU, at the reference's client counts and seeds.

With fault seed 19 (refused connects, delays, mid-frame kills forcing
reconnect and resume, and one client crash) the quorum round survives with
the reference's set, clients [0, 1, 2, 3, 4], client 5 ``crashed``; its
root aggregate equals the port's in-process reference over the survivors
and the reference's mix of the blobs the server received (sync and
buffered), and the update-byte ledger balances. Then version negotiation
(a v1 client lands, a bad-proto client is rejected), a missed quorum, and
the child-reaping escalation."""

import multiprocessing as mp
import signal
import time

import jax
import pytest
import torch

from repro.comm import faults as jf
from repro.comm.wire import decode_update as jdecode_update
from repro.fed import Aggregator as JAggregator
from repro.fed import mp_server as R
from repro_torch.comm.faults import FaultConfig, FaultSchedule
from repro_torch.comm.wire import encode_update
from repro_torch.fed.mp_server import (
    QuorumNotMetError, default_chaos, demo_params, params_hash, reap_processes,
    run_inprocess_reference, run_socket_round,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    "spawn" not in mp.get_all_start_methods(),
    reason="platform lacks multiprocessing spawn start method",
)

TIMEOUT_S = 300.0
N_CLIENTS = 6
SEED = 7
CHAOS_SEED = 19   # reachable mid-frame kills + a refused connect


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


def _reference_mix(tparams, received, mode, **kw) -> str:
    jparams = jdecode_update(encode_update(tparams))
    return R.params_hash(R._mix_arrivals(jparams, received, mode, chunk_c=16, eta=0.5, **kw))


@pytest.fixture(scope="module")
def chaos_sync_round():
    params = demo_params(seed=SEED)
    cfg = default_chaos(seed=CHAOS_SEED, n_clients=N_CLIENTS)
    res = run_socket_round(params, N_CLIENTS, seed=SEED, mode="sync", quorum_frac=0.5,
                           timeout_s=TIMEOUT_S, fault_cfg=cfg, device="cpu")
    return params, res


def test_chaos_sync_byte_identical_to_surviving_reference(chaos_sync_round):
    params, res = chaos_sync_round
    assert res.n_survivors >= res.quorum_n
    ref = run_inprocess_reference(params, N_CLIENTS, seed=SEED, mode="sync",
                                  order=sorted(res.arrivals), device="cpu")
    assert params_hash(res.params) == params_hash(ref)
    assert params_hash(res.params) == _reference_mix(params, sorted(res.received), "sync",
                                                     buffer_k=4)


def test_chaos_survivor_set_is_the_reference_set(chaos_sync_round):
    """Seed 19's only casualty is the injected crash client, as in the
    reference's round; the first attempt of every client meets the
    reference's weather (the schedules are the reference's)."""
    _params, res = chaos_sync_round
    assert sorted(res.arrivals) == [0, 1, 2, 3, 4]
    assert res.outcomes[N_CLIENTS - 1] == "crashed"
    assert all(res.outcomes[cid] == "ok" for cid in range(N_CLIENTS - 1))
    cfg = default_chaos(seed=CHAOS_SEED, n_clients=N_CLIENTS)
    jcfg = R.default_chaos(seed=CHAOS_SEED, n_clients=N_CLIENTS)
    for cid in range(N_CLIENTS):
        p, j = FaultSchedule(cfg, cid, 0), jf.FaultSchedule(jcfg, cid, 0)
        assert p.connect_action() == j.connect_action()
        assert p.first_kill_offset(2048) == j.first_kill_offset(2048)


def test_chaos_exercised_retry_and_resume(chaos_sync_round):
    _params, res = chaos_sync_round
    assert res.retries >= 1 and res.resumed_bytes > 0
    assert res.chaos is not None
    assert res.chaos["killed"] >= 1 and res.chaos["refused"] >= 1


def test_chaos_ledger_balances_and_books_the_crash(chaos_sync_round):
    _params, res = chaos_sync_round
    led = res.ledger()
    assert led["balance_ok"] and led["committed"] == "quorum"
    assert res.dropped_update_bytes > 0
    assert res.shipped_update_bytes == res.ingested_update_bytes + res.dropped_update_bytes
    assert sorted(led["outcomes"]) == [str(c) for c in range(N_CLIENTS)]


def test_chaos_buffered_byte_identical_in_arrival_order(settled_reference):
    params = demo_params(seed=SEED + 2)
    cfg = default_chaos(seed=CHAOS_SEED, n_clients=N_CLIENTS)
    res = run_socket_round(params, N_CLIENTS, seed=SEED + 2, mode="buffered", buffer_k=3,
                           eta=0.5, quorum_frac=0.5, timeout_s=TIMEOUT_S, fault_cfg=cfg,
                           device="cpu")
    assert res.n_survivors >= res.quorum_n
    ref = run_inprocess_reference(params, N_CLIENTS, seed=SEED + 2, mode="buffered",
                                  buffer_k=3, eta=0.5, order=res.arrivals, device="cpu")
    assert params_hash(res.params) == params_hash(ref)
    assert params_hash(res.params) == _reference_mix(params, res.received, "buffered",
                                                     buffer_k=3)
    assert res.ledger()["balance_ok"]


def test_mixed_legacy_and_rejected_clients():
    params = demo_params(seed=SEED + 3)
    cfg = FaultConfig(fault_good=0.0, fault_bad=0.0, bad_proto_clients=(2,))
    res = run_socket_round(params, 4, seed=SEED + 3, mode="sync", quorum_frac=0.5,
                           timeout_s=TIMEOUT_S, fault_cfg=cfg, legacy_clients=(1,),
                           device="cpu")
    assert sorted(res.arrivals) == [0, 1, 3]
    assert res.outcomes == {0: "ok", 1: "ok", 2: "rejected", 3: "ok"}
    ref = run_inprocess_reference(params, 4, seed=SEED + 3, mode="sync",
                                  order=sorted(res.arrivals), device="cpu")
    assert params_hash(res.params) == params_hash(ref)
    assert params_hash(res.params) == _reference_mix(params, sorted(res.received), "sync",
                                                     buffer_k=4)
    assert res.ledger()["balance_ok"]


def test_quorum_not_met_raises():
    params = demo_params(seed=SEED)
    cfg = FaultConfig(fault_good=0.0, fault_bad=0.0, crash_clients=(0, 1),
                      crash_after_frac=0.1)
    with pytest.raises(QuorumNotMetError, match="crashed"):
        run_socket_round(params, 2, seed=SEED, quorum_frac=1.0, timeout_s=TIMEOUT_S,
                         fault_cfg=cfg, device="cpu")


# --------------------------------------------------------------------------
# Process reaping.
# --------------------------------------------------------------------------


def _sleepy():
    time.sleep(120)


def _stubborn():
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    while True:
        time.sleep(1)


@pytest.mark.skipif("fork" not in mp.get_all_start_methods(),
                    reason="escalation test uses fork for plain targets")
def test_reap_escalates_terminate_then_kill():
    ctx = mp.get_context("fork")
    sleepy = ctx.Process(target=_sleepy, daemon=True)
    stubborn = ctx.Process(target=_stubborn, daemon=True)
    sleepy.start()
    stubborn.start()
    esc = reap_processes([sleepy, stubborn], grace_s=0.5)
    assert not sleepy.is_alive() and not stubborn.is_alive()
    assert esc == {"terminated": 2, "killed": 1}


@pytest.mark.skipif("fork" not in mp.get_all_start_methods(),
                    reason="reaping test uses fork for plain targets")
def test_reap_no_escalation_for_clean_children():
    ctx = mp.get_context("fork")
    procs = [ctx.Process(target=time.sleep, args=(0.01,)) for _ in range(3)]
    for p in procs:
        p.start()
    assert reap_processes(procs, grace_s=10.0) == {"terminated": 0, "killed": 0}
    assert all(p.exitcode == 0 for p in procs)
