"""Port vs reference: cross-process federation over real TCP
(``fed.mp_server``), with the port's clients as real spawn processes that
import torch and the port only, on the CPU.

The client program: ``demo_params`` and the broadcast encode are the
reference's bytes, ``client_nonce`` and ``client_weight`` its values, and
``client_update_blob`` its codes, fp16 residuals and framing byte for byte.
Its ternary scales differ from the reference's in the last bits (the
codec-mode w_q sums run in another order than XLA's; ROADMAP Queue 3), so
the mix is held on the reference's blobs: the port's ``_mix_arrivals`` on
the reference's blobs, and the reference's ``_mix_arrivals`` on the blobs
the port's server received, must both be the reference's bit for bit.
Every socket round's ``params_hash`` equals the port's in-process
reference over the same survivors in the same order AND the reference's
mix of the received blobs; byte ledgers are the reference's framing
arithmetic exactly. Then the interop cases, in threads: the port's server
serves the reference's client and the reference's server serves the
port's, and each conversation books what a same-package one does.

The reference's long-lived ``Aggregator`` races its own ``reset()``
(ROADMAP Queue 3), so its buffered folds here wait for their result before
the reset (``settled_reference``)."""

import multiprocessing as mp
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.comm import transport as jt
from repro.comm.wire import decode_update as jdecode_update
from repro.comm.wire import decode_update_leaves as jdecode_leaves
from repro.comm.wire import encode_update as jencode_update
from repro.fed import Aggregator as JAggregator
from repro.fed import mp_server as R
from repro_torch.comm.transport import FT_BCAST, FT_DONE, FT_HELLO, FT_UPDATE, FrameError
from repro_torch.comm.wire import decode_update, decode_update_leaves, encode_update
from repro_torch.fed import mp_server as P
from repro_torch.fed.mp_server import (
    client_update_blob, client_weight, demo_params, params_hash, run_inprocess_reference,
    run_socket_round,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    "spawn" not in mp.get_all_start_methods(),
    reason="platform lacks multiprocessing spawn start method",
)

TIMEOUT_S = 300.0
N_CLIENTS = 8
SEED = 7
SCALE_RTOL = 1e-6      # codec-mode w_q: tile sums in another order (Queue 3)


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


def _jparams(tparams):
    """The reference's tree for a port tree (same numpy values)."""
    return jdecode_update(encode_update(tparams))


def _reference_mix(tparams, received, mode, **kw) -> str:
    """The reference's mix of (cid, weight, blob) arrivals, in that order."""
    return R.params_hash(R._mix_arrivals(_jparams(tparams), received, mode, chunk_c=16,
                                         buffer_k=kw.pop("buffer_k", 4),
                                         eta=kw.pop("eta", 0.5), **kw))


def _same_but_scales(port_blob: bytes, ref_blob: bytes) -> None:
    """Record for record: paths, codes and every raw byte identical, the
    ternary scales within SCALE_RTOL; the framing the same length."""
    assert len(port_blob) == len(ref_blob)
    pairs, jpairs = decode_update_leaves(port_blob), jdecode_leaves(ref_blob)
    assert [p for p, _ in pairs] == [p for p, _ in jpairs]
    for (_, a), (_, b) in zip(pairs, jpairs):
        if hasattr(b, "packed"):
            assert np.array_equal(a.packed.numpy(), np.asarray(b.packed))
            np.testing.assert_allclose(a.w_q.numpy(), np.asarray(b.w_q), rtol=SCALE_RTOL)
        else:
            x, y = np.asarray(getattr(b, "data", b)), getattr(a, "data", a).numpy()
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.fixture(scope="module")
def sync_round(tmp_path_factory):
    params = demo_params(seed=SEED)
    reports = tmp_path_factory.mktemp("reports")
    res = run_socket_round(params, N_CLIENTS, seed=SEED, mode="sync", timeout_s=TIMEOUT_S,
                           device="cpu", report_dir=str(reports))
    return params, res


def test_demo_params_and_broadcast_match_reference():
    for seed in (0, SEED):
        t, j = demo_params(seed=seed), R.demo_params(seed=seed)
        assert encode_update(t) == jencode_update(j)
        assert params_hash(t) == R.params_hash(j)


@pytest.mark.parametrize("seed", [0, SEED, 19])
def test_client_program_matches_reference(seed):
    """Nonce, weight and blob per client: the nonce and weight exactly, the
    blob's codes, residuals and framing byte for byte (scales rtol 1e-6)."""
    start = decode_update(encode_update(demo_params(seed=seed)))
    jstart = jdecode_update(jencode_update(R.demo_params(seed=seed)))
    for cid in range(6):
        assert P.client_nonce(seed, cid) == R.client_nonce(seed, cid)
        assert client_weight(cid) == R.client_weight(cid)
        _same_but_scales(client_update_blob(start, cid, seed, device="cpu"),
                         R.client_update_blob(jstart, cid, seed))


def test_update_blob_is_pure_function_of_inputs():
    params = demo_params(seed=SEED)
    a = client_update_blob(params, 3, SEED, device="cpu")
    b = client_update_blob(params, 3, SEED, device="cpu")
    c = client_update_blob(params, 4, SEED, device="cpu")
    d = client_update_blob(params, 3, SEED + 1, device="cpu")
    ref = client_update_blob(params, 3, SEED, fused_encode=False, device="cpu")
    assert a == b and a != c and a != d
    _same_but_scales(ref, R.client_update_blob(_jparams(params), 3, SEED, fused_encode=False))
    assert client_weight(3) == client_weight(3) > 0


def _ref_blobs(tparams, seed, ids):
    jstart = jdecode_update(jencode_update(_jparams(tparams)))
    return [(cid, R.client_weight(cid), R.client_update_blob(jstart, cid, seed)) for cid in ids]


@pytest.mark.parametrize("mode,order,buffer_k,rule", [
    ("sync", [0, 1, 2, 3, 4], 4, "mean"),
    ("sync", [4, 0, 3], 4, "majority"),
    ("buffered", [0, 1, 2, 3, 4], 2, "mean"),
    ("buffered", [3, 1, 4, 0, 2], 3, "mean"),
    ("buffered", [2, 0], 4, "mean"),
])
def test_mix_on_reference_blobs_is_bit_identical(settled_reference, mode, order, buffer_k,
                                                 rule):
    """The port's mix of the reference's blobs is the reference's, bit for
    bit: each buffered batch streams into the long-lived aggregator before
    the mix (a mix that only finalized would fold nothing)."""
    params = demo_params(seed=SEED)
    arrivals = _ref_blobs(params, SEED, order)
    got = P._mix_arrivals(params, arrivals, mode, chunk_c=16, buffer_k=buffer_k, eta=0.5,
                          rule=rule, device="cpu")
    assert params_hash(got) == _reference_mix(params, arrivals, mode, buffer_k=buffer_k,
                                              rule=rule)
    assert params_hash(got) != params_hash(params)


def test_sync_aggregate_byte_identical_to_inprocess(sync_round, settled_reference):
    """Clients as real OS processes vs in-process calls: the same hash; and
    the reference's mix of the blobs the server received gives it too."""
    params, res = sync_round
    ref = run_inprocess_reference(params, N_CLIENTS, seed=SEED, mode="sync", device="cpu")
    assert params_hash(res.params) == params_hash(ref)
    assert params_hash(res.params) == _reference_mix(params, sorted(res.received), "sync")
    start = decode_update(encode_update(params))
    for cid, weight, blob in res.received:
        assert weight == client_weight(cid)
        assert blob == client_update_blob(start, cid, SEED, device="cpu")


def test_sync_round_served_all_clients(sync_round):
    _params, res = sync_round
    assert res.n_clients == N_CLIENTS
    assert sorted(res.arrivals) == list(range(N_CLIENTS))


def test_ledger_metered_from_socket_traffic(sync_round):
    """Upload bytes are the reference's HELLO and UPDATE frames exactly,
    download bytes its BCAST and DONE frames; the framing overhead is the
    difference to the payloads."""
    params, res = sync_round
    bcast = jencode_update(_jparams(params))
    up = down = payload = 0
    for cid, weight, blob in res.received:
        up += len(jt.pack_frame(FT_HELLO, meta={"client_id": cid, "proto": 2,
                                                "nonce": R.client_nonce(SEED, cid),
                                                "attempt": 0}))
        up += len(jt.pack_frame(FT_UPDATE, blob, {"client_id": cid,
                                                  "weight": R.client_weight(cid)}))
        down += len(jt.pack_frame(FT_BCAST, bcast, {"proto": 2}))
        down += len(jt.pack_frame(FT_DONE, meta={"proto": 2}))
        payload += len(blob)
    assert (res.upload_bytes, res.download_bytes, res.payload_bytes) == (up, down, payload)
    assert N_CLIENTS * 30 <= res.framing_overhead_bytes <= N_CLIENTS * 200
    assert res.download_bytes >= N_CLIENTS * len(bcast)


def test_client_reports(sync_round):
    """Each child reports its device and its launch counts (the CPU runs
    the plain versions: no kernel launch) and reached its HELLO."""
    _params, res = sync_round
    assert sorted(res.client_reports) == list(range(N_CLIENTS))
    for cid, rep in res.client_reports.items():
        assert rep["client_id"] == cid and rep["device"] == "cpu"
        assert rep["launches"] == {k: 0 for k in rep["launches"]}
        assert len(rep["launches"]) == 7
        assert 0 < rep["startup_s"] < TIMEOUT_S


def test_nofault_round_has_clean_fault_surface(sync_round):
    _params, res = sync_round
    assert res.committed == "full"
    assert all(v == "ok" for v in res.outcomes.values()) and len(res.outcomes) == N_CLIENTS
    assert res.dropped_update_bytes == 0
    assert res.retries == 0 and res.resumed_bytes == 0
    assert res.escalations == {"terminated": 0, "killed": 0}
    assert res.chaos is None
    assert res.ledger()["balance_ok"]
    assert res.shipped_update_bytes == res.ingested_update_bytes > 0


def test_buffered_mode_matches_reference_in_arrival_order(settled_reference):
    params = demo_params(seed=SEED + 1)
    res = run_socket_round(params, 4, seed=SEED + 1, mode="buffered", buffer_k=3, eta=0.5,
                           timeout_s=TIMEOUT_S, device="cpu")
    ref = run_inprocess_reference(params, 4, seed=SEED + 1, mode="buffered", buffer_k=3,
                                  eta=0.5, order=res.arrivals, device="cpu")
    assert params_hash(res.params) == params_hash(ref)
    assert params_hash(res.params) == _reference_mix(params, res.received, "buffered",
                                                     buffer_k=3)
    assert [cid for cid, _, _ in res.received] == res.arrivals
    assert params_hash(res.params) != params_hash(params)


def test_buffered_tail_folds_in_whole_buffers(monkeypatch, settled_reference):
    """Arrivals that land while a fold runs fold in buffer_k batches at the
    commit, as the in-process reference folds them. The reference's server
    folds the whole tail in one mix instead, so under a slow fold its round
    leaves its own in-process reference (ROADMAP Queue 3); here the first
    fold sleeps until every client has landed."""
    plain = P._buffered_mix
    calls = []

    def slow(*a, **kw):
        calls.append(len(a[1]))
        if len(calls) == 1:
            time.sleep(2.0)
        return plain(*a, **kw)

    monkeypatch.setattr(P, "_buffered_mix", slow)
    params = demo_params(seed=SEED + 4)
    res = run_socket_round(params, 5, seed=SEED + 4, mode="buffered", buffer_k=2, eta=0.5,
                           timeout_s=TIMEOUT_S, device="cpu")
    assert calls == [2, 2, 1]
    ref = run_inprocess_reference(params, 5, seed=SEED + 4, mode="buffered", buffer_k=2,
                                  eta=0.5, order=res.arrivals, device="cpu")
    assert params_hash(res.params) == params_hash(ref)
    assert params_hash(res.params) == _reference_mix(params, res.received, "buffered",
                                                     buffer_k=2)


def test_inprocess_reference_order_sensitivity():
    params = demo_params(seed=SEED)
    fwd = run_inprocess_reference(params, 5, seed=SEED, mode="buffered", buffer_k=2,
                                  order=[0, 1, 2, 3, 4], device="cpu")
    rev = run_inprocess_reference(params, 5, seed=SEED, mode="buffered", buffer_k=2,
                                  order=[4, 3, 2, 1, 0], device="cpu")
    assert params_hash(fwd) != params_hash(rev)
    s1 = run_inprocess_reference(params, 3, seed=SEED, order=[2, 0, 1], device="cpu")
    s2 = run_inprocess_reference(params, 3, seed=SEED, order=[0, 1, 2], device="cpu")
    assert params_hash(s1) != params_hash(s2)   # sync folds in the order given


def test_bad_args_rejected(monkeypatch):
    params = demo_params()
    for kw, match in ((dict(n_clients=0), "n_clients"), (dict(mode="nope"), "mode"),
                      (dict(quorum_frac=0.0), "quorum_frac"),
                      (dict(quorum_frac=1.5), "quorum_frac")):
        kw = {"n_clients": 1, **kw}
        with pytest.raises(ValueError, match=match):
            run_socket_round(params, device="cpu", **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: run_socket_round(params, 2),
               lambda: run_inprocess_reference(params, 2),
               lambda: client_update_blob(params, 0, 0),
               lambda: P.main(["--clients", "2"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def test_validate_update_weight_meta_like_reference():
    def update(mod, meta):
        return mod.Frame(ftype=FT_UPDATE, meta={"client_id": 3, **meta}, payload=b"x")

    assert P._validate_update(update(P, {"weight": 12.5}), 3) == 12.5
    assert P._validate_update(update(P, {"weight": 0}), 3) == 0.0
    for bad in ({}, {"weight": None}, {"weight": "forty"}, {"weight": float("nan")},
                {"weight": float("inf")}, {"weight": -1.0}, {"weight": 1.0, "client_id": 4}):
        with pytest.raises(Exception) as port:
            P._validate_update(update(P, bad), 3)
        with pytest.raises(Exception) as ref:
            R._validate_update(update(R, bad), 3)
        assert (type(port.value).__name__, str(port.value)) == \
            (type(ref.value).__name__, str(ref.value))
        if "client_id" not in bad:
            assert isinstance(port.value, FrameError)


@pytest.mark.parametrize("rule", ["mean", "majority"])
def test_defended_round_quarantines_attackers_and_matches_honest_ref(rule):
    from repro.fed.attackers import AttackConfig as JAttackConfig
    from repro.fed.attackers import attacker_ids as jattacker_ids
    from repro_torch.fed.attackers import AttackConfig, attacker_ids
    from repro_torch.fed.defense import DefenseConfig

    n, n_atk = 5, 2
    params = demo_params(seed=SEED + 2)
    attack = AttackConfig(kind="nan_poison", n_attackers=n_atk, seed=SEED)
    attackers = attacker_ids(attack, n)
    assert attackers == jattacker_ids(JAttackConfig(kind="nan_poison", n_attackers=n_atk,
                                                    seed=SEED), n)
    res = run_socket_round(params, n, seed=SEED + 2, mode="sync", timeout_s=TIMEOUT_S,
                           defense=DefenseConfig(enabled=True, rule=rule), attack=attack,
                           quorum_frac=(n - n_atk) / n, device="cpu")
    assert res.committed in ("full", "quorum")
    assert {c for c, v in res.outcomes.items() if v == "quarantined"} == set(attackers)
    assert res.defense["quarantined_updates"] == n_atk and res.defense["rule"] == rule
    assert res.quarantined_update_bytes > 0
    assert res.ledger()["balance_ok"]
    assert (res.shipped_update_bytes == res.ingested_update_bytes
            + res.dropped_update_bytes + res.quarantined_update_bytes)
    honest = sorted(set(range(n)) - set(attackers))
    ref = run_inprocess_reference(params, n, seed=SEED + 2, mode="sync", order=honest,
                                  rule=rule, device="cpu")
    assert params_hash(res.params) == params_hash(ref)
    assert params_hash(res.params) == _reference_mix(params, sorted(res.received), "sync",
                                                     rule=rule)


def test_defense_on_honest_socket_round_is_byte_identical():
    from repro_torch.fed.defense import DefenseConfig

    params = demo_params(seed=SEED + 3)
    res = run_socket_round(params, 4, seed=SEED + 3, mode="sync", timeout_s=TIMEOUT_S,
                           defense=DefenseConfig(enabled=True), device="cpu")
    assert all(v == "ok" for v in res.outcomes.values())
    assert res.defense["quarantined_updates"] == 0 and res.ledger()["balance_ok"]
    ref = run_inprocess_reference(params, 4, seed=SEED + 3, mode="sync", device="cpu")
    assert params_hash(res.params) == params_hash(ref)


def test_aggregate_value_is_weighted_mean():
    from repro_torch.fed.simulation import dequantize_tree
    from repro_torch.tree import tree_leaves

    params = demo_params(seed=3, d=16, depth=1)
    n = 3
    start = decode_update(encode_update(params))
    blobs = [client_update_blob(start, cid, 3, device="cpu") for cid in range(n)]
    w = np.array([client_weight(cid) for cid in range(n)])
    dense = [tree_leaves(dequantize_tree(decode_update(b), torch.device("cpu"))) for b in blobs]
    ref = run_inprocess_reference(params, n, seed=3, mode="sync", device="cpu")
    for i, leaf in enumerate(tree_leaves(ref)):
        manual = sum(w[k] * dense[k][i].double().numpy() for k in range(n)) / w.sum()
        np.testing.assert_allclose(leaf.double().numpy(), manual, rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------------
# Interop, in threads: one package's server, the other's client.
# --------------------------------------------------------------------------


def _serve_one(server, client_fn, timeout_s=60.0) -> dict:
    """Run one client conversation against one package's accept loop; the
    server state it leaves, as values."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    srv.settimeout(0.1)
    state = server._RoundState()
    handlers: list = []
    params = demo_params(seed=SEED)
    bcast = (encode_update(params) if server is P else jencode_update(_jparams(params)))
    acceptor = threading.Thread(target=server._accept_loop,
                                args=(srv, state, bcast, timeout_s, handlers), daemon=True)
    acceptor.start()
    exit_code = {}

    def client():
        try:
            client_fn(srv.getsockname()[1])
            exit_code["code"] = 0
        except SystemExit as e:     # the client's exit code on rejection
            exit_code["code"] = e.code

    t = threading.Thread(target=client, daemon=True)
    t.start()
    t.join(timeout=timeout_s)
    end = time.monotonic() + 10
    while time.monotonic() < end and any(h.is_alive() for h in handlers):
        time.sleep(0.01)
    with state.cond:
        state.closing = True
    srv.close()
    acceptor.join(timeout=5)
    for h in handlers:
        h.join(timeout=5)
    sessions = {cid: (s.nonce, s.dec.bytes_in, s.completed, s.frame_bytes, s.attempts)
                for cid, s in state.sessions.items()}
    return {"completed": state.completed, "rejected": state.rejected,
            "up": state.up_bytes, "down": state.down_bytes, "payload": state.payload_bytes,
            "ingested": state.ingested_update_bytes, "v1": state.v1_update_bytes,
            "retries": state.retries, "sessions": sessions, "exit": exit_code.get("code")}


def _port_client(cid, proto):
    return lambda port: P._client_main("127.0.0.1", port, cid, SEED, 30.0, proto=proto,
                                       device="cpu")


def _ref_client(cid, proto):
    return lambda port: R._client_main("127.0.0.1", port, cid, SEED, 30.0, proto=proto)


@pytest.mark.parametrize("proto", [2, 1, 99])
def test_port_server_serves_reference_client(proto):
    """The reference's client through the port's server books exactly what
    it books through the reference's server: the update, the outcome and
    every metered byte."""
    cid = 3
    got = _serve_one(P, _ref_client(cid, proto))
    want = _serve_one(R, _ref_client(cid, proto))
    assert got == want
    if proto == 99:
        assert got["rejected"] == {cid: "unsupported proto 99"} and got["exit"] == 4
    else:
        (booked,) = got["completed"]
        jstart = jdecode_update(jencode_update(_jparams(demo_params(seed=SEED))))
        assert booked == (cid, R.client_weight(cid), R.client_update_blob(jstart, cid, SEED))
        assert got["exit"] == 0 and got["up"] > got["payload"] > 0


@pytest.mark.parametrize("proto", [2, 1, 99])
def test_reference_server_serves_port_client(proto):
    """The port's client through the reference's server books exactly what
    it books through the port's server."""
    cid = 4
    got = _serve_one(R, _port_client(cid, proto))
    want = _serve_one(P, _port_client(cid, proto))
    assert got == want
    if proto == 99:
        assert got["rejected"] == {cid: "unsupported proto 99"} and got["exit"] == 4
    else:
        (booked,) = got["completed"]
        start = decode_update(encode_update(demo_params(seed=SEED)))
        assert booked == (cid, client_weight(cid),
                          client_update_blob(start, cid, SEED, device="cpu"))
