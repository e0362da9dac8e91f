"""Port vs reference: the deterministic fault injector (``comm.faults``).

``FaultSchedule`` action streams, ``connect_action`` and
``first_kill_offset`` equal the reference's for every (seed, client,
attempt) key, at the chaos preset, bursty rates and the scaled chunk size
of the card's ResNet18* chaos round. Then the cases of
``tests/test_faults.py`` on the port's ``ChaosProxy`` over real loopback
sockets (transparent, throttle, refuse, kill, garbage, delay, the
server→client pump, RST aborts), and the Byzantine corrupt mode, whose
poisoned frame must be the reference proxy's byte for byte."""

import dataclasses
import socket
import threading

import numpy as np
import pytest
import torch

import repro_torch.comm.faults as pf
from repro.comm import faults as jf
from repro.comm.wire import encode_update as jencode_update
from repro_torch.comm import (
    FT_HELLO, FT_UPDATE, ChaosProxy, FaultConfig, FaultSchedule, FrameDecoder, TransportError,
    pack_frame, recv_frame, send_frame,
)
from repro_torch.comm.faults import DELAY, KILL, OK, REFUSE, abort_socket
from repro_torch.comm.wire import decode_update_leaves, encode_update
from repro_torch.fed.mp_server import default_chaos

torch.set_num_threads(1)

BURSTY = dict(ge_p_good_bad=0.3, ge_p_bad_good=0.3, fault_good=0.05,
              fault_bad=0.8, p_kill=0.5, p_refuse=0.5, delay_s=0.001)

CONFIGS = {
    "preset19": lambda m: m.FaultConfig(**_preset(19)),
    "preset19_resnet": lambda m: m.FaultConfig(**dict(_preset(19), chunk_bytes=45_728)),
    "preset7": lambda m: m.FaultConfig(**_preset(7)),
    "bursty": lambda m: m.FaultConfig(seed=3, chunk_bytes=64, **BURSTY),
    "killer": lambda m: m.FaultConfig(seed=1, chunk_bytes=128, ge_p_good_bad=0.9,
                                      ge_p_bad_good=0.1, fault_bad=0.9, p_kill=0.9,
                                      p_refuse=0.0),
    "good_faults": lambda m: m.FaultConfig(seed=2, fault_good=0.3, fault_bad=0.0),
    "disabled": lambda m: m.FaultConfig(seed=9, fault_good=0.0, fault_bad=0.0),
}


def _preset(seed):
    cfg = default_chaos(seed=seed, n_clients=6)
    return {f: getattr(cfg, f) for f in ("seed", "chunk_bytes", "ge_p_good_bad",
                                         "ge_p_bad_good", "fault_good", "fault_bad",
                                         "p_kill", "p_refuse", "delay_s", "crash_clients",
                                         "crash_after_frac")}


def test_default_chaos_matches_reference_preset():
    from repro.fed.mp_server import default_chaos as jdefault_chaos

    for seed, n in ((19, 6), (0, 4)):
        assert (dataclasses.asdict(default_chaos(seed=seed, n_clients=n))
                == dataclasses.asdict(jdefault_chaos(seed=seed, n_clients=n)))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_schedule_streams_match_reference(name):
    """Per key: the connect action, the first 64 chunk actions (consumed in
    order) and the kill offset of a 4 KiB and a 200 KiB upstream."""
    pcfg, jcfg = CONFIGS[name](pf), CONFIGS[name](jf)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert pcfg.disabled == jcfg.disabled and pcfg.stationary_p_bad == jcfg.stationary_p_bad
    for cid in range(8):
        for attempt in range(5):
            p, j = FaultSchedule(pcfg, cid, attempt), jf.FaultSchedule(jcfg, cid, attempt)
            assert p.key == j.key
            assert p.connect_action() == j.connect_action()
            assert [p.action_at(i) for i in range(64)] == [j.action_at(i) for i in range(64)]
            for nbytes in (4096, 200_000):
                p2, j2 = FaultSchedule(pcfg, cid, attempt), jf.FaultSchedule(jcfg, cid, attempt)
                assert p2.first_kill_offset(nbytes) == j2.first_kill_offset(nbytes)


def test_schedule_is_deterministic_per_key():
    cfg = FaultConfig(seed=3, chunk_bytes=64, **BURSTY)
    a, b = FaultSchedule(cfg, 2, 1), FaultSchedule(cfg, 2, 1)
    assert a.connect_action() == b.connect_action()
    assert [a.action_at(i) for i in range(32)] == [b.action_at(i) for i in range(32)]


def test_schedule_lazy_fill_is_prefix_stable():
    cfg = FaultConfig(seed=5, chunk_bytes=64, **BURSTY)
    eager = FaultSchedule(cfg, 1, 0)
    in_order = [eager.action_at(i) for i in range(21)]
    lazy = FaultSchedule(cfg, 1, 0)
    assert lazy.action_at(20) == in_order[20]
    assert [lazy.action_at(i) for i in range(21)] == in_order
    ref = jf.FaultSchedule(jf.FaultConfig(seed=5, chunk_bytes=64, **BURSTY), 1, 0)
    assert ref.action_at(20) == in_order[20]


def test_schedule_keys_decorrelate():
    cfg = FaultConfig(seed=0, chunk_bytes=64, **BURSTY)
    streams = {(cid, att): tuple(FaultSchedule(cfg, cid, att).action_at(i) for i in range(64))
               for cid in range(4) for att in range(2)}
    assert len(set(streams.values())) > 1


def test_disabled_schedule_draws_nothing():
    cfg = FaultConfig(seed=9, fault_good=0.0, fault_bad=0.0)
    s = FaultSchedule(cfg, 0, 0)
    assert cfg.disabled and s.connect_action() == OK
    assert all(s.action_at(i) == (OK, 0.0) for i in range(16))
    assert s.first_kill_offset(1 << 20) is None
    assert s._rng.bit_generator.state == np.random.default_rng(
        [9, 0x5EED_FA17, 0, 0]).bit_generator.state


def test_first_kill_offset_matches_action_stream():
    cfg = FaultConfig(seed=1, chunk_bytes=128, ge_p_good_bad=0.9, ge_p_bad_good=0.1,
                      fault_bad=0.9, p_kill=0.9, p_refuse=0.0)
    found = 0
    for cid in range(8):
        s = FaultSchedule(cfg, cid, 0)
        off = s.first_kill_offset(4096)
        if off is None:
            continue
        found += 1
        idx = off // cfg.chunk_bytes
        assert off == idx * cfg.chunk_bytes and s.action_at(idx)[0] == KILL
        assert all(s.action_at(i)[0] != KILL for i in range(idx))
    assert found > 0


@pytest.mark.parametrize("bad,match", [(dict(fault_bad=1.5), "fault_bad"),
                                       (dict(p_refuse=-0.1), "p_refuse"),
                                       (dict(chunk_bytes=0), "chunk_bytes"),
                                       (dict(corrupt_clients=(1,), corrupt_kind="frobnicate"),
                                        "corrupt_kind")])
def test_config_validation_like_reference(bad, match):
    with pytest.raises(ValueError, match=match) as port:
        FaultConfig(**bad)
    with pytest.raises(ValueError) as ref:
        jf.FaultConfig(**bad)
    assert str(port.value) == str(ref.value)
    assert 0.0 < FaultConfig(**BURSTY).stationary_p_bad < 1.0
    FaultConfig(corrupt_clients=(), corrupt_kind="frobnicate")


# --------------------------------------------------------------------------
# The proxy over real sockets.
# --------------------------------------------------------------------------


def _upstream_sink():
    """A server that answers any HELLO with FT_UPDATE echoing the client id
    and records per-connection received byte totals."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    srv.settimeout(0.1)
    stop = threading.Event()
    received: list[int] = []

    def run():
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=handle, args=(conn,), daemon=True).start()

    def handle(conn):
        n = 0
        conn.settimeout(10)
        try:
            dec = FrameDecoder()
            hello = recv_frame(conn, dec, timeout_s=10)
            n += dec.bytes_in
            send_frame(conn, FT_UPDATE, b"r" * 64, {"echo": hello.meta.get("client_id", -1)})
            while True:
                chunk = conn.recv(1 << 16)
                if not chunk:
                    break
                n += len(chunk)
        except (TransportError, OSError):
            pass
        finally:
            received.append(n)
            conn.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def close():
        stop.set()
        srv.close()
        t.join(timeout=5)

    return srv.getsockname(), received, close


def _hello(cid, attempt=0):
    return pack_frame(FT_HELLO, meta={"client_id": cid, "attempt": attempt, "proto": 2,
                                      "nonce": "ab"})


def _wait_for(received, tries=200):
    for _ in range(tries):
        if received:
            return
        threading.Event().wait(0.05)


def test_proxy_is_transparent_when_disabled():
    addr, received, close = _upstream_sink()
    try:
        with ChaosProxy(addr, FaultConfig(fault_good=0.0, fault_bad=0.0)) as proxy:
            with socket.create_connection(("127.0.0.1", proxy.port), timeout=10) as s:
                h = _hello(1)
                s.sendall(h)
                reply = recv_frame(s, timeout_s=10)
                assert reply.ftype == FT_UPDATE and reply.meta["echo"] == 1
                body = b"x" * 3000
                s.sendall(body)
                s.shutdown(socket.SHUT_WR)
                _wait_for(received)
                assert received and received[0] == len(h) + len(body)
            assert proxy.stats["refused"] == 0 and proxy.stats["killed"] == 0
            assert proxy.stats["bytes_up"] == len(h) + len(body)
    finally:
        close()


def test_proxy_throttle_paces_but_delivers_everything():
    addr, received, close = _upstream_sink()
    cfg = FaultConfig(fault_good=0.0, fault_bad=0.0, throttle_bytes=64,
                      throttle_delay_s=0.0005)
    try:
        with ChaosProxy(addr, cfg) as proxy:
            with socket.create_connection(("127.0.0.1", proxy.port), timeout=10) as s:
                h = _hello(2)
                s.sendall(h)
                assert recv_frame(s, timeout_s=10).ftype == FT_UPDATE
                body = b"y" * 2048
                s.sendall(body)
                s.shutdown(socket.SHUT_WR)
                _wait_for(received)
                assert received and received[0] == len(h) + len(body)
    finally:
        close()


def _find_key(cfg, want, nbytes=4096, max_cid=64):
    for cid in range(max_cid):
        s = FaultSchedule(cfg, cid, 0)
        if want == REFUSE and s.connect_action() == REFUSE:
            return cid, None
        if want == KILL and s.connect_action() == OK:
            off = s.first_kill_offset(nbytes)
            if off is not None and off > 0:
                return cid, off
    raise AssertionError(f"no {want} key in range — pick other rates")


def test_proxy_refuses_deterministically():
    addr, received, close = _upstream_sink()
    cfg = FaultConfig(seed=2, chunk_bytes=256, **BURSTY)
    cid, _ = _find_key(cfg, REFUSE)
    try:
        with ChaosProxy(addr, cfg) as proxy:
            for _ in range(2):
                with pytest.raises((TransportError, OSError)):
                    with socket.create_connection(("127.0.0.1", proxy.port), timeout=10) as s:
                        s.sendall(_hello(cid))
                        recv_frame(s, timeout_s=10)
            assert proxy.stats["refused"] == 2
        assert not received
    finally:
        close()


def test_proxy_kill_truncates_upload_mid_stream():
    addr, received, close = _upstream_sink()
    cfg = FaultConfig(seed=4, chunk_bytes=256, ge_p_good_bad=0.9, ge_p_bad_good=0.1,
                      fault_bad=0.9, p_kill=0.9, p_refuse=0.0, delay_s=0.0)
    cid, off = _find_key(cfg, KILL, nbytes=4096)
    try:
        with ChaosProxy(addr, cfg) as proxy:
            h = _hello(cid)
            body = pack_frame(FT_UPDATE, b"k" * 8000, {"client_id": cid})
            sent = len(h) + len(body)
            assert sent > off
            with pytest.raises((TransportError, OSError)):
                with socket.create_connection(("127.0.0.1", proxy.port), timeout=10) as s:
                    s.sendall(h)
                    s.sendall(body)
                    s.shutdown(socket.SHUT_WR)
                    while True:
                        if not s.recv(1 << 16):
                            raise TransportError("clean EOF (no reply sent)")
            _wait_for(received)
            assert proxy.stats["killed"] >= 1
            assert received and received[0] <= off < sent
    finally:
        close()


def test_proxy_resets_on_garbage_first_bytes():
    addr, received, close = _upstream_sink()
    try:
        with ChaosProxy(addr, FaultConfig(fault_good=0.0, fault_bad=0.0)) as proxy:
            with pytest.raises((TransportError, OSError)):
                with socket.create_connection(("127.0.0.1", proxy.port), timeout=10) as s:
                    s.sendall(b"GET / HTTP/1.1\r\n\r\n" + b"\x00" * 32)
                    recv_frame(s, timeout_s=10)
        assert not received
    finally:
        close()


def test_abort_socket_sends_rst_not_fin():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    client = socket.create_connection(("127.0.0.1", srv.getsockname()[1]), timeout=10)
    conn, _ = srv.accept()
    try:
        conn.sendall(b"half a frame")
        abort_socket(conn)
        client.settimeout(10)
        with pytest.raises(OSError):
            while True:
                assert client.recv(1 << 16), "peer saw clean EOF — abort sent FIN, not RST"
    finally:
        client.close()
        srv.close()


def test_delay_action_is_counted_and_harmless():
    cfg = FaultConfig(seed=6, chunk_bytes=128, ge_p_good_bad=0.9, ge_p_bad_good=0.1,
                      fault_bad=0.9, p_kill=0.0, p_refuse=0.0, delay_s=0.001)
    cid = next(c for c in range(32)
               if FaultSchedule(cfg, c, 0).connect_action() == OK
               and any(FaultSchedule(cfg, c, 0).action_at(i)[0] == DELAY for i in range(8)))
    addr, received, close = _upstream_sink()
    try:
        with ChaosProxy(addr, cfg) as proxy:
            h = _hello(cid)
            with socket.create_connection(("127.0.0.1", proxy.port), timeout=10) as s:
                s.sendall(h)
                assert recv_frame(s, timeout_s=10).ftype == FT_UPDATE
                s.sendall(b"d" * 900)
                s.shutdown(socket.SHUT_WR)
                _wait_for(received)
            assert received and received[0] == len(h) + 900
            assert proxy.stats["delayed_chunks"] >= 1
    finally:
        close()


def _idle_proxy():
    return ChaosProxy(("127.0.0.1", 1), FaultConfig(fault_good=0.0, fault_bad=0.0))


def test_pump_down_forwards_bytes_and_half_close():
    up_pump, up_srv = socket.socketpair()
    cn_pump, cn_cli = socket.socketpair()
    with _idle_proxy() as proxy:
        t = threading.Thread(target=proxy._pump_down,
                             args=(up_pump, cn_pump, threading.Event()), daemon=True)
        t.start()
        body = b"s" * 5000
        up_srv.sendall(body)
        up_srv.shutdown(socket.SHUT_WR)
        got = bytearray()
        cn_cli.settimeout(10)
        while chunk := cn_cli.recv(1 << 16):
            got += chunk
        t.join(timeout=10)
        assert not t.is_alive() and bytes(got) == body
        assert proxy.stats["bytes_down"] == len(body)
    for s in (up_pump, up_srv, cn_pump, cn_cli):
        s.close()


def test_pump_down_stops_on_killed_without_forwarding():
    up_pump, up_srv = socket.socketpair()
    cn_pump, cn_cli = socket.socketpair()
    with _idle_proxy() as proxy:
        killed = threading.Event()
        killed.set()
        up_srv.sendall(b"too late" * 64)
        t = threading.Thread(target=proxy._pump_down, args=(up_pump, cn_pump, killed),
                             daemon=True)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and proxy.stats["bytes_down"] == 0
        cn_cli.setblocking(False)
        with pytest.raises(BlockingIOError):
            cn_cli.recv(1)
    for s in (up_pump, up_srv, cn_pump, cn_cli):
        s.close()


def test_pump_down_survives_already_dead_upstream():
    up_pump, up_srv = socket.socketpair()
    cn_pump, cn_cli = socket.socketpair()
    up_pump.close()
    with _idle_proxy() as proxy:
        proxy._pump_down(up_pump, cn_pump, threading.Event())
        assert proxy.stats["bytes_down"] == 0
    for s in (up_srv, cn_pump, cn_cli):
        s.close()


# --------------------------------------------------------------------------
# Byzantine corrupt mode: poisoned but wire-valid frames.
# --------------------------------------------------------------------------


def _frame_sink():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    srv.settimeout(0.1)
    stop = threading.Event()
    frames: list = []

    def run():
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(10)
            dec = FrameDecoder()
            try:
                while chunk := conn.recv(1 << 16):
                    for f in dec.feed(chunk):
                        frames.append((f.ftype, f.payload, dict(f.meta)))
            except (TransportError, OSError):
                pass
            finally:
                conn.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def close():
        stop.set()
        srv.close()
        t.join(timeout=5)

    return srv.getsockname(), frames, close


def _proxied_frames(proxy_mod, payload, cid, **cfg_kw):
    """(frames the upstream saw, corrupted_frames) for one client's HELLO +
    UPDATE through one package's proxy."""
    addr, frames, close = _frame_sink()
    cfg = proxy_mod.FaultConfig(fault_good=0.0, fault_bad=0.0, **cfg_kw)
    try:
        with proxy_mod.ChaosProxy(addr, cfg) as proxy:
            with socket.create_connection(("127.0.0.1", proxy.port), timeout=10) as s:
                s.sendall(_hello(cid))
                s.sendall(pack_frame(FT_UPDATE, payload, {"client_id": cid, "weight": 3.0}))
                s.shutdown(socket.SHUT_WR)
            for _ in range(200):
                if len(frames) >= 2:
                    break
                threading.Event().wait(0.05)
            n_corrupt = proxy.stats["corrupted_frames"]
    finally:
        close()
    return frames, n_corrupt


@pytest.mark.parametrize("kind", ["sign_flip", "nan_poison", "gaussian"])
def test_corrupt_mode_poisons_like_the_reference_proxy(kind):
    """A corrupt client's UPDATE is decoded in-path, poisoned with the seeded
    attacker and re-packed with a fresh CRC: the upstream sees the same
    frame bytes behind the port's proxy as behind the reference's, and the
    HELLO and the frame meta ride through untouched."""
    honest = np.arange(8, dtype=np.float32) + 1.0
    payload = encode_update({"w": torch.from_numpy(honest)})
    assert payload == jencode_update({"w": honest})
    kw = dict(corrupt_clients=(3,), corrupt_kind=kind, corrupt_seed=5)
    got, n = _proxied_frames(pf, payload, 3, **kw)
    ref, n_ref = _proxied_frames(jf, payload, 3, **kw)
    assert n == n_ref == 1
    assert got == ref
    (hello_t, _, hello_meta), (upd_t, upd_payload, upd_meta) = got
    assert hello_t == FT_HELLO and hello_meta["client_id"] == 3
    assert upd_t == FT_UPDATE and upd_meta["weight"] == 3.0 and upd_payload != payload
    (path, leaf), = decode_update_leaves(upd_payload)
    if kind == "sign_flip":
        np.testing.assert_array_equal(leaf.numpy(), -honest)


def test_corrupt_mode_leaves_other_clients_byte_identical():
    payload = encode_update({"w": torch.ones(16)})
    frames, n = _proxied_frames(pf, payload, 7, corrupt_clients=(3,))
    assert n == 0 and frames[1][0] == FT_UPDATE and frames[1][1] == payload
