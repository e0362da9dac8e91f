"""Port vs reference: TFT1 framing (``comm.transport``).

``pack_frame`` buffers byte-identical to the reference's (the HELLO and
UPDATE metas of the socket round included); ``FrameDecoder`` under every
chunking — one byte at a time, the payload-cap boundary, torn closes,
malformed headers and metas, ``take_buffer`` — gives the reference's
frames, counters and errors; ``RetryPolicy.backoff_s`` sequences under a
seeded rng and ``call_with_retries`` attempt/sleep traces equal the
reference's. Then the loopback cases of ``tests/test_transport.py`` on the
port, and frames crossing between the two packages over real sockets."""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from repro.comm import transport as jt
from repro_torch.comm import (
    FT_BCAST, FT_DONE, FT_ERR, FT_HELLO, FT_RESUME, FT_UPDATE, FrameDecoder, FrameError,
    ProtocolError, RetryExhausted, RetryPolicy, TornConnectionError, TransportError,
    TransportTimeout, call_with_retries, decode_update, encode_update, pack_frame,
    recv_frame, send_frame,
)
from repro_torch.comm import transport as pt
from repro_torch.comm.transport import _FRAME, TRANSPORT_MAGIC

torch.set_num_threads(1)


def _update_blob(seed=0):
    rng = np.random.default_rng(seed)
    return encode_update({
        "w": torch.from_numpy(rng.normal(size=(6, 5)).astype(np.float32)),
        "b": torch.from_numpy(rng.normal(size=(5,)).astype(np.float32)),
    })


def _chunked(blob, n):
    return [blob[i:i + n] for i in range(0, len(blob), n)]


def _frames(frames):
    return [(f.ftype, f.meta, f.payload, f.nbytes_framed) for f in frames]


def _decode_outcome(mod, chunks, *, close=True, **kw):
    """What a package's FrameDecoder makes of a chunk sequence: per feed the
    frames it completed, then its counters; or the error it raised."""
    dec = mod.FrameDecoder(**kw)
    fed = []
    try:
        for chunk in chunks:
            fed.append(_frames(dec.feed(chunk)))
        if close:
            dec.close()
    except Exception as e:  # noqa: BLE001 — the error IS the outcome
        return ("error", type(e).__name__, str(e), fed)
    return ("ok", fed, dec.bytes_in, dec.pending_bytes, dec.closed)


def _both(chunks, **kw):
    got = _decode_outcome(pt, chunks, **kw)
    assert got == _decode_outcome(jt, chunks, **kw)
    return got


def test_constants_match_reference():
    for name in ("TRANSPORT_MAGIC", "FT_HELLO", "FT_BCAST", "FT_UPDATE", "FT_DONE", "FT_ERR",
                 "FT_RESUME", "PROTO_V1", "PROTO_VERSION", "SUPPORTED_PROTOS",
                 "MAX_PAYLOAD_BYTES", "RECV_CHUNK"):
        assert getattr(pt, name) == getattr(jt, name), name
    assert pt._FRAME.format == jt._FRAME.format and pt._FRAME.size == 16


# the frames the socket round sends, and the metas that must not drift by
# one byte (a chaos round's kill offsets are absolute byte offsets)
FRAMES = [
    (FT_HELLO, b"", {"client_id": 3, "proto": 2, "nonce": "7004aeec3b3f51b9", "attempt": 0}),
    (FT_HELLO, b"", {"client_id": 3, "proto": 2, "nonce": "ab", "attempt": 2, "resume": True}),
    (FT_HELLO, b"", {"client_id": 1}),
    (FT_UPDATE, "blob", {"client_id": 4, "weight": 40.0}),
    (FT_UPDATE, "blob", {"client_id": 4, "weight": 40}),
    (FT_BCAST, "blob", {"proto": 2}),
    (FT_BCAST, "blob", None),
    (FT_RESUME, b"", {"have": 1234, "proto": 2}),
    (FT_DONE, b"", {"proto": 2}),
    (FT_DONE, b"", None),
    (FT_ERR, b"", {"error": "unsupported proto 99", "supported": [1, 2]}),
    (FT_ERR, b"", {"error": "naïve ünïcode"}),
]


@pytest.mark.parametrize("i", range(len(FRAMES)))
def test_pack_frame_byte_identical_to_reference(i):
    ftype, payload, meta = FRAMES[i]
    payload = _update_blob(i) if payload == "blob" else payload
    got = pack_frame(ftype, payload, meta)
    assert got == jt.pack_frame(ftype, payload, meta)
    assert pt._meta_bytes(meta) == jt._meta_bytes(meta)
    frame = pt.Frame(ftype, meta or {}, payload)
    assert frame.nbytes_framed == len(got) == jt.Frame(ftype, meta or {}, payload).nbytes_framed


def _wire():
    return (pack_frame(FT_UPDATE, _update_blob(), {"client_id": 7, "weight": 1.5})
            + pack_frame(FT_DONE) + pack_frame(FT_HELLO, b"", {"client_id": 7}))


@pytest.mark.parametrize("n", [1, 3, 16, 17, 1000, 10 ** 9])
def test_frame_roundtrip_any_chunking_like_reference(n):
    wire = _wire()
    got = _both(_chunked(wire, n))
    assert got[0] == "ok" and got[2] == len(wire)
    frames = [f for fed in got[1] for f in fed]
    assert [f[0] for f in frames] == [FT_UPDATE, FT_DONE, FT_HELLO]
    assert frames[0][1] == {"client_id": 7, "weight": 1.5}
    assert frames[0][2] == _update_blob()
    assert sum(f[3] for f in frames) == len(wire)


def test_pop_drains_in_order_without_loss():
    wire = b"".join(pack_frame(FT_UPDATE, bytes([i]) * 3, {"i": i}) for i in range(5))
    for mod in (pt, jt):
        dec = mod.FrameDecoder()
        dec.feed(wire)
        seen = []
        while (f := dec.pop()) is not None:
            seen.append(f.meta["i"])
        assert seen == [0, 1, 2, 3, 4]
        assert dec.pop() is None


def test_bad_header_fails_fast_like_reference():
    good = pack_frame(FT_UPDATE, b"x" * 100)
    cases = [
        [b"WAT?" + good[4:_FRAME.size]],
        [_FRAME.pack(TRANSPORT_MAGIC, 200, 0, 0, 0)],
        [_FRAME.pack(TRANSPORT_MAGIC, FT_UPDATE, 0, 0, 1 << 60)],
        [b"TF", b"T2" + good[4:_FRAME.size]],
    ]
    for chunks, match in zip(cases, ("magic", "unknown frame type", "corrupted length",
                                     "magic")):
        got = _both(chunks, close=False)
        assert got[0] == "error" and got[1] == "FrameError" and match in got[2]
    for mod in (pt, jt):
        with pytest.raises(mod.TransportError, match="unknown frame type"):
            mod.pack_frame(99, b"")
        with pytest.raises(mod.FrameError, match="meta too large"):
            mod.pack_frame(FT_HELLO, b"", {"k": "x" * 70000})


def test_malformed_meta_is_transport_error_like_reference():
    for meta, match in ((b"{not json", "meta"), (b"[1,2]", "JSON object"),
                        (b"\xff\xfe", "meta")):
        raw = _FRAME.pack(TRANSPORT_MAGIC, FT_HELLO, 0, len(meta), 0) + meta
        got = _both([raw], close=False)
        assert got[0] == "error" and got[1] == "FrameError" and match in got[2]


def test_torn_connection_raises_on_close_like_reference():
    frame = pack_frame(FT_UPDATE, b"z" * 64)
    for cut in (1, _FRAME.size - 1, _FRAME.size, _FRAME.size + 10, len(frame) - 1):
        got = _both([frame[:cut]])
        assert got[0] == "error" and got[1] == "TornConnectionError"
        assert "mid-frame" in got[2] and got[3] == [[]]
    assert _both([]) == ("ok", [], 0, 0, True)


@pytest.mark.parametrize("split", [False, True])
def test_payload_cap_boundary_exact_like_reference(split):
    """A payload of exactly the cap parses; one byte more is refused with
    only the header in hand."""
    cap = 1024
    ok = pack_frame(FT_UPDATE, b"p" * cap)
    chunks = _chunked(ok, 1) if split else [ok]
    got = _both(chunks, max_payload_bytes=cap)
    assert got[0] == "ok" and len([f for fed in got[1] for f in fed]) == 1
    over = _FRAME.pack(TRANSPORT_MAGIC, FT_UPDATE, 0, 0, cap + 1)
    chunks = _chunked(over, 1) if split else [over[:_FRAME.size]]
    got = _both(chunks, close=False, max_payload_bytes=cap)
    assert got[0] == "error" and "exceeds cap" in got[2]


def test_feed_after_close_is_frame_error_like_reference():
    frame = pack_frame(FT_UPDATE, b"z" * 64)
    for mod in (pt, jt):
        dec = mod.FrameDecoder()
        dec.feed(mod.pack_frame(FT_DONE))
        dec.close()
        with pytest.raises(mod.FrameError, match="after close"):
            dec.feed(b"x")
        torn = mod.FrameDecoder()
        torn.feed(frame[:10])
        with pytest.raises(mod.TransportError, match="mid-frame"):
            torn.close()
        with pytest.raises(mod.FrameError, match="after close"):
            torn.feed(frame[10:])


def test_byte_at_a_time_slow_sender_like_reference():
    wire = (pack_frame(FT_HELLO, meta={"client_id": 1})
            + pack_frame(FT_UPDATE, b"u" * 257, {"weight": 2.0}) + pack_frame(FT_DONE))
    got = _both(_chunked(wire, 1))
    frames = [f for fed in got[1] for f in fed]
    assert [f[0] for f in frames] == [FT_HELLO, FT_UPDATE, FT_DONE]
    assert frames[1][2] == b"u" * 257 and got[2] == len(wire)


def test_take_buffer_hands_off_partial_tail_like_reference():
    f1 = pack_frame(FT_HELLO, meta={"client_id": 3})
    f2 = pack_frame(FT_UPDATE, b"y" * 128, {"weight": 1.0})
    cut = len(f2) // 2
    seen = []
    for mod in (pt, jt):
        dec = mod.FrameDecoder()
        frames = dec.feed(f1 + f2[:cut])
        tail = dec.take_buffer()
        state = (_frames(frames), tail, dec.pending_bytes, dec.bytes_in)
        dec.close()
        session = mod.FrameDecoder()
        got = session.feed(tail) + session.feed(f2[cut:])
        seen.append((state, _frames(got), session.bytes_in))
    assert seen[0] == seen[1]
    (frames, tail, pending, bytes_in), got, session_in = seen[0]
    assert [f[0] for f in frames] == [FT_HELLO] and tail == f2[:cut] and pending == 0
    assert bytes_in == len(f1) + cut and session_in == len(f2)
    assert got[0][2] == b"y" * 128


def test_taxonomy_is_rooted_at_transport_error():
    for exc in (FrameError, TornConnectionError, TransportTimeout, ProtocolError,
                RetryExhausted):
        assert issubclass(exc, TransportError)
        ref = getattr(jt, exc.__name__)
        assert [c.__name__ for c in exc.__mro__] == [c.__name__ for c in ref.__mro__]
    assert issubclass(TransportTimeout, TimeoutError)
    assert issubclass(TransportError, ConnectionError)
    assert RetryExhausted("x", attempts=4).attempts == 4


POLICIES = [
    dict(base_backoff_s=0.1, backoff_factor=2.0, max_backoff_s=0.5, jitter_frac=0.0),
    dict(base_backoff_s=0.1, backoff_factor=2.0, max_backoff_s=10.0, jitter_frac=0.25),
    dict(),                               # the socket round's default policy
    dict(base_backoff_s=0.01, backoff_factor=1.0, max_backoff_s=1.0, jitter_frac=0.5),
]


@pytest.mark.parametrize("kw", POLICIES)
def test_backoff_sequence_matches_reference(kw):
    """The backoff sequence under the clients' seeded jitter rng (key
    [seed, cid, 0xB0FF]) is the reference's, float for float."""
    p, r = RetryPolicy(**kw), jt.RetryPolicy(**kw)
    assert [p.backoff_s(i) for i in range(8)] == [r.backoff_s(i) for i in range(8)]
    for seed, cid in ((7, 0), (7, 5), (19, 3)):
        rp = np.random.default_rng([seed, cid, 0xB0FF])
        rr = np.random.default_rng([seed, cid, 0xB0FF])
        assert [p.backoff_s(i, rp) for i in range(8)] == [r.backoff_s(i, rr) for i in range(8)]
    if kw.get("jitter_frac", 0.1) == 0.0:
        assert [p.backoff_s(i) for i in range(4)] == [0.1, 0.2, 0.4, 0.5]


def test_retry_policy_validation_like_reference():
    for bad, match in ((dict(max_attempts=0), "max_attempts"),
                       (dict(backoff_factor=0.5), "backoff_factor")):
        for mod in (pt, jt):
            with pytest.raises(ValueError, match=match):
                mod.RetryPolicy(**bad)


def _retry_trace(mod, fail_until, fatal=False, max_attempts=5):
    calls, slept = [], []

    class Rejected(Exception):
        pass

    def fn(attempt):
        calls.append(attempt)
        if fatal:
            raise Rejected("unsupported proto")
        if attempt < fail_until:
            raise mod.TornConnectionError(f"dead on attempt {attempt}")
        return "landed"

    try:
        out = mod.call_with_retries(fn, mod.RetryPolicy(max_attempts=max_attempts),
                                    np.random.default_rng([7, 2, 0xB0FF]),
                                    fatal=(Rejected,), sleep=slept.append)
    except Exception as e:  # noqa: BLE001 — the error IS the outcome
        cause = e.__cause__
        out = (type(e).__name__, str(e), getattr(e, "attempts", None),
               None if cause is None else (type(cause).__name__, str(cause)))
    return out, calls, slept


@pytest.mark.parametrize("fail_until,fatal", [(0, False), (2, False), (4, False), (9, False),
                                              (0, True)])
def test_call_with_retries_trace_matches_reference(fail_until, fatal):
    """Attempts, backoff sleeps, the result or the error (with its chained
    cause) equal the reference's: success after transient failures, a
    fatal error never retried into, and exhaustion."""
    got = _retry_trace(pt, fail_until, fatal)
    assert got == _retry_trace(jt, fail_until, fatal)
    out, calls, slept = got
    if fatal:
        assert calls == [0]
    elif fail_until >= 5:
        assert out[0] == "RetryExhausted" and out[2] == 5
        assert out[3] == ("TornConnectionError", "dead on attempt 4") and len(slept) == 4
    else:
        assert out == "landed" and calls == list(range(fail_until + 1))
        assert len(slept) == fail_until


# --------------------------------------------------------------------------
# Real loopback sockets.
# --------------------------------------------------------------------------


def test_recv_frame_restores_prior_socket_timeout():
    a, b = socket.socketpair()
    try:
        b.settimeout(123.0)
        a.sendall(pack_frame(FT_DONE))
        assert recv_frame(b, timeout_s=5.0).ftype == FT_DONE
        assert b.gettimeout() == 123.0
        with pytest.raises(TransportTimeout):
            recv_frame(b, timeout_s=0.1)
        assert b.gettimeout() == 123.0
    finally:
        a.close()
        b.close()


def _listener():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    return srv, srv.getsockname()[1]


def test_loopback_slow_sender_byte_at_a_time():
    frame = pack_frame(FT_UPDATE, b"s" * 96, {"client_id": 9, "weight": 1.0})
    srv, port = _listener()

    def client():
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            for i in range(len(frame)):
                s.sendall(frame[i:i + 1])
                if i % 16 == 0:
                    time.sleep(0.001)

    t = threading.Thread(target=client)
    t.start()
    conn, _ = srv.accept()
    try:
        got = recv_frame(conn, timeout_s=30)
    finally:
        t.join(timeout=10)
        conn.close()
        srv.close()
    assert (got.ftype, got.payload, got.meta["client_id"]) == (FT_UPDATE, b"s" * 96, 9)


@pytest.mark.parametrize("sender,receiver", [("port", "port"), ("port", "ref"),
                                             ("ref", "port")])
def test_loopback_roundtrip_with_byte_metering_across_packages(sender, receiver):
    """HELLO + UPDATE + DONE over real TCP, sent by one package and read by
    the other: the receiver's bytes_in equals the sender's summed
    send_frame returns, and the payload decodes with its CRC verified."""
    snd = pt if sender == "port" else jt
    rcv = pt if receiver == "port" else jt
    blob = _update_blob(3)
    srv, port = _listener()
    sent = {}

    def client():
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            n = snd.send_frame(s, FT_HELLO, meta={"client_id": 4})
            n += snd.send_frame(s, FT_UPDATE, blob, {"client_id": 4, "weight": 2.0})
            n += snd.send_frame(s, FT_DONE)
            sent["n"] = n

    t = threading.Thread(target=client)
    t.start()
    conn, _ = srv.accept()
    conn.settimeout(10)
    dec = rcv.FrameDecoder()
    hello, update, done = (rcv.recv_frame(conn, dec) for _ in range(3))
    t.join(timeout=10)
    conn.close()
    srv.close()
    assert hello.ftype == FT_HELLO and hello.meta["client_id"] == 4
    assert update.ftype == FT_UPDATE and update.meta["weight"] == 2.0
    assert done.ftype == FT_DONE and update.payload == blob
    decode_update(update.payload)
    assert dec.bytes_in == sent["n"]


def test_loopback_peer_disconnect_mid_frame():
    frame = pack_frame(FT_BCAST, b"q" * 4096)
    srv, port = _listener()

    def client():
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall(frame[: len(frame) // 2])
        s.close()

    t = threading.Thread(target=client)
    t.start()
    conn, _ = srv.accept()
    with pytest.raises(TransportError):
        recv_frame(conn, timeout_s=10)
    t.join(timeout=10)
    conn.close()
    srv.close()
