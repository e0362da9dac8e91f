"""Cross-process federation over real TCP sockets, fault-tolerant (port of
``repro.fed.mp_server``; frames, fault streams and ledgers equal the
reference's).

``run_socket_round`` puts the long-lived streaming ``Aggregator`` behind a
CONCURRENT (threaded accept + per-connection handler) server on a loopback
socket and spawns N client OS processes (``multiprocessing`` spawn
context: each child is a fresh interpreter that imports torch and this
package only). The server's aggregator and every client encode run on one
``device``, ``cuda`` unless the caller asks for the CPU: each client
process opens its own CUDA context and encodes its upload with one
``quantize_pack`` launch; the server folds with the ``aggregate`` kernel
(rule "mean") or the ``vote`` kernel (rule "majority"). A child that
cannot reach its device exits non-zero and is booked ``crashed``; it never
encodes elsewhere.

The conversation (HELLO protocol v2)::

  client                             server
    HELLO {client_id, proto, nonce,
           attempt[, resume]}  ───►
                               ◄───  BCAST (global model wire buffer)
                                     · or RESUME {have} when this nonce
                                       already shipped `have` bytes of its
                                       UPDATE frame (a reconnect resumes
                                       the upload instead of re-sending)
                                     · or DONE when the update already
                                       landed (an idempotent HELLO)
                                     · or ERR {error} (unsupported proto →
                                       outcome "rejected")
    UPDATE frame bytes[have:]  ───►
                               ◄───  DONE

A v1 HELLO (no ``proto`` key) speaks the original one-shot conversation;
the server negotiates down and never sends RESUME.

Fault tolerance: clients reconnect with exponential backoff and seeded
jitter (``transport.RetryPolicy``) and RESUME mid-frame (the server keeps
a per-(client, nonce) session whose ``FrameDecoder`` holds the partial
UPDATE across connections); the round commits under a QUORUM once
``quorum_frac`` of clients land and the deadline passes (or every live
client lands), stragglers booked as dropped bytes; crashed children are
detected by exit code; unjoinable children escalate ``terminate()`` →
``kill()``. Every client ends with an outcome in ``ok | timeout | torn |
crashed | rejected | quarantined``, and the update-byte ledger balances:
shipped == ingested + dropped + quarantined (``ledger()``). With
``defense=DefenseConfig(enabled=True)`` each landed update passes the
content gate (``fed.defense.UpdateGate``) first; a refused one is
``quarantined``, acked with DONE, and never reaches the aggregator.

Mixing: mode "sync" replays the arrivals into the ``Aggregator`` in
client-id order at commit, the order ``run_inprocess_reference`` uses, so
the root aggregate is byte-identical to it over the surviving set. Mode
"buffered" folds every ``buffer_k`` arrivals into the global model
(``fed.async_server._weighted_mix``) WHILE other clients upload, in true
arrival order; the reference replays ``result.arrivals``. With
``fault_cfg`` a ``comm.faults.ChaosProxy`` sits in-path, keyed by
``(fault seed, client_id, attempt)`` at absolute byte offsets, so the
surviving set and the aggregate are pure functions of the seeds.

Bytes are metered from socket traffic: upload bytes from every ``recv()``
the server issued, download bytes from ``send_frame`` returns. With
``report_dir`` each client process writes ``client-<id>.json`` as it exits
(its device, the first HELLO's time and its kernel launch counts), which
puts no byte on the socket.

CLI::

    PYTHONPATH=src python -m repro_torch.fed.mp_server --clients 8 --check
    PYTHONPATH=src python -m repro_torch.fed.mp_server --clients 6 --chaos --check --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import multiprocessing as mp
import os
import socket
import sys
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.comm.faults import ChaosProxy, FaultConfig
from repro_torch.comm.transport import (
    FT_BCAST, FT_DONE, FT_ERR, FT_HELLO, FT_RESUME, FT_UPDATE, PROTO_V1, PROTO_VERSION,
    RECV_CHUNK, SUPPORTED_PROTOS, Frame, FrameDecoder, FrameError, ProtocolError,
    RetryExhausted, RetryPolicy, TornConnectionError, TransportError, call_with_retries,
    pack_frame, recv_frame, send_frame,
)
from repro_torch.comm.wire import decode_update, encode_update
from repro_torch.core.compression import CodecSpec, compress_pytree
from repro_torch.device import resolve_device
from repro_torch.dtypes import to_numpy
from repro_torch.fed.aggregator import Aggregator
from repro_torch.fed.attackers import AttackConfig, attacker_ids, poison_blob
from repro_torch.fed.defense import DefenseConfig, UpdateGate
from repro_torch.kernels import launch_counts
from repro_torch.tree import tree_leaves, tree_map

Pytree = Any

DEFAULT_TIMEOUT_S = 600.0   # single-core CI: N children serialize their imports

# child exit codes — the server's process watcher maps them onto outcomes
EXIT_OK = 0
EXIT_RETRY_EXHAUSTED = 3    # outcome "torn": the link never let it finish
EXIT_REJECTED = 4           # outcome "rejected": server refused the protocol
EXIT_CRASH = 40             # outcome "crashed": injected mid-upload crash

OUTCOMES = ("ok", "timeout", "torn", "crashed", "rejected", "quarantined")


class QuorumNotMetError(RuntimeError):
    """The round deadline passed (or every live client resolved) with fewer
    than ``quorum_frac · n_clients`` updates landed."""


# --------------------------------------------------------------------------
# The deterministic client program (shared by subprocess and reference).
# --------------------------------------------------------------------------


def demo_params(seed: int = 0, d: int = 48, depth: int = 2,
                n_out: int = 10) -> Pytree:
    """A small dense tree (CPU tensors) with both quantizable (2-D w) and
    residual (1-D b) leaves, drawn as the reference draws it."""
    rng = np.random.default_rng(seed)
    tree = {}
    for i in range(depth):
        tree[f"layer{i}"] = {
            "w": torch.from_numpy(0.1 * rng.normal(size=(d, d)).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(d,)).astype(np.float32)),
        }
    tree["head"] = {
        "w": torch.from_numpy(0.1 * rng.normal(size=(d, n_out)).astype(np.float32)),
        "b": torch.from_numpy(rng.normal(size=(n_out,)).astype(np.float32)),
    }
    return tree


def client_weight(client_id: int) -> float:
    """Deterministic per-client sample count (|D_k|) for the demo clients."""
    return float(40 + 7 * (client_id % 5))


def client_update_blob(start_params: Pytree, client_id: int, seed: int, *,
                       fused_encode: bool = True,
                       device: str | torch.device = "cuda") -> bytes:
    """One client's egress, as a pure function of its inputs: perturb the
    decoded broadcast with a (seed, client_id)-keyed numpy rng, compress on
    ``device`` (ternary with fp16 residuals, the fused quantize→pack
    encode: one ``quantize_pack`` launch on the card) and serialize."""
    dev = resolve_device(device)
    rng = np.random.default_rng([int(seed), int(client_id)])
    new = []
    for leaf in tree_leaves(start_params):
        host = to_numpy(leaf).astype(np.float32, copy=False)
        noise = rng.normal(scale=0.05, size=host.shape).astype(np.float32)
        new.append(torch.from_numpy(np.asarray(host + noise)).to(dev))
    it = iter(new)
    tree = tree_map(lambda _: next(it), start_params)
    wire_tree, _ = compress_pytree(
        tree, CodecSpec(kind="ternary", residual="fp16", fused_encode=fused_encode))
    return encode_update(wire_tree)


def params_hash(tree: Pytree) -> str:
    """Canonical digest of a dense tree: sha256 over its wire encoding."""
    return hashlib.sha256(encode_update(tree)).hexdigest()


def client_nonce(seed: int, client_id: int) -> str:
    """The per-process upload identity: deterministic (tests replay it),
    unique per (seed, client) — a reconnect with the same nonce may resume,
    a different nonce voids the old session."""
    rng = np.random.default_rng([int(seed), int(client_id), 0xA0CE])
    return bytes(rng.integers(0, 256, size=8, dtype=np.uint8)).hex()


class _Rejected(Exception):
    """Client-side: the server refused us outright — do not retry."""


def _write_report(report_dir: str | None, report: dict) -> None:
    """The client's exit report: its device, first-HELLO time and kernel
    launch counts, written atomically beside the socket traffic."""
    if report_dir is None:
        return
    report = dict(report, launches=launch_counts(), exit_at=time.time())
    path = os.path.join(report_dir, f"client-{report['client_id']}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(report, f)
    os.replace(path + ".tmp", path)


def _client_main(host: str, port: int, client_id: int, seed: int,
                 timeout_s: float, policy: RetryPolicy | None = None,
                 crash_after_frac: float | None = None,
                 proto: int = PROTO_VERSION,
                 attack: AttackConfig | None = None,
                 device: str = "cuda", report_dir: str | None = None) -> None:
    """Subprocess entry point: one client's whole (retrying) conversation.

    Reconnects with exponential backoff + seeded jitter on any transport
    failure; on reconnect the HELLO carries the same nonce so the server
    can offer a RESUME offset, and the client ships only the un-received
    tail of its UPDATE frame. ``proto=1`` speaks the legacy one-shot
    conversation (no resume). ``crash_after_frac`` simulates a device
    dying mid-upload: send that fraction of the remaining body, then
    hard-exit. The update is encoded on ``device``; a device that is not
    there raises before any byte is sent."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    report = {"client_id": int(client_id), "device": dev.type, "hello_at": None}
    try:
        if proto == PROTO_V1:
            _client_main_v1(host, port, client_id, seed, timeout_s, dev, report)
            return
        _client_main_v2(host, port, client_id, seed, timeout_s, policy,
                        crash_after_frac, proto, attack, dev, report, report_dir)
    finally:
        _write_report(report_dir, report)


def _client_main_v2(host, port, client_id, seed, timeout_s, policy,
                    crash_after_frac, proto, attack, dev, report, report_dir) -> None:
    policy = policy or RetryPolicy(io_timeout_s=timeout_s)
    nonce = client_nonce(seed, client_id)
    backoff_rng = np.random.default_rng([int(seed), int(client_id), 0xB0FF])
    state: dict[str, Any] = {"frame": None}

    def attempt(k: int) -> None:
        with socket.create_connection(
            (host, port), timeout=policy.connect_timeout_s
        ) as s:
            s.settimeout(timeout_s)
            dec = FrameDecoder()
            meta = {"client_id": int(client_id), "proto": int(proto),
                    "nonce": nonce, "attempt": int(k)}
            if state["frame"] is not None:
                meta["resume"] = True
            if report["hello_at"] is None:
                report["hello_at"] = time.time()
            send_frame(s, FT_HELLO, meta=meta)
            reply = recv_frame(s, dec, timeout_s=timeout_s)
            if reply.ftype == FT_ERR:
                raise _Rejected(reply.meta.get("error", "rejected"))
            if reply.ftype == FT_DONE:
                return          # idempotent HELLO: the server already has it
            if reply.ftype == FT_RESUME:
                have = int(reply.meta["have"])
                if state["frame"] is None or have > len(state["frame"]):
                    raise ProtocolError(f"un-resumable offset {have}")
            elif reply.ftype == FT_BCAST:
                start = decode_update(reply.payload)   # CRC re-verified here
                blob = client_update_blob(start, client_id, seed, device=dev)
                if attack is not None:
                    # a Byzantine demo client: poison the honest payload
                    # client-side (still framed/CRC'd normally — wire-valid)
                    blob = poison_blob(blob, attack, client_id)
                state["frame"] = pack_frame(FT_UPDATE, blob, {
                    "client_id": int(client_id),
                    "weight": client_weight(client_id),
                })
                have = 0
            else:
                raise ProtocolError(f"unexpected reply frame {reply.ftype}")
            body = state["frame"][have:]
            if crash_after_frac is not None:
                s.sendall(body[: int(len(body) * float(crash_after_frac))])
                _write_report(report_dir, report)
                os._exit(EXIT_CRASH)     # the injected device death
            s.sendall(body)
            done = recv_frame(s, dec, timeout_s=timeout_s)
            if done.ftype != FT_DONE:
                raise ProtocolError(
                    f"expected DONE, got frame type {done.ftype}")

    try:
        call_with_retries(attempt, policy, rng=backoff_rng, fatal=(_Rejected,))
    except _Rejected:
        sys.exit(EXIT_REJECTED)
    except RetryExhausted:
        sys.exit(EXIT_RETRY_EXHAUSTED)


def _client_main_v1(host: str, port: int, client_id: int, seed: int,
                    timeout_s: float, dev: torch.device, report: dict) -> None:
    """The protocol-1 client: HELLO {client_id} → BCAST → UPDATE → DONE, no
    retry, no resume. Kept runnable to prove version negotiation."""
    with socket.create_connection((host, port), timeout=timeout_s) as s:
        dec = FrameDecoder()
        report["hello_at"] = time.time()
        send_frame(s, FT_HELLO, meta={"client_id": int(client_id)})
        bcast = recv_frame(s, dec, timeout_s=timeout_s)
        if bcast.ftype != FT_BCAST:
            send_frame(s, FT_ERR,
                       meta={"error": f"expected BCAST, got {bcast.ftype}"})
            return
        start = decode_update(bcast.payload)
        blob = client_update_blob(start, client_id, seed, device=dev)
        send_frame(s, FT_UPDATE, blob, meta={
            "client_id": int(client_id),
            "weight": client_weight(client_id),
        })
        done = recv_frame(s, dec, timeout_s=timeout_s)
        if done.ftype != FT_DONE:
            raise TransportError(f"expected DONE, got frame type {done.ftype}")


# --------------------------------------------------------------------------
# Mixing (shared by the socket server and the in-process reference).
# --------------------------------------------------------------------------


def _buffered_mix(global_params: Pytree, batch, eta: float, agg: Aggregator) -> Pytree:
    """One buffered mix: stream the (weight, blob) batch into the
    long-lived ``agg``, then θ ← (1-η)·θ + η·mean (``finalize(reset=True)``
    inside ``_weighted_mix``, which folds only what ``agg`` holds)."""
    from repro_torch.fed.async_server import _weighted_mix  # lazy: heavy deps

    for weight, blob in batch:
        agg.add(blob, weight=weight)
    return _weighted_mix(global_params, list(batch), eta, agg, agg.device)


def _mix_arrivals(global_params: Pytree, arrivals, mode: str, *,
                  chunk_c: int, buffer_k: int, eta: float,
                  rule: str = "mean", trim_frac: float = 0.2,
                  device: str | torch.device = "cuda") -> Pytree:
    """Fold (client_id, weight, blob) arrivals — ALREADY in the order they
    should be consumed — through the existing mix logic on ``device``."""
    agg = Aggregator(chunk_c=chunk_c, device=device, rule=rule, trim_frac=trim_frac)
    if mode == "sync":
        for _cid, weight, blob in arrivals:
            agg.add(blob, weight=weight)
        return agg.finalize()
    if mode == "buffered":
        out = _on_device(global_params, agg.device)
        pending = []
        for _cid, weight, blob in arrivals:
            pending.append((weight, blob))
            if len(pending) >= buffer_k:
                out = _buffered_mix(out, pending, eta, agg)
                pending = []
        if pending:
            out = _buffered_mix(out, pending, eta, agg)
        return out
    raise ValueError(f"unknown mode {mode!r} (sync | buffered)")


def _on_device(tree: Pytree, dev: torch.device) -> Pytree:
    return tree_map(lambda x: torch.as_tensor(x).to(dev), tree)


def run_inprocess_reference(
    global_params: Pytree, n_clients: int, *, seed: int = 0,
    mode: str = "sync", chunk_c: int = 16, buffer_k: int = 4,
    eta: float = 0.5, order: list[int] | None = None,
    rule: str = "mean", trim_frac: float = 0.2,
    device: str | torch.device = "cuda",
) -> Pytree:
    """The no-sockets reference: identical broadcast decode, identical
    per-client update derivation, identical mix, on ``device`` — in
    ``order`` (default client_id order, which is what the socket sync
    barrier replays). Under a quorum commit pass the SURVIVING client ids:
    sorted for sync, ``result.arrivals`` for buffered. Under a defense
    round pass the HONEST survivors and the same ``rule``."""
    dev = resolve_device(device)
    blob = encode_update(global_params)
    start = decode_update(blob)                 # decode exactly like a client
    ids = list(range(n_clients)) if order is None else list(order)
    arrivals = [
        (cid, client_weight(cid), client_update_blob(start, cid, seed, device=dev))
        for cid in ids
    ]
    return _mix_arrivals(global_params, arrivals, mode,
                         chunk_c=chunk_c, buffer_k=buffer_k, eta=eta,
                         rule=rule, trim_frac=trim_frac, device=dev)


# --------------------------------------------------------------------------
# The concurrent socket server.
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _Session:
    """One client's resumable upload: survives connections, owned by the
    NEWEST connection (``generation`` fences superseded handlers)."""

    cid: int
    nonce: str
    dec: FrameDecoder = dataclasses.field(default_factory=FrameDecoder)
    generation: int = 0
    attempts: int = 0
    completed: bool = False
    frame_bytes: int = 0        # nbytes_framed once completed


class _RoundState:
    """Everything the handler threads and the round loop share."""

    def __init__(self):
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.sessions: dict[int, _Session] = {}
        self.completed: list[tuple[int, float, bytes]] = []  # arrival order
        self.completed_ids: set[int] = set()
        self.rejected: dict[int, str] = {}
        self.quarantined: dict[int, tuple[str, int]] = {}  # cid → (reason, B)
        self.quarantined_update_bytes = 0
        self.gate: UpdateGate | None = None   # set when defense is enabled
        self.closing = False
        self.up_bytes = 0
        self.down_bytes = 0
        self.payload_bytes = 0
        self.ingested_update_bytes = 0
        self.dropped_update_bytes = 0
        self.v1_update_bytes = 0        # v1 frames never live in a session
        self.superseded_bytes = 0       # voided sessions (nonce changed)
        self.resumed_bytes = 0
        self.retries = 0
        self.errors: list[str] = []       # handler-side failures (debugging)

    def note_error(self, msg: str) -> None:
        with self.lock:
            if len(self.errors) < 64:
                self.errors.append(msg)


def _book_completed(state: _RoundState, cid: int, weight: float,
                    payload: bytes, frame_bytes: int) -> bool:
    """Record one landed update — through the content gate when defense is
    on. True iff NEWLY booked, as completed OR quarantined (idempotent: a
    duplicate or post-commit arrival books nothing and returns False). A
    quarantined client is still acked with DONE — its upload is over; the
    poison just never reaches the aggregate."""
    with state.cond:
        if (cid in state.completed_ids or cid in state.quarantined
                or state.closing):
            return False
        if state.gate is not None:
            verdict = state.gate.check(payload)
            if not verdict.ok:
                state.quarantined[cid] = (verdict.reason, frame_bytes)
                state.quarantined_update_bytes += frame_bytes
                state.cond.notify_all()
                return True
        state.completed_ids.add(cid)
        state.completed.append((cid, weight, payload))
        state.payload_bytes += len(payload)
        state.ingested_update_bytes += frame_bytes
        state.cond.notify_all()
    return True


def _poll_frame(conn: socket.socket, dec: FrameDecoder, state: _RoundState,
                timeout_s: float) -> Frame | None:
    """Receive one frame with SHORT socket polls so handler threads notice
    the round committing — a client that never speaks must not pin a
    handler (and a 5s commit join) for the full conversation timeout.
    Returns None when the round closed underneath the wait."""
    deadline = time.monotonic() + timeout_s
    conn.settimeout(0.25)
    while True:
        frame = dec.pop()
        if frame is not None:
            return frame
        with state.lock:
            if state.closing:
                return None
        if time.monotonic() > deadline:
            raise TornConnectionError(f"no frame within {timeout_s}s")
        try:
            chunk = conn.recv(RECV_CHUNK)
        except socket.timeout:
            continue
        except OSError as e:
            raise TornConnectionError(f"connection lost: {e}") from e
        if not chunk:
            dec.close()      # raises TornConnectionError on a partial frame
            raise TornConnectionError("connection closed before a frame")
        dec.feed(chunk)


def _validate_update(frame: Frame, cid: int) -> float:
    if frame.ftype == FT_ERR:
        raise ProtocolError(f"client {cid} error: {frame.meta.get('error')}")
    if frame.ftype != FT_UPDATE:
        raise ProtocolError(
            f"client {cid}: expected UPDATE, got {frame.ftype}")
    if int(frame.meta.get("client_id", -1)) != cid:
        raise ProtocolError(f"client id changed mid-conversation for {cid}")
    # a missing / non-numeric / non-finite / negative weight would crash the
    # handler (KeyError) or poison the aggregate denominator — it is a
    # malformed frame, and FrameError maps it onto the "rejected" outcome.
    weight = frame.meta.get("weight")
    try:
        weight = float(weight)
    except (TypeError, ValueError):
        raise FrameError(
            f"client {cid}: UPDATE weight meta missing or non-numeric: "
            f"{frame.meta.get('weight')!r}") from None
    if not math.isfinite(weight) or weight < 0:
        raise FrameError(
            f"client {cid}: UPDATE weight must be finite and >= 0, "
            f"got {weight!r}")
    return weight


def _serve_v2(conn: socket.socket, hello: Frame, hello_dec: FrameDecoder,
              state: _RoundState, bcast_blob: bytes, timeout_s: float) -> None:
    """One v2 connection: session claim → BCAST/RESUME/DONE → stream the
    UPDATE frame into the session's long-lived decoder → DONE. On any
    failure the session (and its partial bytes) survives for the next
    reconnect; only the handler dies."""
    cid = int(hello.meta["client_id"])
    nonce = str(hello.meta.get("nonce", ""))
    attempt = int(hello.meta.get("attempt", 0))
    deadline = time.monotonic() + timeout_s
    with state.cond:
        if attempt > 0:
            state.retries += 1
        if cid in state.completed_ids or cid in state.quarantined:
            sess = None                       # already landed: just ack
        else:
            sess = state.sessions.get(cid)
            if sess is None or sess.nonce != nonce:
                if sess is not None:          # a new upload voids the old
                    state.dropped_update_bytes += sess.dec.bytes_in
                    state.superseded_bytes += sess.dec.bytes_in
                sess = _Session(cid=cid, nonce=nonce)
                state.sessions[cid] = sess
            sess.generation += 1
            sess.attempts += 1
            gen = sess.generation
    if sess is None:
        with state.lock:
            state.down_bytes += send_frame(conn, FT_DONE,
                                           meta={"proto": PROTO_VERSION})
        return
    # over-read past the HELLO belongs to the UPDATE stream (already counted
    # in up_bytes via hello_dec — do not re-count, but DO re-offset)
    leftover = hello_dec.take_buffer()
    have = sess.dec.bytes_in
    if hello.meta.get("resume") and not sess.completed:
        reply = pack_frame(FT_RESUME, meta={"have": have,
                                            "proto": PROTO_VERSION})
        with state.lock:
            state.resumed_bytes += have
    else:
        reply = pack_frame(FT_BCAST, bcast_blob, meta={"proto": PROTO_VERSION})
    conn.sendall(reply)
    with state.lock:
        state.down_bytes += len(reply)
    frame: Frame | None = None
    if leftover:
        frames = sess.dec.feed(leftover)
        frame = frames[0] if frames else None
    conn.settimeout(0.25)      # short poll: handlers must notice closing
    while frame is None:
        with state.lock:
            superseded = sess.generation != gen
            closing = state.closing
        if superseded or closing:
            return             # the reconnect (or the commit) owns it now
        if time.monotonic() > deadline:
            raise TornConnectionError(f"client {cid}: conversation timed out")
        try:
            chunk = conn.recv(RECV_CHUNK)
        except socket.timeout:
            continue
        except OSError as e:
            raise TornConnectionError(f"client {cid}: {e}") from e
        if not chunk:
            raise TornConnectionError(
                f"client {cid}: closed with {sess.dec.pending_bytes} bytes "
                "of its update pending")
        with state.lock:
            state.up_bytes += len(chunk)
        frames = sess.dec.feed(chunk)      # FrameError on garbage → rejected
        frame = frames[0] if frames else None
    weight = _validate_update(frame, cid)
    with state.lock:
        sess.completed = True
        sess.frame_bytes = frame.nbytes_framed
    _book_completed(state, cid, weight, frame.payload, frame.nbytes_framed)
    with state.lock:
        state.down_bytes += send_frame(conn, FT_DONE,
                                       meta={"proto": PROTO_VERSION})


def _serve_v1(conn: socket.socket, hello: Frame, hello_dec: FrameDecoder,
              state: _RoundState, bcast_blob: bytes, timeout_s: float) -> None:
    """The protocol-1 conversation for legacy clients: one shot, no session."""
    cid = int(hello.meta["client_id"])
    with state.lock:
        state.down_bytes += send_frame(conn, FT_BCAST, bcast_blob)
    update = _poll_frame(conn, hello_dec, state, timeout_s)
    if update is None:      # round closed while waiting
        return
    weight = _validate_update(update, cid)
    if not _book_completed(state, cid, weight, update.payload,
                           update.nbytes_framed):
        raise ProtocolError(f"duplicate client_id {cid}")
    with state.lock:
        state.v1_update_bytes += update.nbytes_framed
        state.down_bytes += send_frame(conn, FT_DONE)


def _serve_connection(conn: socket.socket, state: _RoundState,
                      bcast_blob: bytes, timeout_s: float) -> None:
    """Handler-thread body: dispatch one accepted connection by protocol
    version; book rejections; never let an exception escape the thread."""
    hello_dec = FrameDecoder()
    cid = -1
    try:
        try:
            hello = _poll_frame(conn, hello_dec, state, timeout_s)
            if hello is None:   # round closed before the client spoke
                return
            if hello.ftype == FT_ERR:
                raise ProtocolError(
                    f"client error: {hello.meta.get('error')}")
            if hello.ftype != FT_HELLO or "client_id" not in hello.meta:
                raise ProtocolError(
                    f"expected HELLO with client_id, got {hello.ftype}")
            cid = int(hello.meta["client_id"])
            proto = int(hello.meta.get("proto", PROTO_V1))
            if proto not in SUPPORTED_PROTOS:
                err = pack_frame(FT_ERR, meta={
                    "error": f"unsupported proto {proto}",
                    "supported": sorted(SUPPORTED_PROTOS),
                })
                conn.sendall(err)
                with state.cond:
                    state.rejected[cid] = f"unsupported proto {proto}"
                    state.down_bytes += len(err)
                    state.cond.notify_all()
                return
            if proto == PROTO_V1:
                _serve_v1(conn, hello, hello_dec, state, bcast_blob,
                          timeout_s)
            else:
                _serve_v2(conn, hello, hello_dec, state, bcast_blob,
                          timeout_s)
        finally:
            with state.lock:
                state.up_bytes += hello_dec.bytes_in - hello_dec.pending_bytes
    except FrameError as e:
        # garbage on the wire is a rejection, not a retryable tear
        with state.cond:
            if cid >= 0:
                state.rejected[cid] = str(e)
            state.cond.notify_all()
        state.note_error(f"frame error (cid {cid}): {e}")
    except (TransportError, OSError) as e:
        state.note_error(f"torn (cid {cid}): {e}")   # session retained
    finally:
        try:
            conn.close()
        except OSError:
            pass


def _accept_loop(srv: socket.socket, state: _RoundState, bcast_blob: bytes,
                 timeout_s: float, handlers: list[threading.Thread]) -> None:
    while True:
        with state.lock:
            if state.closing:
                return
        try:
            conn, _addr = srv.accept()
        except socket.timeout:
            continue
        except OSError:
            return              # listener closed at commit
        t = threading.Thread(
            target=_serve_connection,
            args=(conn, state, bcast_blob, timeout_s),
            daemon=True,
        )
        t.start()
        handlers.append(t)


def reap_processes(procs: list, grace_s: float = 5.0) -> dict:
    """join → terminate → kill escalation for child processes.

    Every child gets ``grace_s`` (shared) to exit on its own; survivors are
    ``terminate()``d (SIGTERM), given another grace, then ``kill()``ed
    (SIGKILL — unmaskable) so a client wedged in an uninterruptible recv
    can NEVER outlive the round. Returns the escalation tally."""
    esc = {"terminated": 0, "killed": 0}
    end = time.monotonic() + grace_s
    for p in procs:
        p.join(timeout=max(0.0, end - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.terminate()
            esc["terminated"] += 1
    if esc["terminated"]:
        end = time.monotonic() + grace_s
        for p in procs:
            if p.is_alive():
                p.join(timeout=max(0.0, end - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                esc["killed"] += 1
                p.join(timeout=grace_s)
    return esc


@dataclasses.dataclass
class SocketRoundResult:
    params: Pytree              # the post-round global model (dense)
    n_clients: int
    arrivals: list[int]         # surviving client ids in true arrival order
    upload_bytes: int           # Σ server recv() bytes — actual socket reads
    download_bytes: int         # Σ send_frame returns — actual socket writes
    payload_bytes: int          # Σ len(ingested update wire buffers)
    wall_s: float
    mode: str
    # fault-tolerance surface (defaults = the no-fault shape)
    outcomes: dict[int, str] = dataclasses.field(default_factory=dict)
    committed: str = "full"     # "full" | "quorum"
    quorum_frac: float = 1.0
    quorum_n: int = 0
    shipped_update_bytes: int = 0   # every UPDATE-frame byte that arrived
    ingested_update_bytes: int = 0  # ... folded into the aggregate
    dropped_update_bytes: int = 0   # ... paid for but never folded
    quarantined_update_bytes: int = 0  # ... refused by the content gate
    resumed_bytes: int = 0      # upload bytes SAVED by mid-frame resume
    retries: int = 0            # reconnect attempts observed (attempt > 0)
    escalations: dict = dataclasses.field(
        default_factory=lambda: {"terminated": 0, "killed": 0})
    chaos: dict | None = None   # ChaosProxy.stats when a fault_cfg ran
    defense: dict | None = None  # UpdateGate.telemetry() when defense ran
    # with report_dir: client id → its exit report, plus "startup_s" (spawn
    # to first HELLO)
    client_reports: dict = dataclasses.field(default_factory=dict)
    # the server's arrivals as (client_id, weight, wire blob), arrival order
    received: list = dataclasses.field(default_factory=list, repr=False)

    @property
    def framing_overhead_bytes(self) -> int:
        """Upload bytes that were transport framing, not wire payload."""
        return self.upload_bytes - self.payload_bytes

    @property
    def n_survivors(self) -> int:
        return len(self.arrivals)

    def ledger(self) -> dict:
        """The round's byte/outcome ledger. The update-byte balance
        invariant — shipped == ingested + dropped + quarantined — is
        checked here; a ``False`` means the server lost track of bytes it
        read."""
        balance_ok = (self.shipped_update_bytes
                      == self.ingested_update_bytes
                      + self.dropped_update_bytes
                      + self.quarantined_update_bytes)
        return {
            "mode": self.mode,
            "n_clients": self.n_clients,
            "n_survivors": self.n_survivors,
            "arrivals": self.arrivals,
            "outcomes": {str(k): v for k, v in sorted(self.outcomes.items())},
            "committed": self.committed,
            "quorum_frac": self.quorum_frac,
            "quorum_n": self.quorum_n,
            "upload_bytes": self.upload_bytes,
            "download_bytes": self.download_bytes,
            "payload_bytes": self.payload_bytes,
            "framing_overhead_bytes": self.framing_overhead_bytes,
            "shipped_update_bytes": self.shipped_update_bytes,
            "ingested_update_bytes": self.ingested_update_bytes,
            "dropped_update_bytes": self.dropped_update_bytes,
            "quarantined_update_bytes": self.quarantined_update_bytes,
            "balance_ok": balance_ok,
            "defense": self.defense,
            "resumed_bytes": self.resumed_bytes,
            "retries": self.retries,
            "escalations": self.escalations,
            "chaos": self.chaos,
            "wall_s": self.wall_s,
            "params_sha256": params_hash(self.params),
        }


def _final_outcomes(state: _RoundState, procs: dict[int, Any]) -> dict[int, str]:
    """Map every client onto
    ok | timeout | torn | crashed | rejected | quarantined."""
    out: dict[int, str] = {}
    for cid, p in procs.items():
        if cid in state.completed_ids:
            out[cid] = "ok"
        elif cid in state.quarantined:
            out[cid] = "quarantined"
        elif cid in state.rejected:
            out[cid] = "rejected"
        elif p.exitcode == EXIT_REJECTED:
            out[cid] = "rejected"
        elif p.exitcode == EXIT_RETRY_EXHAUSTED:
            out[cid] = "torn"
        elif p.exitcode not in (None, EXIT_OK):
            out[cid] = "crashed"
        else:
            out[cid] = "timeout"    # still running / never landed by commit
    return out


def _read_reports(report_dir: str | None, spawned_at: dict[int, float]) -> dict:
    """Each client's exit report, with its spawn-to-first-HELLO seconds."""
    if report_dir is None:
        return {}
    out = {}
    for cid, t0 in spawned_at.items():
        path = os.path.join(report_dir, f"client-{cid}.json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            rep = json.load(f)
        hello = rep.get("hello_at")
        rep["startup_s"] = None if hello is None else hello - t0
        out[cid] = rep
    return out


def run_socket_round(
    global_params: Pytree, n_clients: int, *, seed: int = 0,
    mode: str = "sync", chunk_c: int = 16, buffer_k: int = 4,
    eta: float = 0.5, host: str = "127.0.0.1",
    timeout_s: float = DEFAULT_TIMEOUT_S, start_method: str = "spawn",
    quorum_frac: float = 1.0, round_deadline_s: float = float("inf"),
    fault_cfg: FaultConfig | None = None, retry: RetryPolicy | None = None,
    legacy_clients: tuple = (), join_grace_s: float = 5.0,
    defense: DefenseConfig | None = None, attack: AttackConfig | None = None,
    device: str | torch.device = "cuda", report_dir: str | None = None,
) -> SocketRoundResult:
    """One federated round over real TCP with ``n_clients`` OS processes.

    The server binds an ephemeral loopback port and services connections
    CONCURRENTLY: an accept thread spawns one handler per connection, so a
    stalled client cannot head-of-line-block the round, and in buffered
    mode aggregation overlaps the other clients' uploads. The round
    commits when every live client lands, or — once ``round_deadline_s``
    passes — when ``quorum_frac`` of clients have (stragglers booked as
    dropped bytes); fewer survivors than the quorum raise
    ``QuorumNotMetError``. Crashed children are detected by exit code and
    stop being waited for. With ``fault_cfg`` a ``ChaosProxy`` injects
    deterministic in-path faults and clients reconnect/resume through it.
    Every child is reaped on the way out, escalating ``terminate()`` →
    ``kill()``. The aggregator and every client encode run on ``device``;
    on the card the kernels are built here before any child starts. With
    ``report_dir`` (an existing directory) every child writes its exit
    report there (``SocketRoundResult.client_reports``).
    """
    if n_clients < 1:
        raise ValueError(f"n_clients must be ≥ 1, got {n_clients}")
    if mode not in ("sync", "buffered"):
        raise ValueError(f"unknown mode {mode!r} (sync | buffered)")
    if not 0.0 < quorum_frac <= 1.0:
        raise ValueError(f"quorum_frac must be in (0, 1], got {quorum_frac}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        for name in ("quantize_pack", "aggregate", "vote"):
            _build.load(name)   # one nvcc here, never one per child
    ctx = mp.get_context(start_method)
    bcast_blob = encode_update(global_params)
    quorum_n = max(1, math.ceil(quorum_frac * n_clients))

    t0 = time.perf_counter()
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    state = _RoundState()
    procs: dict[int, Any] = {}
    spawned_at: dict[int, float] = {}
    handlers: list[threading.Thread] = []
    threads: list[threading.Thread] = []
    proxy: ChaosProxy | None = None
    agg = Aggregator(
        chunk_c=chunk_c, device=dev,
        rule=defense.rule if defense is not None else "mean",
        trim_frac=defense.trim_frac if defense is not None else 0.2,
    )
    out_params = _on_device(global_params, dev)
    folded = 0
    if defense is not None and defense.enabled:
        state.gate = UpdateGate(defense, global_params)
    attackers = (attacker_ids(attack, n_clients) if attack is not None
                 else frozenset())
    try:
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, 0))
        srv.listen(max(n_clients, 8))
        srv.settimeout(0.1)
        port = srv.getsockname()[1]
        acceptor = threading.Thread(
            target=_accept_loop,
            args=(srv, state, bcast_blob, timeout_s, handlers),
            daemon=True,
        )
        acceptor.start()
        threads.append(acceptor)

        client_port = port
        if fault_cfg is not None:
            proxy = ChaosProxy((host, port), fault_cfg, host=host)
            client_port = proxy.port
        crash_set = set(fault_cfg.crash_clients) if fault_cfg else set()
        bad_proto = set(fault_cfg.bad_proto_clients) if fault_cfg else set()
        for cid in range(n_clients):
            p = ctx.Process(
                target=_client_main,
                args=(host, client_port, cid, seed, timeout_s, retry,
                      fault_cfg.crash_after_frac if cid in crash_set else None,
                      PROTO_V1 if cid in legacy_clients
                      else (99 if cid in bad_proto else PROTO_VERSION),
                      attack if cid in attackers else None,
                      str(dev), report_dir),
                daemon=True,
            )
            spawned_at[cid] = time.time()
            p.start()
            procs[cid] = p

        # ---- the round loop: wait / fold / watch / commit ----------------
        deadline = time.monotonic() + (
            round_deadline_s if math.isfinite(round_deadline_s) else timeout_s
        )
        committed = "full"
        while True:
            with state.cond:
                state.cond.wait(timeout=0.05)
                n_done = len(state.completed)
            if mode == "buffered":
                # overlap: fold whole buffers while uploads are in flight
                while n_done - folded >= buffer_k:
                    with state.lock:
                        batch = state.completed[folded:folded + buffer_k]
                    out_params = _buffered_mix(
                        out_params, [(w, b) for _, w, b in batch], eta, agg)
                    folded += buffer_k
            # the process watcher: a dead child without a landed update can
            # never arrive — shrink the expected set instead of waiting
            resolved = set()
            for cid, p in procs.items():
                if (cid in state.completed_ids or cid in state.rejected
                        or cid in state.quarantined):
                    resolved.add(cid)
                elif p.exitcode is not None:
                    resolved.add(cid)     # crashed / exhausted / rejected
            n_completed = len(state.completed_ids)
            expected = n_clients - len(resolved - state.completed_ids)
            if n_completed >= expected:
                if n_completed < quorum_n:
                    raise QuorumNotMetError(
                        f"only {n_completed}/{n_clients} clients landed "
                        f"(quorum {quorum_n}); outcomes "
                        f"{_final_outcomes(state, procs)}")
                committed = "full" if n_completed == n_clients else "quorum"
                break
            if time.monotonic() >= deadline:
                if n_completed >= quorum_n:
                    committed = "quorum"
                    break
                raise QuorumNotMetError(
                    f"deadline hit with {n_completed}/{n_clients} landed "
                    f"(quorum {quorum_n}); outcomes "
                    f"{_final_outcomes(state, procs)}")

        # ---- commit ------------------------------------------------------
        with state.cond:
            state.closing = True
            state.cond.notify_all()
        srv.close()
        # handlers poll at 0.25s and bail on state.closing, so a shared
        # deadline suffices — never 5s per straggler thread.
        join_end = time.monotonic() + 5.0
        for t in handlers:
            t.join(timeout=max(0.0, join_end - time.monotonic()))
        # stragglers: their bytes were paid for but never fold in. shipped
        # is metered INDEPENDENTLY (session decoders' bytes_in — the socket
        # meter) so the ledger's shipped == ingested + dropped balance is a
        # real cross-check against frame-size arithmetic, not an identity.
        with state.lock:
            shipped = state.v1_update_bytes + state.superseded_bytes
            for cid, sess in state.sessions.items():
                shipped += sess.dec.bytes_in
                if cid in state.quarantined:
                    # frame bytes are already in the quarantine bucket;
                    # anything beyond the frame (resume overshoot) is waste
                    extra = sess.dec.bytes_in - state.quarantined[cid][1]
                    if extra > 0:
                        state.dropped_update_bytes += extra
                elif cid not in state.completed_ids:
                    state.dropped_update_bytes += sess.dec.bytes_in
                    agg.note_dropped(sess.dec.bytes_in)
                elif sess.completed:
                    extra = sess.dec.bytes_in - sess.frame_bytes
                    if extra > 0:
                        state.dropped_update_bytes += extra
            for _reason, nbytes in state.quarantined.values():
                agg.note_quarantined(nbytes)
            arrivals_final = list(state.completed)
        if mode == "sync":
            for _cid, weight, blob in sorted(arrivals_final):
                agg.add(blob, weight=weight)
            out_params = agg.finalize()
        else:
            # the arrivals that landed while the last fold ran (or since it)
            # fold in whole buffers too, as the in-process reference folds
            # them: one mix of them all would move the global otherwise
            for i in range(folded, len(arrivals_final), buffer_k):
                batch = arrivals_final[i:i + buffer_k]
                out_params = _buffered_mix(
                    out_params, [(w, b) for _, w, b in batch], eta, agg)
    finally:
        with state.cond:
            state.closing = True
            state.cond.notify_all()
        srv.close()
        esc = reap_processes(list(procs.values()), grace_s=join_grace_s)
        if proxy is not None:
            proxy.close()
        join_end = time.monotonic() + 5.0
        for t in threads + handlers:
            t.join(timeout=max(0.0, join_end - time.monotonic()))

    return SocketRoundResult(
        params=out_params,
        n_clients=n_clients,
        arrivals=[cid for cid, _, _ in arrivals_final],
        upload_bytes=state.up_bytes,
        download_bytes=state.down_bytes,
        payload_bytes=state.payload_bytes,
        wall_s=time.perf_counter() - t0,
        mode=mode,
        outcomes=_final_outcomes(state, procs),
        committed=committed,
        quorum_frac=quorum_frac,
        quorum_n=quorum_n,
        shipped_update_bytes=shipped,
        ingested_update_bytes=state.ingested_update_bytes,
        dropped_update_bytes=state.dropped_update_bytes,
        quarantined_update_bytes=state.quarantined_update_bytes,
        resumed_bytes=state.resumed_bytes,
        retries=state.retries,
        escalations=esc,
        chaos=dict(proxy.stats) if proxy is not None else None,
        defense=(state.gate.telemetry() if state.gate is not None else None),
        client_reports=_read_reports(report_dir, spawned_at),
        received=arrivals_final,
    )


# --------------------------------------------------------------------------
# CLI demo / CI smoke.
# --------------------------------------------------------------------------


def default_chaos(seed: int = 0, n_clients: int = 6,
                  chunk_bytes: int = 512) -> FaultConfig:
    """The chaos preset: bursty Gilbert–Elliott weather (delays, kills and
    refused connects), mid-frame truncation at ``chunk_bytes`` granularity
    (512: several boundaries inside a demo update frame, so kills truncate
    mid-frame and force a resume), and the last client crashing mid-upload
    — every outcome reachable."""
    return FaultConfig(
        seed=seed,
        chunk_bytes=chunk_bytes,
        ge_p_good_bad=0.15,
        ge_p_bad_good=0.4,
        fault_good=0.0,
        fault_bad=0.4,
        p_kill=0.5,
        p_refuse=0.5,
        delay_s=0.01,
        crash_clients=(n_clients - 1,),
        crash_after_frac=0.5,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Federated round over real TCP with N client processes"
    )
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--mode", choices=("sync", "buffered"), default="sync")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk-c", type=int, default=16)
    ap.add_argument("--buffer-k", type=int, default=4)
    ap.add_argument("--eta", type=float, default=0.5)
    ap.add_argument("--timeout-s", type=float, default=DEFAULT_TIMEOUT_S)
    ap.add_argument("--quorum-frac", type=float, default=None,
                    help="commit once this fraction of clients lands "
                         "(default: 1.0, or 0.5 under --chaos)")
    ap.add_argument("--deadline-s", type=float, default=float("inf"))
    ap.add_argument("--chaos", action="store_true",
                    help="run through the deterministic ChaosProxy preset "
                         "(drops, delays, truncation, one client crash)")
    ap.add_argument("--chaos-seed", type=int, default=19,
                    help="fault seed (19: mid-frame kills AND a refused "
                         "connect are reachable, so resume is exercised)")
    ap.add_argument("--check", action="store_true",
                    help="also run the in-process reference (restricted to "
                         "the surviving client set) and require a "
                         "byte-identical aggregate")
    ap.add_argument("--defense", action="store_true",
                    help="enable the content quarantine gate")
    ap.add_argument("--rule", default="mean",
                    choices=("mean", "majority", "trimmed_mean", "median"),
                    help="aggregation rule (with --defense)")
    ap.add_argument("--attack", default=None,
                    choices=("sign_flip", "scale_blowup", "gaussian",
                             "nan_poison", "collude"),
                    help="turn a seeded subset of clients Byzantine")
    ap.add_argument("--attackers", type=int, default=2,
                    help="attacker cohort size (with --attack)")
    ap.add_argument("--attack-seed", type=int, default=11)
    ap.add_argument("--device", default="cuda",
                    help="device of the server's aggregator and of every "
                         "client's encode (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)

    fault_cfg = None
    quorum_frac = args.quorum_frac
    if args.chaos:
        fault_cfg = default_chaos(seed=args.chaos_seed,
                                  n_clients=args.clients)
        if quorum_frac is None:
            quorum_frac = 0.5
    attack = None
    if args.attack is not None:
        attack = AttackConfig(kind=args.attack, n_attackers=args.attackers,
                              seed=args.attack_seed)
        if quorum_frac is None:
            # quarantined attackers never count as landed updates
            quorum_frac = max(0.1, (args.clients - args.attackers)
                              / max(args.clients, 1))
    defense = (DefenseConfig(enabled=True, rule=args.rule)
               if args.defense else None)
    if quorum_frac is None:
        quorum_frac = 1.0

    params = demo_params(seed=args.seed)
    res = run_socket_round(
        params, args.clients, seed=args.seed, mode=args.mode,
        chunk_c=args.chunk_c, buffer_k=args.buffer_k, eta=args.eta,
        timeout_s=args.timeout_s, quorum_frac=quorum_frac,
        round_deadline_s=args.deadline_s, fault_cfg=fault_cfg,
        defense=defense, attack=attack, device=args.device,
    )
    ledger = res.ledger()
    if args.check:
        order = (sorted(res.arrivals) if args.mode == "sync"
                 else res.arrivals)
        ref = run_inprocess_reference(
            params, args.clients, seed=args.seed, mode=args.mode,
            chunk_c=args.chunk_c, buffer_k=args.buffer_k, eta=args.eta,
            order=order, rule=args.rule if args.defense else "mean",
            device=args.device,
        )
        ledger["reference_sha256"] = params_hash(ref)
        ledger["byte_identical"] = (
            ledger["reference_sha256"] == ledger["params_sha256"]
        )
    print(json.dumps(ledger, indent=2))
    ok = True
    if args.check and not ledger["byte_identical"]:
        print("FAIL: socket aggregate differs from in-process reference",
              file=sys.stderr)
        ok = False
    if not ledger["balance_ok"]:
        print("FAIL: update-byte ledger does not balance "
              "(shipped != ingested + dropped + quarantined)",
              file=sys.stderr)
        ok = False
    if args.chaos and ledger["n_survivors"] < res.quorum_n:
        print("FAIL: chaos round committed below quorum", file=sys.stderr)
        ok = False
    if args.attack == "nan_poison" and args.defense:
        # the poison smoke's teeth: every attacker must be quarantined
        n_quar = sum(1 for v in ledger["outcomes"].values()
                     if v == "quarantined")
        if n_quar != min(args.attackers, args.clients):
            print(f"FAIL: only {n_quar} of {args.attackers} nan_poison "
                  "attackers were quarantined", file=sys.stderr)
            ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
