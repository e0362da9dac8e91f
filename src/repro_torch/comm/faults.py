"""Deterministic in-path fault injection for the socket tier (port of
``repro.comm.faults``; schedules and proxy behaviour equal the reference's).

The simulated channel (``comm.channel``) turns bytes into *seconds* under a
Gilbert–Elliott bursty-loss chain; this module puts the same chain's
weather into the REAL socket path. A ``ChaosProxy`` sits between the client
processes and the server, forwards TCP bytes and, per the chain's per-chunk
state, delays them, throttles them, truncates them mid-frame, refuses
connections and resets established ones: the same ``ge_p_good_bad`` /
``ge_p_bad_good`` step probabilities, the same "per-chunk misfortune while
the link is in the bad state".

Determinism: every fault decision is drawn from a ``FaultSchedule`` keyed
by ``(seed, client_id, attempt)`` (numpy ``default_rng`` with the
reference's key and draw order) and applied at absolute *byte offsets* of
the client→server stream (chunk ``i`` covers bytes ``[i·chunk_bytes,
(i+1)·chunk_bytes)``), never at recv() boundaries. TCP segmentation,
thread scheduling and timing cannot change WHICH bytes of an attempt
survive, so the surviving-client set of a chaos round is a pure function
of the fault seed. The schedule fills lazily in chunk order, so a stream
is reproducible however far a connection gets. With both fault rates zero
it draws nothing and the proxy is a transparent byte pump.
"""

from __future__ import annotations

import dataclasses
import socket
import struct
import threading
import time

import numpy as np

from repro_torch.comm.transport import FrameDecoder, TransportError

# action codes in a schedule's lazily-filled stream
OK = "ok"
DELAY = "delay"
KILL = "kill"
REFUSE = "refuse"

_LINGER_RST = struct.pack("ii", 1, 0)   # SO_LINGER(on, 0s) → close sends RST


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Knobs for the in-path fault injector.

    The two-state chain reuses the channel's Gilbert–Elliott semantics:
    the link hops good↔bad per ``chunk_bytes`` of client→server traffic
    with ``ge_p_good_bad`` / ``ge_p_bad_good``; while in state *s* each
    chunk independently suffers a fault with probability ``fault_good`` /
    ``fault_bad``. A faulted chunk is either a KILL (both sides of the
    connection are reset — mid-frame truncation as seen by the server,
    ECONNRESET as seen by the client) with probability ``p_kill``, or a
    DELAY of ``delay_s`` seconds. A connection arriving while the chain
    starts in the bad state is refused outright with ``p_refuse``.

    ``throttle_bytes`` > 0 additionally paces ALL forwarding (good chunks
    included) to that granularity with ``throttle_delay_s`` sleeps — a
    slow-sender mode that stresses incremental decoders without changing
    any outcome.

    ``crash_clients`` / ``bad_proto_clients`` are client-side injections
    (the proxy cannot crash a process): members of ``crash_clients`` send a
    ``crash_after_frac`` prefix of their upload then hard-exit; members of
    ``bad_proto_clients`` announce an unsupported protocol version and get
    rejected. Both make the corresponding outcome taxonomy entries
    (``crashed`` / ``rejected``) deterministically reachable in tests.

    ``corrupt_clients`` turns the proxy into a Byzantine man-in-the-middle
    for those client ids: their UPDATE frames are decoded in-path, the wire
    payload is poisoned with the seeded ``corrupt_kind`` attacker model
    (``fed.attackers``), the wire CRC is recomputed by the re-encode, and
    the frame is re-packed — so the poisoned traffic is WIRE-VALID and
    sails past every byte-level defense; only the content gate or a robust
    aggregation rule can stop it. Corrupted clients bypass the byte-offset
    chunk schedule (frames must arrive whole to be poisoned), so corruption
    and kill/delay weather are mutually exclusive per client by design.
    """

    seed: int = 0
    chunk_bytes: int = 4096
    ge_p_good_bad: float = 0.1
    ge_p_bad_good: float = 0.5
    fault_good: float = 0.0
    fault_bad: float = 0.5
    p_kill: float = 0.5
    p_refuse: float = 0.5
    delay_s: float = 0.02
    throttle_bytes: int = 0
    throttle_delay_s: float = 0.0
    crash_clients: tuple = ()
    crash_after_frac: float = 0.5
    bad_proto_clients: tuple = ()
    corrupt_clients: tuple = ()
    corrupt_kind: str = "sign_flip"
    corrupt_seed: int = 0

    def __post_init__(self):
        for name in ("ge_p_good_bad", "ge_p_bad_good", "fault_good",
                     "fault_bad", "p_kill", "p_refuse"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.chunk_bytes < 1:
            raise ValueError(f"chunk_bytes must be ≥ 1, got {self.chunk_bytes}")
        if self.corrupt_clients:
            from repro_torch.fed.attackers import ATTACKS  # lazy: fed layer

            if self.corrupt_kind not in ATTACKS:
                raise ValueError(
                    f"corrupt_kind must be one of {ATTACKS}, "
                    f"got {self.corrupt_kind!r}"
                )

    @property
    def disabled(self) -> bool:
        """True ⇒ no fault randomness is drawn at all (transparent proxy)."""
        return self.fault_good <= 0.0 and self.fault_bad <= 0.0

    @property
    def stationary_p_bad(self) -> float:
        gb, bg = self.ge_p_good_bad, self.ge_p_bad_good
        return gb / (gb + bg) if gb + bg > 0 else 0.0


class FaultSchedule:
    """The deterministic per-(client, attempt) action stream.

    One instance = one connection attempt's weather. ``connect_action()``
    is drawn first (refusal happens before any byte moves); ``action_at(i)``
    then gives chunk ``i``'s fate, filling the stream lazily IN ORDER so a
    partially-consumed schedule is a prefix of the fully-consumed one.
    """

    def __init__(self, cfg: FaultConfig, client_id: int, attempt: int):
        self.cfg = cfg
        self.key = (int(cfg.seed), int(client_id), int(attempt))
        self._rng = np.random.default_rng(
            [int(cfg.seed), 0x5EED_FA17, int(client_id), int(attempt)]
        )
        self._actions: list[tuple[str, float]] = []
        if cfg.disabled:
            self._bad = False
            self._connect: tuple[str, float] = (OK, 0.0)
            return
        self._bad = bool(self._rng.random() < cfg.stationary_p_bad)
        refused = (self._bad and self._rng.random() < cfg.p_refuse)
        self._connect = (REFUSE, 0.0) if refused else (OK, 0.0)

    def connect_action(self) -> str:
        """``OK`` or ``REFUSE`` — decided before any byte is forwarded."""
        return self._connect[0]

    def action_at(self, chunk_idx: int) -> tuple[str, float]:
        """Fate of the chunk covering bytes [idx·chunk, (idx+1)·chunk)."""
        if self.cfg.disabled:
            return (OK, 0.0)
        while len(self._actions) <= chunk_idx:
            self._actions.append(self._step())
        return self._actions[chunk_idx]

    def _step(self) -> tuple[str, float]:
        cfg = self.cfg
        p_fault = cfg.fault_bad if self._bad else cfg.fault_good
        act: tuple[str, float] = (OK, 0.0)
        if p_fault > 0.0 and self._rng.random() < p_fault:
            if self._rng.random() < cfg.p_kill:
                act = (KILL, 0.0)
            else:
                act = (DELAY, cfg.delay_s)
        # chain hop AFTER the chunk, like the channel's per-chunk step
        u = self._rng.random()
        self._bad = (u >= cfg.ge_p_bad_good) if self._bad \
            else (u < cfg.ge_p_good_bad)
        return act

    def first_kill_offset(self, nbytes: int) -> int | None:
        """Byte offset where a ``nbytes``-long upstream would be truncated
        (None ⇒ it survives). Pure — used to predict survivors in tests."""
        n_chunks = (nbytes + self.cfg.chunk_bytes - 1) // self.cfg.chunk_bytes
        for i in range(n_chunks):
            if self.action_at(i)[0] == KILL:
                return i * self.cfg.chunk_bytes
        return None


def abort_socket(sock: socket.socket) -> None:
    """Hard-close: RST instead of FIN, so the peer sees ECONNRESET (a torn
    connection), never a clean half-close it could mistake for EOF-at-a-
    frame-boundary."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, _LINGER_RST)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class ChaosProxy:
    """A TCP forwarder that injects the schedule's faults in-path.

    Clients connect to ``proxy.port`` instead of the server. Each accepted
    connection: (1) the first transport frame (the HELLO) is read off the
    client to learn ``(client_id, attempt)`` — the schedule key — without
    trusting timing; (2) the schedule's connect action may refuse (RST)
    immediately; (3) otherwise an upstream connection opens and two pumps
    move bytes. The client→server pump applies the schedule at absolute
    byte offsets (the HELLO bytes themselves are offset 0 — a kill in
    chunk 0 means the server never hears the client at all); the
    server→client pump is transparent, but a KILL resets BOTH directions,
    so a mid-BCAST abort surfaces client-side too.

    A connection whose first bytes are not a parseable frame is reset
    (garbage in → RST out) — the proxy never forwards traffic it cannot
    attribute to a schedule key.
    """

    def __init__(self, upstream: tuple[str, int], cfg: FaultConfig,
                 host: str = "127.0.0.1", accept_timeout_s: float = 0.1):
        self.upstream = upstream
        self.cfg = cfg
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()
        self.stats = {
            "connections": 0, "refused": 0, "killed": 0,
            "delayed_chunks": 0, "delay_s": 0.0,
            "bytes_up": 0, "bytes_down": 0, "corrupted_frames": 0,
        }
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, 0))
        self._srv.listen(64)
        self._srv.settimeout(accept_timeout_s)
        self.host, self.port = self._srv.getsockname()[:2]
        self._acceptor = threading.Thread(
            target=self._accept_loop, name="chaos-accept", daemon=True
        )
        self._acceptor.start()

    # -- lifecycle ---------------------------------------------------------

    def __enter__(self) -> "ChaosProxy":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        end = time.monotonic() + 5.0
        self._acceptor.join(timeout=5)
        for t in list(self._threads):
            t.join(timeout=max(0.0, end - time.monotonic()))

    def _count(self, key: str, v: float = 1) -> None:
        with self._lock:
            self.stats[key] += v

    # -- the pumps ---------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            self._count("connections")
            t = threading.Thread(
                target=self._handle, args=(conn,), daemon=True
            )
            t.start()
            self._threads.append(t)

    def _peek_hello(self, conn: socket.socket) -> tuple[bytes, dict]:
        """Read client bytes until the first frame parses; returns (all raw
        bytes consumed so far, hello meta). Raises TransportError on
        garbage or EOF before a frame."""
        dec = FrameDecoder(max_payload_bytes=1 << 20)
        raw = bytearray()
        conn.settimeout(0.25)   # short poll: must notice close() fast
        deadline = time.monotonic() + 30.0
        while True:
            if self._stop.is_set() or time.monotonic() > deadline:
                raise TransportError("no HELLO before proxy shutdown/deadline")
            try:
                chunk = conn.recv(4096)
            except socket.timeout:
                continue
            if not chunk:
                raise TransportError("client closed before HELLO")
            raw += chunk
            frames = dec.feed(chunk)         # raises on malformed header
            if frames:
                return bytes(raw), frames[0].meta
            if len(raw) > (1 << 20):
                raise TransportError("first frame too large to attribute")

    def _handle(self, conn: socket.socket) -> None:
        up: socket.socket | None = None
        try:
            raw, meta = self._peek_hello(conn)
            sched = FaultSchedule(
                self.cfg,
                int(meta.get("client_id", -1)),
                int(meta.get("attempt", 0)),
            )
            if sched.connect_action() == REFUSE:
                self._count("refused")
                abort_socket(conn)
                return
            up = socket.create_connection(self.upstream, timeout=30.0)
            killed = threading.Event()
            down = threading.Thread(
                target=self._pump_down, args=(up, conn, killed), daemon=True
            )
            down.start()
            cid = int(meta.get("client_id", -1))
            if cid in self.cfg.corrupt_clients:
                self._pump_up_corrupt(conn, up, cid, bytes(raw), killed)
            else:
                self._pump_up(conn, up, sched, bytes(raw), killed)
            down.join(timeout=30)
        except (TransportError, OSError):
            abort_socket(conn)
            if up is not None:
                abort_socket(up)
        finally:
            for s in (conn, up):
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass

    def _forward(self, dst: socket.socket, block: bytes) -> None:
        """One good block downstream of the schedule, optionally throttled
        byte-for-byte (slow-sender pacing; outcomes unaffected)."""
        tb = self.cfg.throttle_bytes
        if tb <= 0:
            dst.sendall(block)
            return
        for i in range(0, len(block), tb):
            dst.sendall(block[i:i + tb])
            if self.cfg.throttle_delay_s > 0:
                time.sleep(self.cfg.throttle_delay_s)

    def _pump_up(self, conn: socket.socket, up: socket.socket,
                 sched: FaultSchedule, first: bytes,
                 killed: threading.Event) -> None:
        """Client→server, schedule applied at absolute byte offsets."""
        chunk_b = self.cfg.chunk_bytes
        offset = 0
        pending = bytearray(first)
        conn.settimeout(0.25)   # short poll: must notice killed/stop fast
        while True:
            # flush everything buffered, chunk-aligned to absolute offsets
            while pending:
                idx = offset // chunk_b
                boundary = (idx + 1) * chunk_b
                take = min(len(pending), boundary - offset)
                act, secs = sched.action_at(idx)
                if act == KILL and offset == idx * chunk_b:
                    # truncate exactly at the chunk start: nothing of this
                    # chunk is forwarded, both sides reset
                    self._count("killed")
                    killed.set()
                    abort_socket(up)
                    abort_socket(conn)
                    return
                if act == DELAY and offset == idx * chunk_b:
                    self._count("delayed_chunks")
                    self._count("delay_s", secs)
                    time.sleep(secs)
                block = bytes(pending[:take])
                del pending[:take]
                self._forward(up, block)
                offset += take
                self._count("bytes_up", take)
            if killed.is_set() or self._stop.is_set():
                return
            try:
                chunk = conn.recv(1 << 16)
            except socket.timeout:
                continue        # idle — re-check killed/stop and poll again
            except OSError:
                return
            if not chunk:
                try:                     # forward the client's half-close
                    up.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
                return
            pending += chunk

    def _pump_up_corrupt(self, conn: socket.socket, up: socket.socket,
                         cid: int, first: bytes,
                         killed: threading.Event) -> None:
        """Client→server for a Byzantine-proxied client: every frame is
        reassembled, UPDATE payloads are poisoned with the seeded attacker
        model and re-encoded (fresh wire CRC), and the frame is re-packed —
        the server sees a perfectly well-formed, content-poisoned stream."""
        from repro_torch.comm.transport import FT_UPDATE, pack_frame
        from repro_torch.fed.attackers import AttackConfig, poison_blob  # lazy: fed

        acfg = AttackConfig(kind=self.cfg.corrupt_kind, n_attackers=1,
                            seed=self.cfg.corrupt_seed)
        dec = FrameDecoder()
        conn.settimeout(0.25)   # short poll: must notice killed/stop fast

        def emit(chunk: bytes) -> None:
            for frame in dec.feed(chunk):
                if frame.ftype == FT_UPDATE:
                    payload = poison_blob(frame.payload, acfg, cid)
                    self._count("corrupted_frames")
                else:
                    payload = frame.payload
                out = pack_frame(frame.ftype, payload, frame.meta)
                self._forward(up, out)
                self._count("bytes_up", len(out))

        try:
            emit(first)
            while not killed.is_set() and not self._stop.is_set():
                try:
                    chunk = conn.recv(1 << 16)
                except socket.timeout:
                    continue
                except OSError:
                    return
                if not chunk:
                    try:             # forward the client's half-close
                        up.shutdown(socket.SHUT_WR)
                    except OSError:
                        pass
                    return
                emit(chunk)
        except (TransportError, OSError):
            abort_socket(up)
            abort_socket(conn)

    def _pump_down(self, up: socket.socket, conn: socket.socket,
                   killed: threading.Event) -> None:
        """Server→client, transparent (a KILL elsewhere resets this side)."""
        try:
            up.settimeout(0.25)  # short poll: must notice killed/stop fast
        except OSError:
            return              # a KILL already closed the upstream socket
        while not killed.is_set() and not self._stop.is_set():
            try:
                chunk = up.recv(1 << 16)
            except socket.timeout:
                continue
            except OSError:
                return
            if not chunk:
                try:
                    conn.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
                return
            try:
                conn.sendall(chunk)
                self._count("bytes_down", len(chunk))
            except OSError:
                return
