"""Length-prefixed TCP framing for federated wire traffic (port of
``repro.comm.transport``; frames are byte-identical to the reference's).

The layer that moves bytes across a REAL process boundary: ``comm.wire``
serializes to buffers, ``fed.mp_server`` speaks in frames. A frame is

    FRAME HEADER (16 B, little-endian):
      magic        4s  b"TFT1"
      ftype        u8  message type (HELLO / BCAST / UPDATE / DONE / ERR / RESUME)
      flags        u8  reserved (0)
      meta_len     u16 JSON metadata length
      payload_len  u64 payload length
    META     meta_len bytes of UTF-8 JSON, keys sorted, no spaces
    PAYLOAD  payload_len bytes: for UPDATE/BCAST one complete ``comm.wire``
             buffer, whose CRC32 the receiver verifies when it decodes it

``FrameDecoder`` mirrors ``wire.StreamDecoder``: feed arbitrary recv()
chunks, complete frames pop out, malformed headers fail fast, and
``close()`` at EOF raises on a partial frame, so a dropped connection is a
``TransportError``, never a hang or a silent short read. ``send_frame``
returns the framed byte count and ``FrameDecoder.bytes_in`` counts every
byte taken off the socket: the federation ledger's bytes are metered from
socket traffic.

Failures are typed under ``TransportError``: ``FrameError`` (malformed
bytes), ``TornConnectionError`` (the peer died mid-conversation),
``TransportTimeout`` (also a ``TimeoutError``), ``ProtocolError`` (valid
frames in an invalid order, an unsupported protocol version) and
``RetryExhausted``. ``RetryPolicy`` and ``call_with_retries`` give clients
exponential backoff with seeded jitter; the protocol-2 HELLO carries a
client nonce and an attempt counter so a reconnecting client can RESUME its
upload at the server's byte offset (``fed.mp_server``).
"""

from __future__ import annotations

import dataclasses
import json
import socket
import struct
import time
from collections import deque
from typing import Any, Callable

TRANSPORT_MAGIC = b"TFT1"
_FRAME = struct.Struct("<4sBBHQ")  # magic, ftype, flags, meta_len, payload_len

# frame types
FT_HELLO = 1    # client → server: {"client_id": int, "proto": int, ...}
FT_BCAST = 2    # server → client: payload = global-model wire buffer
FT_UPDATE = 3   # client → server: payload = update wire buffer, meta weight
FT_DONE = 4     # either direction: orderly end of conversation
FT_ERR = 5      # either direction: meta = {"error": str}
FT_RESUME = 6   # server → client: {"have": int} — resume upload at offset
_KNOWN_TYPES = frozenset((FT_HELLO, FT_BCAST, FT_UPDATE, FT_DONE, FT_ERR,
                          FT_RESUME))

# HELLO protocol version: v1 = the one-shot conversation (no nonce, no
# resume); v2 adds {proto, nonce, attempt} and the RESUME frame. A server
# answers a v2 HELLO with v2 frames only — a v1 peer never sees FT_RESUME.
PROTO_V1 = 1
PROTO_VERSION = 2
SUPPORTED_PROTOS = frozenset((PROTO_V1, PROTO_VERSION))

# a frame larger than this is a corrupted length field, not an update
MAX_PAYLOAD_BYTES = 1 << 34  # 16 GiB
RECV_CHUNK = 1 << 16


class TransportError(ConnectionError):
    """Malformed frame or torn connection at the transport layer."""


class FrameError(TransportError):
    """Bytes that are not a valid frame: bad magic, unknown type, corrupted
    length field, malformed JSON meta, or feeding a closed decoder."""


class TornConnectionError(TransportError):
    """The peer vanished mid-conversation: EOF inside a frame, reset, or a
    clean close where a frame was still owed."""


class TransportTimeout(TransportError, TimeoutError):
    """The peer went silent past the deadline (socket timeout surfaced
    through the transport taxonomy; still catchable as ``TimeoutError``)."""


class ProtocolError(TransportError):
    """Well-formed frames in an order the protocol forbids — wrong frame
    type for the conversation state, unsupported protocol version,
    duplicate or mismatched client identity."""


class RetryExhausted(TransportError):
    """A retrying client gave up: every attempt failed. ``attempts`` counts
    them; ``__cause__`` is the last attempt's error."""

    def __init__(self, msg: str, attempts: int = 0):
        super().__init__(msg)
        self.attempts = attempts


@dataclasses.dataclass(frozen=True)
class Frame:
    ftype: int
    meta: dict
    payload: bytes

    @property
    def nbytes_framed(self) -> int:
        """Exact on-wire size of this frame."""
        return _FRAME.size + len(_meta_bytes(self.meta)) + len(self.payload)


def _meta_bytes(meta: dict | None) -> bytes:
    if not meta:
        return b""
    return json.dumps(meta, sort_keys=True, separators=(",", ":")).encode("utf-8")


def pack_frame(ftype: int, payload: bytes = b"", meta: dict | None = None) -> bytes:
    """Serialize one frame (header + JSON meta + payload)."""
    if ftype not in _KNOWN_TYPES:
        raise FrameError(f"unknown frame type {ftype}")
    mb = _meta_bytes(meta)
    if len(mb) > 0xFFFF:
        raise FrameError(f"frame meta too large: {len(mb)} B")
    if len(payload) > MAX_PAYLOAD_BYTES:
        raise FrameError(f"frame payload too large: {len(payload)} B")
    return b"".join([
        _FRAME.pack(TRANSPORT_MAGIC, ftype, 0, len(mb), len(payload)),
        mb,
        payload,
    ])


class FrameDecoder:
    """Incremental frame reassembly over recv() chunks (one per connection).

    Same failure discipline as ``wire.StreamDecoder``: header problems
    (magic, unknown type, oversized lengths) raise ``TransportError`` the
    moment the 16 header bytes are in; ``close()`` on a partial frame
    raises instead of dropping it.
    """

    def __init__(self, *, max_payload_bytes: int = MAX_PAYLOAD_BYTES):
        self._buf = bytearray()
        self._need: int | None = None
        self._max_payload = int(max_payload_bytes)
        self._ready: deque[Frame] = deque()
        self.bytes_in = 0          # every byte fed, the socket-traffic meter
        self.closed = False

    def _header_check(self) -> int:
        magic, ftype, _flags, meta_len, payload_len = _FRAME.unpack_from(self._buf)
        if magic != TRANSPORT_MAGIC:
            raise FrameError(
                f"bad frame magic {magic!r} (expected {TRANSPORT_MAGIC!r})"
            )
        if ftype not in _KNOWN_TYPES:
            raise FrameError(f"unknown frame type {ftype}")
        if payload_len > self._max_payload:
            raise FrameError(
                f"payload_len {payload_len} exceeds cap {self._max_payload} — "
                "corrupted length field"
            )
        return _FRAME.size + meta_len + payload_len

    def feed(self, chunk: bytes) -> list[Frame]:
        """Absorb one chunk; returns the frames it completed (they are ALSO
        queued internally — drain with ``pop()`` OR consume the return
        value, not both)."""
        if self.closed:
            raise FrameError("feed() after close(): decoder is finished")
        self._buf += chunk
        self.bytes_in += len(chunk)
        out: list[Frame] = []
        while True:
            if self._need is None:
                if len(self._buf) < _FRAME.size:
                    break
                self._need = self._header_check()
            if len(self._buf) < self._need:
                break
            raw = bytes(self._buf[: self._need])
            del self._buf[: self._need]
            self._need = None
            _, ftype, _flags, meta_len, payload_len = _FRAME.unpack_from(raw)
            meta_raw = raw[_FRAME.size : _FRAME.size + meta_len]
            try:
                meta = json.loads(meta_raw.decode("utf-8")) if meta_len else {}
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise FrameError(f"malformed frame meta: {e}") from e
            if not isinstance(meta, dict):
                raise FrameError(
                    f"frame meta must be a JSON object, got {type(meta).__name__}"
                )
            out.append(Frame(ftype, meta, raw[_FRAME.size + meta_len :]))
        self._ready.extend(out)
        return out

    def pop(self) -> Frame | None:
        """Take the oldest queued complete frame (None if none pending)."""
        return self._ready.popleft() if self._ready else None

    @property
    def pending_bytes(self) -> int:
        return len(self._buf)

    def take_buffer(self) -> bytes:
        """Hand off the raw undecoded tail (bytes of a frame still in
        flight) and leave the decoder clean. The resume path uses this to
        move bytes that over-read past a handshake frame into the
        session's long-lived decoder; ``bytes_in`` keeps counting them
        here (they WERE read off this socket)."""
        out = bytes(self._buf)
        self._buf.clear()
        self._need = None
        return out

    def close(self) -> None:
        self.closed = True
        if self._buf:
            need = "?" if self._need is None else str(self._need)
            raise TornConnectionError(
                f"connection closed mid-frame: {len(self._buf)} bytes pending "
                f"of {need}"
            )


# --------------------------------------------------------------------------
# Blocking socket helpers (the client side of the socket round).
# --------------------------------------------------------------------------


def send_frame(
    sock: socket.socket, ftype: int, payload: bytes = b"",
    meta: dict | None = None,
) -> int:
    """Send one frame; returns the exact framed byte count put on the wire."""
    buf = pack_frame(ftype, payload, meta)
    sock.sendall(buf)
    return len(buf)


def recv_frame(
    sock: socket.socket, decoder: FrameDecoder | None = None,
    timeout_s: float | None = None,
) -> Frame:
    """Block until one complete frame arrives (partial-read tolerant).

    Pass a persistent ``decoder`` when the connection carries several
    frames — bytes of the NEXT frame that rode in on the same recv() stay
    buffered in it. EOF mid-frame raises ``TornConnectionError``; a socket
    timeout surfaces as ``TransportTimeout``. A ``timeout_s`` applies only
    to THIS call — the socket's prior timeout is restored on the way out,
    never left mutated as a side effect.
    """
    dec = decoder if decoder is not None else FrameDecoder()
    prior = sock.gettimeout()
    if timeout_s is not None:
        sock.settimeout(timeout_s)
    try:
        while True:
            # frames buffered by an earlier recv() drain first (pop, so a
            # chunk carrying several frames never loses the extras)
            frame = dec.pop()
            if frame is not None:
                return frame
            try:
                chunk = sock.recv(RECV_CHUNK)
            except socket.timeout as e:
                raise TransportTimeout(
                    f"no frame within {timeout_s if timeout_s is not None else prior}s"
                ) from e
            except ConnectionResetError as e:
                raise TornConnectionError(f"connection reset: {e}") from e
            if not chunk:
                dec.close()   # raises TornConnectionError on partial frame
                raise TornConnectionError(
                    "connection closed before a frame arrived")
            dec.feed(chunk)
    finally:
        if timeout_s is not None:
            try:
                sock.settimeout(prior)
            except OSError:
                pass   # socket already dead — nothing to restore


# --------------------------------------------------------------------------
# Retry policy (reconnect/backoff for flaky links).
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with seeded jitter for reconnecting clients.

    ``backoff_s(attempt)`` grows ``base_backoff_s · factor^attempt`` capped
    at ``max_backoff_s``; jitter multiplies by U[1-jitter_frac, 1+jitter_frac]
    drawn from the CALLER's rng, so a seeded client backs off identically
    run to run (chaos determinism) while distinct clients decorrelate.
    """

    max_attempts: int = 5
    base_backoff_s: float = 0.05
    backoff_factor: float = 2.0
    max_backoff_s: float = 2.0
    jitter_frac: float = 0.1
    connect_timeout_s: float = 10.0
    io_timeout_s: float = 60.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be ≥ 1, got {self.max_attempts}")
        if self.backoff_factor < 1.0:
            raise ValueError(
                f"backoff_factor must be ≥ 1, got {self.backoff_factor}")

    def backoff_s(self, attempt: int, rng=None) -> float:
        base = min(self.base_backoff_s * self.backoff_factor ** attempt,
                   self.max_backoff_s)
        if rng is None or self.jitter_frac <= 0:
            return base
        lo, hi = 1.0 - self.jitter_frac, 1.0 + self.jitter_frac
        return base * float(rng.uniform(lo, hi))


def call_with_retries(
    fn: Callable[[int], Any], policy: RetryPolicy, rng=None, *,
    retryable: tuple = (TransportError, OSError),
    fatal: tuple = (),
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Run ``fn(attempt)`` until it returns, retrying ``retryable`` failures
    with the policy's backoff. ``fatal`` exception types (checked first)
    propagate immediately — a server REJECTION must not be retried into.
    Exhaustion raises ``RetryExhausted`` chaining the last error."""
    last: BaseException | None = None
    for attempt in range(policy.max_attempts):
        try:
            return fn(attempt)
        except fatal:
            raise
        except retryable as e:
            last = e
            if attempt + 1 < policy.max_attempts:
                sleep(policy.backoff_s(attempt, rng))
    raise RetryExhausted(
        f"gave up after {policy.max_attempts} attempts: {last}",
        attempts=policy.max_attempts,
    ) from last
