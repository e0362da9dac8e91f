"""Simulated transport: payload bytes → wall-clock transfer times.

Port of ``repro.comm.channel`` (pure numpy). Each client gets a
``ClientLink`` with bandwidth and latency drawn once from log-normal /
normal distributions; a transfer of ``nbytes`` costs

    t = latency + jitter + nbytes / bandwidth

so stragglers are emergent from bytes ÷ bandwidth. ``transfer_concurrent``
shares the server NIC (``server_bandwidth_bytes_s``) max-min fairly among
simultaneous flows. Lossy links move payloads in ``chunk_bytes`` chunks,
lost iid (``loss_rate``) or in Gilbert–Elliott bursts, and retransmitted
after a timeout with exponential backoff; retransmissions are metered apart
from goodput. With loss off no loss randomness is drawn, so the rng stream
is the loss-free model's.

Every draw happens in the reference's order from a ``numpy`` Generator
with the same seed, so a seeded run gives the reference's transfer log,
bit for bit. ``transfer_timed`` meters one transfer that starts at an
absolute simulated time, for the async server, whose uploads contend for
a capped NIC with the other flows in flight.

Fleet-scale batches (``transfer_batch``, ``compute_time_batch``) meter a
whole cohort of transfers with one rng fold per batch and keep a batch
ledger (counters plus one seconds array per batch) that ``summary()``
merges with the per-event log. A lossless batch consumes the stream exactly
like the same scalar transfers laid end to end; under iid loss one
geometric draw covers every chunk of the batch, so ``compat=True`` keeps
the scalar call order instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Fleet-level link distribution + round deadline.

    Attributes:
      mean_bandwidth_bytes_s: median link bandwidth, bytes/second (≈ a
        1 MB/s uplink, the regime of limited capacity the paper targets).
      bandwidth_sigma: σ of the log-normal bandwidth draw (0 → homogeneous).
      base_latency_s: mean one-way link latency.
      latency_jitter_s: per-transfer uniform jitter in [0, jitter).
      deadline_s: sync round deadline; a client whose download + compute +
        upload exceeds it is dropped as a straggler (0 or inf → never).
      compute_speed_sigma: σ of the log-normal per-client compute speed.
      server_bandwidth_bytes_s: server NIC capacity shared by simultaneous
        transfers (0 or inf → no shared bottleneck).
      loss_rate: per-chunk Bernoulli loss probability (``loss_model="iid"``).
      chunk_bytes: loss granularity.
      retransmit_timeout_s: wait before the first retransmission of a lost
        chunk; each further loss of it backs off by ``retransmit_backoff``×.
      retransmit_backoff: exponential backoff factor (≥ 1).
      loss_model: "iid" or "gilbert_elliott" (the ``ge_*`` knobs).
      ge_p_good_bad / ge_p_bad_good: state hop probabilities per chunk.
      ge_loss_good / ge_loss_bad: chunk loss probability in each state.
    """

    mean_bandwidth_bytes_s: float = 1e6
    bandwidth_sigma: float = 0.5
    base_latency_s: float = 0.05
    latency_jitter_s: float = 0.01
    deadline_s: float = float("inf")
    compute_speed_sigma: float = 0.3
    server_bandwidth_bytes_s: float = float("inf")
    loss_rate: float = 0.0
    chunk_bytes: int = 64 * 1024
    retransmit_timeout_s: float = 0.05
    retransmit_backoff: float = 2.0
    loss_model: str = "iid"
    ge_p_good_bad: float = 0.05
    ge_p_bad_good: float = 0.5
    ge_loss_good: float = 0.0
    ge_loss_bad: float = 0.5


@dataclasses.dataclass(frozen=True)
class ClientLink:
    """One client's drawn link and device characteristics."""

    client_id: int
    bandwidth_bytes_s: float
    latency_s: float
    compute_speed: float  # multiplier on nominal examples/sec

    def transfer_time(self, nbytes: int, jitter: float = 0.0) -> float:
        return self.latency_s + jitter + nbytes / self.bandwidth_bytes_s


@dataclasses.dataclass
class TransferEvent:
    """One wire transfer: ``nbytes`` of goodput, plus ``retrans_bytes`` of
    retransmissions (``retries`` chunks), all inside ``seconds``."""

    client_id: int
    direction: str  # "down" | "up"
    nbytes: int
    seconds: float
    retrans_bytes: int = 0
    retries: int = 0


def _fair_share_completion(
    starts: list[float], nbytes: list[int], caps: list[float], total_cap: float
) -> list[float]:
    """Fluid processor-sharing model: absolute completion time of each flow.

    Flow i becomes active at ``starts[i]`` with ``nbytes[i]`` to move, its
    rate capped by ``caps[i]``; active flows share ``total_cap`` max-min
    fairly (water-filling). With ``total_cap`` = inf every flow runs at its
    own cap."""
    n = len(starts)
    remaining = [float(b) for b in nbytes]
    done = [0.0] * n
    finished = [False] * n
    t = 0.0
    while not all(finished):
        active = [i for i in range(n) if not finished[i] and starts[i] <= t]
        if not active:
            t = min(s for i, s in enumerate(starts) if not finished[i] and s > t)
            continue
        rates = {}
        pool = total_cap
        todo = list(active)
        while todo:
            share = pool / len(todo) if pool != float("inf") else float("inf")
            capped = [i for i in todo if caps[i] <= share]
            if not capped:
                for i in todo:
                    rates[i] = share
                todo = []
            else:
                for i in capped:
                    rates[i] = caps[i]
                    if pool != float("inf"):
                        pool -= caps[i]
                todo = [i for i in todo if i not in capped]
        dt_complete = min(
            remaining[i] / rates[i] if rates[i] > 0 else float("inf")
            for i in active
        )
        upcoming = [s for i, s in enumerate(starts) if not finished[i] and s > t]
        dt = min(dt_complete, min(upcoming) - t) if upcoming else dt_complete
        for i in active:
            remaining[i] -= rates[i] * dt
            if remaining[i] <= 1e-9:
                finished[i] = True
                done[i] = t + dt
        t += dt
    return done


class _LinkView:
    """Sequence view of the channel's per-client arrays as ``ClientLink``s;
    assigning a ``ClientLink`` stores back into the arrays."""

    def __init__(self, channel: "Channel"):
        self._ch = channel

    def __len__(self) -> int:
        return self._ch.n_clients

    def __getitem__(self, k: int) -> ClientLink:
        ch = self._ch
        return ClientLink(int(k), float(ch._bw[k]), float(ch._lat[k]),
                          float(ch._speed[k]))

    def __setitem__(self, k: int, link: ClientLink) -> None:
        ch = self._ch
        ch._bw[k] = link.bandwidth_bytes_s
        ch._lat[k] = link.latency_s
        ch._speed[k] = link.compute_speed

    def __iter__(self):
        return (self[k] for k in range(len(self)))


class Channel:
    """Holds the fleet's links and meters transfers through them."""

    def __init__(self, cfg: ChannelConfig, n_clients: int, seed: int = 0):
        self.cfg = cfg
        self.n_clients = int(n_clients)
        rng = np.random.default_rng(seed)
        self._bw = cfg.mean_bandwidth_bytes_s * rng.lognormal(
            mean=0.0, sigma=cfg.bandwidth_sigma, size=n_clients
        )
        self._lat = np.maximum(
            rng.normal(cfg.base_latency_s, cfg.base_latency_s * 0.2, size=n_clients),
            1e-4,
        )
        self._speed = rng.lognormal(
            mean=0.0, sigma=cfg.compute_speed_sigma, size=n_clients
        )
        self.links = _LinkView(self)
        self._rng = rng
        self.log: list[TransferEvent] = []
        # the batch ledger of ``transfer_batch``: counters and one seconds
        # array per batch instead of one TransferEvent per client
        self._batch_secs: list[np.ndarray] = []
        self._batch_bytes = 0
        self._batch_retrans = 0
        self._batch_retries = 0
        # in-flight (data_start, data_end) windows per direction, for the
        # overlap count of ``transfer_timed``; filled only under a NIC cap
        self._inflight: dict[str, list[tuple[float, float]]] = {}

    # -- loss / retransmission --------------------------------------------

    def _chunk_sizes(self, nbytes: int) -> np.ndarray:
        chunk = max(1, int(self.cfg.chunk_bytes))
        n_chunks = (nbytes + chunk - 1) // chunk
        sizes = np.full(n_chunks, chunk, dtype=np.int64)
        sizes[-1] = nbytes - chunk * (n_chunks - 1)
        return sizes

    def _penalty_from_extra(
        self, extra: np.ndarray, sizes: np.ndarray
    ) -> tuple[int, float, int]:
        """Per-chunk retransmission counts → (retrans_bytes, timeout delay,
        retries); a chunk lost ``e`` times waits t0·(b^e − 1)/(b − 1)."""
        retrans_bytes = int(np.sum(extra * sizes))
        retries = int(extra.sum())
        if retries == 0:
            return 0, 0.0, 0
        t0, b = self.cfg.retransmit_timeout_s, self.cfg.retransmit_backoff
        if b == 1.0:
            delay = t0 * retries
        else:
            delay = float(t0 * np.sum((b ** extra[extra > 0] - 1.0) / (b - 1.0)))
        return retrans_bytes, delay, retries

    def _ge_loss_penalty(self, nbytes: int) -> tuple[int, float, int]:
        """Gilbert–Elliott penalty: the good/bad chain steps once per chunk
        from its stationary start; each chunk needs a geometric number of
        transmissions at its state's loss rate. Draws nothing when both
        state loss rates are 0."""
        cfg = self.cfg
        pg, pb = cfg.ge_loss_good, cfg.ge_loss_bad
        if (pg <= 0.0 and pb <= 0.0) or nbytes == 0:
            return 0, 0.0, 0
        for name, v in (("ge_loss_good", pg), ("ge_loss_bad", pb)):
            if not 0.0 <= v < 1.0:
                raise ValueError(f"{name} must be in [0, 1), got {v}")
        gb, bg = cfg.ge_p_good_bad, cfg.ge_p_bad_good
        for name, v in (("ge_p_good_bad", gb), ("ge_p_bad_good", bg)):
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        sizes = self._chunk_sizes(nbytes)
        n_chunks = len(sizes)
        pi_bad = gb / (gb + bg) if gb + bg > 0 else 0.0
        bad = bool(self._rng.random() < pi_bad)
        steps = self._rng.random(size=n_chunks)
        extra = np.zeros(n_chunks, dtype=np.int64)
        for i in range(n_chunks):
            p = pb if bad else pg
            if p > 0.0:
                extra[i] = self._rng.geometric(1.0 - p) - 1
            bad = (steps[i] >= bg) if bad else (steps[i] < gb)
        return self._penalty_from_extra(extra, sizes)

    def _loss_penalty(self, nbytes: int) -> tuple[int, float, int]:
        """(retrans_bytes, timeout_delay_s, retries) for one transfer; draws
        nothing when loss is off."""
        model = self.cfg.loss_model
        if model == "gilbert_elliott":
            return self._ge_loss_penalty(nbytes)
        if model != "iid":
            raise ValueError(
                f"loss_model must be 'iid' or 'gilbert_elliott', got {model!r}")
        p = self.cfg.loss_rate
        if p <= 0.0 or nbytes == 0:
            return 0, 0.0, 0
        if not p < 1.0:
            raise ValueError(f"loss_rate must be < 1, got {p}")
        sizes = self._chunk_sizes(nbytes)
        tx = self._rng.geometric(1.0 - p, size=len(sizes))
        return self._penalty_from_extra(tx - 1, sizes)

    # -- transfers ---------------------------------------------------------

    def transfer(self, client_id: int, nbytes: int, direction: str) -> float:
        """Seconds to move ``nbytes`` over this client's link (logged)."""
        jitter = float(self._rng.uniform(0.0, self.cfg.latency_jitter_s))
        retrans, delay, retries = self._loss_penalty(nbytes)
        dt = self.links[client_id].transfer_time(nbytes + retrans, jitter) + delay
        self.log.append(
            TransferEvent(client_id, direction, nbytes, dt, retrans, retries)
        )
        return dt

    def _loss_penalty_batch(
        self, nbytes: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``_loss_penalty`` over a batch of transfers, as (retrans_bytes,
        delay_s, retries) arrays. iid: ONE geometric draw covers every chunk
        of every transfer (the values per-transfer draws laid end to end
        would give), segment-summed back per transfer. Gilbert–Elliott: the
        scalar penalties in order (each chain is its own). Draws nothing
        when loss is off."""
        n = len(nbytes)
        zeros = np.zeros(n, dtype=np.int64)
        if self.cfg.loss_model == "gilbert_elliott":
            if self.cfg.ge_loss_good <= 0.0 and self.cfg.ge_loss_bad <= 0.0:
                return zeros, np.zeros(n), zeros
            pens = [self._ge_loss_penalty(int(b)) for b in np.asarray(nbytes)]
            return (np.array([p[0] for p in pens], dtype=np.int64),
                    np.array([p[1] for p in pens]),
                    np.array([p[2] for p in pens], dtype=np.int64))
        if self.cfg.loss_model != "iid":
            raise ValueError("loss_model must be 'iid' or 'gilbert_elliott', "
                             f"got {self.cfg.loss_model!r}")
        p = self.cfg.loss_rate
        if p <= 0.0 or n == 0:
            return zeros, np.zeros(n), zeros
        if not p < 1.0:
            raise ValueError(f"loss_rate must be < 1, got {p}")
        chunk = max(1, int(self.cfg.chunk_bytes))
        nb = np.asarray(nbytes, dtype=np.int64)
        n_chunks = (nb + chunk - 1) // chunk          # 0 chunks for 0 bytes
        total = int(n_chunks.sum())
        if total == 0:
            return zeros, np.zeros(n), zeros
        extra = self._rng.geometric(1.0 - p, size=total) - 1
        sizes = np.full(total, chunk, dtype=np.int64)
        ends = np.cumsum(n_chunks)
        starts = ends - n_chunks
        nz = n_chunks > 0
        sizes[ends[nz] - 1] = nb[nz] - chunk * (n_chunks[nz] - 1)
        csum_b = np.concatenate([[0], np.cumsum(extra * sizes)])
        retrans = csum_b[ends] - csum_b[starts]
        csum_r = np.concatenate([[0], np.cumsum(extra)])
        retries = csum_r[ends] - csum_r[starts]
        t0, b = self.cfg.retransmit_timeout_s, self.cfg.retransmit_backoff
        if b == 1.0:
            delay = t0 * retries.astype(np.float64)
        else:
            term = np.where(extra > 0, (b ** extra - 1.0) / (b - 1.0), 0.0)
            csum_d = np.concatenate([[0.0], np.cumsum(term)])
            delay = t0 * (csum_d[ends] - csum_d[starts])
        return retrans, delay, retries

    def transfer_batch(
        self, client_ids: np.ndarray, nbytes: np.ndarray, direction: str,
        *, share_nic: bool = False, compat: bool = False,
    ) -> np.ndarray:
        """Seconds for a fleet-scale batch of per-link transfers.

        One uniform jitter vector and one loss fold per batch, one
        closed-form seconds vector, metered in the batch ledger. Lossless,
        the jitter draw equals ``len(client_ids)`` scalar ``transfer``
        calls; under loss the geometric draw is folded once per batch, so
        ``compat=True`` runs the scalar ``transfer`` calls in order instead
        (logged per event). ``share_nic=True`` gives every flow of the
        batch min(link, NIC / batch): the flows are simultaneous, and this
        closed form stands in for ``transfer_concurrent``'s water-filling.
        """
        ids = np.asarray(client_ids, dtype=np.int64)
        nb = np.broadcast_to(np.asarray(nbytes, dtype=np.int64), ids.shape)
        if compat:
            return np.array([self.transfer(int(k), int(b), direction)
                             for k, b in zip(ids, nb)])
        jitter = self._rng.uniform(0.0, self.cfg.latency_jitter_s, size=ids.size)
        retrans, delay, retries = self._loss_penalty_batch(nb)
        wire = nb + retrans
        rate = self._bw[ids]
        nic = self.cfg.server_bandwidth_bytes_s
        if share_nic and 0 < nic < float("inf") and ids.size:
            rate = np.minimum(rate, nic / ids.size)
        secs = self._lat[ids] + jitter + wire / rate + delay
        self._batch_secs.append(secs)
        self._batch_bytes += int(nb.sum())
        self._batch_retrans += int(retrans.sum())
        self._batch_retries += int(retries.sum())
        return secs

    def compute_time_batch(
        self, client_ids: np.ndarray, n_examples: np.ndarray,
        nominal_examples_per_s: float = 5000.0,
    ) -> np.ndarray:
        """``compute_time`` over a batch of clients (the same expression)."""
        ids = np.asarray(client_ids, dtype=np.int64)
        return np.asarray(n_examples) / (nominal_examples_per_s * self._speed[ids])

    def transfer_concurrent(
        self, client_ids: list[int], nbytes: list[int], direction: str
    ) -> list[float]:
        """Seconds for SIMULTANEOUS transfers contending for the server NIC:
        each flow starts after its latency (+ jitter), then the data phases
        share ``server_bandwidth_bytes_s`` max-min fairly, each capped by its
        link; lost chunks re-enter the pipe and their timeouts extend the
        flow. Logged and returned in ``client_ids`` order."""
        jitters = [
            float(self._rng.uniform(0.0, self.cfg.latency_jitter_s))
            for _ in client_ids
        ]
        penalties = [self._loss_penalty(b) for b in nbytes]
        starts = [self.links[k].latency_s + j for k, j in zip(client_ids, jitters)]
        caps = [self.links[k].bandwidth_bytes_s for k in client_ids]
        wire = [b + pen[0] for b, pen in zip(nbytes, penalties)]
        nic = self.cfg.server_bandwidth_bytes_s
        done = _fair_share_completion(
            starts, wire, caps, nic if nic > 0 else float("inf")
        )
        done = [d + pen[1] for d, pen in zip(done, penalties)]
        for k, b, dt, pen in zip(client_ids, nbytes, done, penalties):
            self.log.append(TransferEvent(k, direction, b, dt, pen[0], pen[2]))
        return done

    def transfer_timed(self, client_id: int, nbytes: int, start_s: float,
                       direction: str, *, now_s: float | None = None) -> float:
        """One transfer STARTING at absolute simulated time ``start_s``,
        contending for the server NIC with the other ``transfer_timed``
        flows in flight in the same direction (async uploads).

        The flow's rate is min(link, NIC / (1 + overlapping flows)),
        iterated twice toward a fixed point on the overlap count. Flows
        that ended before ``now_s`` (the caller's non-decreasing event
        clock; ``start_s`` plus latency and jitter by default) are pruned.
        On an uncapped NIC it is the same float expression as ``transfer``.
        Returns the duration from ``start_s`` to completion (logged).
        """
        jitter = float(self._rng.uniform(0.0, self.cfg.latency_jitter_s))
        retrans, delay, retries = self._loss_penalty(nbytes)
        link = self.links[client_id]
        wire = nbytes + retrans
        nic = self.cfg.server_bandwidth_bytes_s
        if nic <= 0 or nic == float("inf"):
            dt = link.transfer_time(wire, jitter) + delay
            self.log.append(TransferEvent(client_id, direction, nbytes, dt, retrans, retries))
            return dt
        data_start = start_s + link.latency_s + jitter
        flows = self._inflight.setdefault(direction, [])
        prune_t = now_s if now_s is not None else data_start
        flows[:] = [f for f in flows if f[1] > prune_t]
        dur = wire / min(link.bandwidth_bytes_s, nic)
        for _ in range(2):
            end = data_start + dur
            overlap = sum(1 for s, e in flows if s < end and e > data_start)
            rate = min(link.bandwidth_bytes_s, nic / (1 + overlap))
            dur = wire / rate
        flows.append((data_start, data_start + dur))
        dt = (data_start + dur + delay) - start_s
        self.log.append(TransferEvent(client_id, direction, nbytes, dt, retrans, retries))
        return dt

    def compute_time(self, client_id: int, n_examples: int,
                     nominal_examples_per_s: float = 5000.0) -> float:
        """Local-training wall time for ``n_examples`` processed examples."""
        return n_examples / (nominal_examples_per_s * self.links[client_id].compute_speed)

    def summary(self) -> dict:
        """Transfer statistics over the per-event log and the batch ledger:
        ``total_bytes`` is goodput, retransmission overhead is reported
        apart."""
        n_batch = sum(a.size for a in self._batch_secs)
        if not self.log and n_batch == 0:
            return {"n_transfers": 0, "total_bytes": 0, "total_seconds": 0.0,
                    "mean_seconds": 0.0, "p95_seconds": 0.0,
                    "retrans_bytes": 0, "retries": 0, "goodput_fraction": 1.0}
        parts = [np.array([e.seconds for e in self.log])] if self.log else []
        secs = np.concatenate(parts + self._batch_secs)
        goodput = int(sum(e.nbytes for e in self.log)) + self._batch_bytes
        retrans = int(sum(e.retrans_bytes for e in self.log)) + self._batch_retrans
        return {
            "n_transfers": len(self.log) + n_batch,
            "total_bytes": goodput,
            "total_seconds": float(secs.sum()),
            "mean_seconds": float(secs.mean()),
            "p95_seconds": float(np.percentile(secs, 95)),
            "retrans_bytes": retrans,
            "retries": int(sum(e.retries for e in self.log)) + self._batch_retries,
            "goodput_fraction": goodput / max(goodput + retrans, 1),
        }
