"""Vectorized cohort simulation for million-client fleets (port of
``repro.fed.fleet``).

``fed/simulation.py`` and ``fed/async_server.py`` simulate the protocol
client by client: a Python object, a scalar rng draw and a heap tuple per
client, with real local SGD. ``run_fleet`` runs the SAME protocol (wire
format, channel, availability, edge tier, defense, controller, byte ledger)
at fleet scale, with the per-client work batched into numpy arrays:

  - **Selection** — the availability masks are array ops and the
    participant draw is ``draw_participants`` (one ``rng.choice`` a round).
  - **Channel** — ``Channel.transfer_batch`` folds the rng once per batch;
    ``FleetConfig.compat`` keeps the scalar call order instead.
  - **Client updates** — no SGD: clients ship one of ``update_pool``
    pre-encoded wire blobs (client k ships ``pool[k % P]``). Clients that
    share a blob form a COHORT, and the server folds ONE weighted add per
    (edge, cohort) at the cohort's summed weight (exactly Σ w_k·θ_k, the
    blobs being byte-identical) while the ledger books every client's
    bytes. A 10⁶-client round costs O(edges × pool) kernel launches and
    O(participants) array arithmetic.
  - **Async arrivals** — ``EventHeap``, an array-backed binary min-heap
    keyed (time, seq), with a bulk ``push_many`` for batch dispatches; pops
    come in ``heapq``'s (time, seq) order. Refills happen in fold-sized
    batches (the cohort approximation of the per-arrival refill).

The fleet's state is a handful of ``n_clients``-long numpy arrays (links,
masks, attackers) plus the aggregators' chunk-bounded staging, and, async,
one heap entry per client in flight. The pool encodes, the gate's per-payload checks and the
folds run on ``run_fleet``'s device (``cuda`` unless the caller asks for
the CPU); the draws stay numpy on the host, from ``np.random.default_rng``
streams keyed on ``FedConfig.seed`` in the reference's order, so a seeded
run reproduces the reference's participants, drops, times and bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.comm.channel import Channel
from repro_torch.comm.wire import encode_update
from repro_torch.core import fttq as fttq_mod
from repro_torch.core.compression import CodecSpec, compress_pytree
from repro_torch.core.tfedavg import client_update_payload
from repro_torch.device import resolve_device
from repro_torch.fed.aggregator import Aggregator
from repro_torch.fed.attackers import attacker_ids, poison_blob
from repro_torch.fed.availability import draw_participants, make_availability
from repro_torch.fed.controller import FleetCohortController
from repro_torch.fed.defense import UpdateGate
from repro_torch.fed.hierarchy import EdgeTier, edges_of
from repro_torch.fed.simulation import FedConfig, _rebuild, broadcast_blob, resolve_rule
from repro_torch.tree import tree_leaves, tree_map

Pytree = Any


class EventHeap:
    """Array-backed binary min-heap keyed by (time, seq)."""

    def __init__(self, capacity: int = 1024):
        cap = max(int(capacity), 1)
        self._time = np.empty(cap, dtype=np.float64)
        self._seq = np.empty(cap, dtype=np.int64)
        self._slot = np.empty(cap, dtype=np.int64)
        self._n = 0
        self._payload: list[Any] = []
        self._free: list[int] = []
        self._next_seq = 0

    def __len__(self) -> int:
        return self._n

    # -- internals ---------------------------------------------------------

    def _grow(self, need: int) -> None:
        cap = self._time.size
        if need <= cap:
            return
        new = max(need, 2 * cap)
        for name in ("_time", "_seq", "_slot"):
            arr = getattr(self, name)
            grown = np.empty(new, dtype=arr.dtype)
            grown[: self._n] = arr[: self._n]
            setattr(self, name, grown)

    def _less(self, i: int, j: int) -> bool:
        if self._time[i] != self._time[j]:
            return bool(self._time[i] < self._time[j])
        return bool(self._seq[i] < self._seq[j])

    def _swap(self, i: int, j: int) -> None:
        for arr in (self._time, self._seq, self._slot):
            arr[i], arr[j] = arr[j], arr[i]

    def _sift_up(self, i: int) -> None:
        while i > 0:
            parent = (i - 1) // 2
            if not self._less(i, parent):
                break
            self._swap(i, parent)
            i = parent

    def _sift_down(self, i: int) -> None:
        n = self._n
        while True:
            left = 2 * i + 1
            if left >= n:
                return
            child = left
            right = left + 1
            if right < n and self._less(right, left):
                child = right
            if not self._less(child, i):
                return
            self._swap(i, child)
            i = child

    def _store(self, payload: Any) -> int:
        if self._free:
            slot = self._free.pop()
            self._payload[slot] = payload
        else:
            slot = len(self._payload)
            self._payload.append(payload)
        return slot

    # -- api ---------------------------------------------------------------

    def push(self, t: float, payload: Any) -> int:
        """Insert one event; returns its (unique, monotonic) seq."""
        self._grow(self._n + 1)
        seq = self._next_seq
        self._next_seq += 1
        i = self._n
        self._time[i] = t
        self._seq[i] = seq
        self._slot[i] = self._store(payload)
        self._n += 1
        self._sift_up(i)
        return seq

    def push_many(self, times: np.ndarray, payloads: list[Any]) -> None:
        """Bulk insert: append the batch, then restore the heap with one
        lexsort on (time, seq) — a sorted array is a valid binary
        min-heap."""
        ts = np.asarray(times, dtype=np.float64)
        k = ts.size
        if k != len(payloads):
            raise ValueError(f"{k} times for {len(payloads)} payloads")
        if k == 0:
            return
        self._grow(self._n + k)
        n = self._n
        self._time[n:n + k] = ts
        self._seq[n:n + k] = np.arange(self._next_seq, self._next_seq + k, dtype=np.int64)
        self._next_seq += k
        self._slot[n:n + k] = [self._store(p) for p in payloads]
        self._n = n + k
        order = np.lexsort((self._seq[: self._n], self._time[: self._n]))
        for arr in (self._time, self._seq, self._slot):
            arr[: self._n] = arr[order]

    def peek_time(self) -> float:
        if self._n == 0:
            raise IndexError("peek on empty EventHeap")
        return float(self._time[0])

    def pop(self) -> tuple[float, int, Any]:
        """Remove and return the earliest event as (time, seq, payload)."""
        if self._n == 0:
            raise IndexError("pop from empty EventHeap")
        t = float(self._time[0])
        seq = int(self._seq[0])
        slot = int(self._slot[0])
        payload = self._payload[slot]
        self._payload[slot] = None
        self._free.append(slot)
        self._n -= 1
        if self._n:
            last = self._n
            for arr in (self._time, self._seq, self._slot):
                arr[0] = arr[last]
            self._sift_down(0)
        return t, seq, payload


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet-only knobs layered on top of ``FedConfig``.

    Attributes:
      update_pool: number of distinct pre-encoded client payloads (client k
        ships ``pool[k % update_pool]``; clients sharing one form a cohort).
      examples_per_client: uniform |D_k|, the aggregation weight and the
        compute-time workload of every client.
      compat: route transfers through the scalar channel calls in the
        per-client servers' order (bit-exact rng streams under loss; small
        fleets only: O(participants) Python calls), and fold one add per
        client in draw order.
      share_nic: give every flow of the broadcast batch min(link, NIC /
        batch) instead of the per-client servers' water-filling.
      heap_capacity: initial ``EventHeap`` allocation (it grows as needed).
    """

    update_pool: int = 8
    examples_per_client: int = 50
    compat: bool = False
    share_nic: bool = True
    heap_capacity: int = 1024


@dataclasses.dataclass
class FleetResult:
    """What a fleet run reports (the communication and aggregation view)."""

    rounds_run: int
    participants_per_round: list
    dropped_per_round: list
    round_times: list
    upload_bytes: int
    download_bytes: int
    final_update: Any
    telemetry: dict

    @property
    def total_time_s(self) -> float:
        return float(sum(self.round_times))


def _payload_pool(params: Pytree, cfg: FedConfig, fleet: FleetConfig, device: torch.device,
                  spec: CodecSpec | None = None) -> tuple[list[bytes], np.ndarray]:
    """``update_pool`` distinct client payloads, encoded once.

    Slot j is the template plus seeded noise, drawn in numpy on the host
    leaf by leaf in flatten order exactly as the reference draws it, moved
    to ``device`` and pushed through the real upstream encode (FTTQ →
    fused quantize→pack, one launch a slot → wire). A non-ternary ``spec``
    (a controller rung) encodes the same perturbed trees through its codec:
    the stream restarts from the seed on every call, so slot j of every
    rung's pool holds the same update."""
    rng = np.random.default_rng(cfg.seed + 17)
    host = [leaf.detach().cpu().numpy() for leaf in tree_leaves(params)]
    pool: list[bytes] = []
    for _ in range(max(1, fleet.update_pool)):
        perturbed = [torch.from_numpy(np.asarray(   # a 0-d leaf sums to a numpy scalar
            leaf + 0.1 * rng.standard_normal(leaf.shape).astype(np.float32))).to(device)
            for leaf in host]
        tree = _rebuild(params, perturbed)
        if spec is not None and spec.kind != "ternary":
            tree, _ = compress_pytree(tree, spec)
        elif cfg.algorithm == "tfedavg":
            wq = fttq_mod.init_wq_tree(tree, cfg.fttq)
            tree = client_update_payload(tree, wq, cfg.fttq, fused=cfg.fused_encode)
        pool.append(encode_update(tree))
    return pool, np.array([len(b) for b in pool], dtype=np.int64)


def _pool_indices(ids: np.ndarray, n_honest: int, atk: np.ndarray) -> np.ndarray:
    """Pool slot per client: honest client k ships ``pool[k % P]``, an
    attacker the poisoned twin at ``P + (k % P)``, so attacker cohorts stay
    byte-identical cohorts (the poison keys on the pool index, not on the
    client id)."""
    return ids % n_honest + n_honest * atk[ids]


def _draw_or_wait(avail, t_now: float, n_sel: int, n_clients: int,
                  rng: np.random.Generator) -> tuple[np.ndarray, float]:
    """The participant draw, moving time on while nobody is online."""
    wait = 0.0
    ids = draw_participants(avail, t_now, n_sel, n_clients, rng)
    while ids.size == 0:
        t_next = avail.next_change(t_now + wait)
        if not np.isfinite(t_next):
            raise RuntimeError("no client is ever available")
        wait = t_next - t_now
        ids = draw_participants(avail, t_next, n_sel, n_clients, rng)
    return ids, wait


def _ingest_grouped(surv: np.ndarray, pool_idx: np.ndarray, weights: np.ndarray,
                    pool: list[bytes], cfg: FedConfig, tier: EdgeTier | None,
                    agg: Aggregator | None, *, staleness: np.ndarray | None = None,
                    compat: bool = False, gate: UpdateGate | None = None) -> tuple[int, int]:
    """Cohort-grouped ingest: one weighted add per (edge, payload) group,
    in ascending key order, at the group's float64 weight sum. ``compat``
    keeps one add per client in draw order.

    A ``gate`` checks each distinct payload once per call (its counters
    count cohorts); every member of a refused cohort is quarantined and
    booked on the tier or aggregator ledger. Returns
    ``(quarantined_clients, quarantined_bytes)``."""
    P = len(pool)
    stale = staleness if staleness is not None else np.zeros(surv.size)
    q_clients = q_bytes = 0
    if compat:
        for k, j, w, s in zip(surv, pool_idx, weights, stale):
            blob = pool[int(j)]
            if gate is not None and not gate.check(blob).ok:
                q_clients += 1
                q_bytes += len(blob)
                if tier is not None:
                    tier.note_quarantined(len(blob))
                elif agg is not None:
                    agg.note_quarantined(len(blob))
                continue
            if tier is not None:
                tier.add(int(k), blob, float(w), staleness=float(s))
            else:
                agg.add(blob, weight=float(w))
        return q_clients, q_bytes
    if gate is not None and surv.size:
        ok_by_j = {int(j): gate.check(pool[int(j)]).ok for j in np.unique(pool_idx)}
        okm = np.array([ok_by_j[int(j)] for j in pool_idx], dtype=bool)
        if not okm.all():
            bad = pool_idx[~okm]
            q_clients = int(bad.size)
            q_bytes = int(sum(len(pool[int(j)]) for j in bad))
            if tier is not None:
                tier.note_quarantined(q_bytes, updates=q_clients)
            elif agg is not None:
                for j in bad:
                    agg.note_quarantined(len(pool[int(j)]))
            surv, pool_idx, weights, stale = surv[okm], pool_idx[okm], weights[okm], stale[okm]
    if surv.size == 0:
        return q_clients, q_bytes
    key = (edges_of(surv, cfg.n_clients, cfg.hierarchy) * P + pool_idx if tier is not None
           else pool_idx)
    uniq, inv = np.unique(key, return_inverse=True)
    wsum = np.bincount(inv, weights=weights, minlength=uniq.size)
    count = np.bincount(inv, minlength=uniq.size)
    ssum = np.bincount(inv, weights=stale, minlength=uniq.size)
    for g, ke in enumerate(uniq):
        if tier is not None:
            tier.add_cohort(int(ke // P), pool[int(ke % P)], weight=float(wsum[g]),
                            n_clients=int(count[g]), staleness_sum=float(ssum[g]))
        else:
            agg.add(pool[int(ke)], weight=float(wsum[g]))
    return q_clients, q_bytes


def run_fleet(params: Pytree, cfg: FedConfig, fleet: FleetConfig | None = None, *,
              device: str | torch.device = "cuda") -> FleetResult:
    """Run ``cfg.rounds`` fleet-scale rounds (sync) or folds (async) on
    ``device``.

    Dispatches on ``cfg.mode`` like ``run_federated``; the edge tier,
    defense, attackers and cohort controller engage behind their
    ``FedConfig`` fields as in the per-client servers. The tier's byte
    ledger is asserted balanced before returning.
    """
    fleet = fleet or FleetConfig()
    if cfg.mode == "async":
        return _run_fleet_async(params, cfg, fleet, resolve_device(device))
    if cfg.mode != "sync":
        raise ValueError(f"unknown federated mode {cfg.mode!r}")
    return _run_fleet_sync(params, cfg, fleet, resolve_device(device))


def _twinned(pool: list[bytes], cfg: FedConfig) -> tuple[list[bytes], np.ndarray]:
    """The pool followed by its poisoned twins (slot P + j twins slot j)."""
    out = pool + [poison_blob(b, cfg.attack, client_id=j) for j, b in enumerate(pool)]
    return out, np.array([len(b) for b in out], dtype=np.int64)


def _setup(params, cfg: FedConfig, fleet: FleetConfig, dev: torch.device):
    params = tree_map(lambda t: t.to(dev), params)
    rng = np.random.default_rng(cfg.seed)
    channel = Channel(cfg.channel, cfg.n_clients, seed=cfg.seed + 1)
    avail = make_availability(cfg.availability, cfg.n_clients, seed=cfg.seed)
    pool, sizes = _payload_pool(params, cfg, fleet, dev)
    # the cohort controller ships each round from one rung's pool, encoded
    # once per rung; off, the run is the single-pool fleet byte for byte
    fctrl = None
    pools: dict[str, tuple[list, np.ndarray]] = {}
    if cfg.controller is not None and cfg.controller.enabled:
        fctrl = FleetCohortController(cfg.controller)
        rung = cfg.controller.aggressive_rung
        spec = CodecSpec(kind=rung, residual=cfg.controller.residual_codec, fttq=cfg.fttq,
                         topk_fraction=cfg.controller.topk_fraction,
                         fused_encode=cfg.fused_encode)
        pools["ternary"] = (pool, sizes)
        pools[rung] = _payload_pool(params, cfg, fleet, dev, spec=spec)
    atk = np.zeros(cfg.n_clients, dtype=bool)
    if cfg.attack is not None and cfg.attack.n_attackers > 0:
        atk[np.fromiter(attacker_ids(cfg.attack, cfg.n_clients), dtype=np.int64)] = True
        pool, sizes = _twinned(pool, cfg)
        for rung, (rp, _) in list(pools.items()):
            pools[rung] = _twinned(rp, cfg)
    gate = (UpdateGate(cfg.defense, params)
            if cfg.defense is not None and cfg.defense.enabled else None)
    bcast = broadcast_blob(params, cfg)        # once a run: the fleet never re-broadcasts
    rule, trim_frac = resolve_rule(cfg)
    if fctrl is not None and rule != "mean":
        raise ValueError("adaptive compression requires aggregation rule 'mean': "
                         "mixed-codec rounds have no robust-vote decomposition")
    tier = (EdgeTier(cfg.hierarchy, cfg.fttq, cfg.n_clients, fused_encode=cfg.fused_encode,
                     device=dev, rule=rule, trim_frac=trim_frac)
            if cfg.hierarchy.enabled else None)
    # one long-lived aggregator, closed per round with finalize(reset=True)
    agg = (Aggregator(chunk_c=cfg.agg_chunk_c, device=dev, rule=rule, trim_frac=trim_frac)
           if tier is None else None)
    return rng, channel, avail, pool, sizes, bcast, tier, agg, atk, gate, fctrl, pools


def _defense_extra(gate, tier, client_up_bytes: int, q_clients: int, q_bytes: int):
    """``telemetry["defense"]`` with the client-hop ledger: shipped ==
    ingested + quarantined, the ingested side being the tier's own ingest
    ledger under a tier."""
    if gate is None:
        return None
    dt = gate.telemetry()
    dt["quarantined_clients"] = q_clients
    dt["quarantined_client_bytes"] = q_bytes
    ingested = (int(tier.ingest_bytes.sum()) if tier is not None
                else client_up_bytes - q_bytes)
    dt["ledger_balanced"] = client_up_bytes == ingested + q_bytes
    return {"defense": dt}


def _telemetry(channel: Channel, tier, cfg: FedConfig, *, extra=None) -> dict:
    summary = channel.summary()
    out = {
        "availability": cfg.availability.kind,
        "retrans_bytes": summary.get("retrans_bytes", 0),
        "retries": summary.get("retries", 0),
        "goodput_fraction": summary.get("goodput_fraction", 1.0),
        "transfer_summary": summary,
    }
    if tier is not None:
        hier = tier.telemetry()
        if not hier["ledger_balanced"]:
            raise AssertionError(
                "hierarchy byte ledger out of balance: edges shipped "
                f"{hier['edge_to_root_bytes']} B, root ingested {hier['root_ingest_bytes']} B")
        out["hierarchy"] = hier
    if extra:
        out.update(extra)
    return out


def _run_fleet_sync(params, cfg: FedConfig, fleet: FleetConfig,
                    dev: torch.device) -> FleetResult:
    (rng, channel, avail, pool, sizes, bcast, tier, agg, atk, gate,
     fctrl, pools) = _setup(params, cfg, fleet, dev)
    P = max(1, fleet.update_pool)     # honest pool size (twins live at P + j)
    deadline = cfg.channel.deadline_s if cfg.channel.deadline_s > 0 else float("inf")
    n_sel = max(int(np.ceil(cfg.participation * cfg.n_clients)), 1)
    w_k = float(fleet.examples_per_client)

    up_bytes = down_bytes = 0
    client_up_bytes = 0               # the client hop only (no edge→root bytes)
    q_clients_total = q_bytes_total = 0
    parts_hist, dropped_hist, round_times = [], [], []
    mean = None
    t_now = 0.0
    for _ in range(cfg.rounds):
        if fctrl is not None:
            pool, sizes = pools[fctrl.select()]
        ids, wait_s = _draw_or_wait(avail, t_now, n_sel, cfg.n_clients, rng)
        pool_idx = _pool_indices(ids, P, atk)
        down = channel.transfer_batch(ids, len(bcast), "down", share_nic=fleet.share_nic,
                                      compat=fleet.compat)
        comp = channel.compute_time_batch(ids, fleet.examples_per_client * cfg.local_epochs)
        up = channel.transfer_batch(ids, sizes[pool_idx], "up", compat=fleet.compat)
        if fctrl is not None:
            fctrl.observe_round(int(sizes[pool_idx].sum()), float(up.sum()))
        total = down + comp + up
        ok = total <= deadline
        if not ok.any():              # never lose a round: keep the fastest
            ok[np.argmin(total)] = True
        surv, sj = ids[ok], pool_idx[ok]
        n_dropped = int(ids.size - surv.size)

        down_bytes += len(bcast) * int(ids.size)
        up_bytes += int(sizes[sj].sum())
        client_up_bytes += int(sizes[sj].sum())
        q_upd, q_b = _ingest_grouped(surv, sj, np.full(surv.size, w_k), pool, cfg, tier, agg,
                                     compat=fleet.compat, gate=gate)
        q_clients_total += q_upd
        q_bytes_total += q_b
        if surv.size > q_upd:
            if tier is not None:
                mean, info = tier.fold()
                up_bytes += info["edge_to_root_bytes"]
            else:
                mean = agg.finalize(reset=True)
        # else every survivor was quarantined: the model holds this round

        last = float(total[ok].max())
        round_times.append(wait_s + (max(deadline, last) if n_dropped else last))
        t_now += round_times[-1]
        parts_hist.append(int(surv.size) - q_upd)
        dropped_hist.append(n_dropped)

    extra = _defense_extra(gate, tier, client_up_bytes, q_clients_total, q_bytes_total) or {}
    if fctrl is not None:
        extra["controller"] = fctrl.telemetry()
    return FleetResult(
        rounds_run=cfg.rounds, participants_per_round=parts_hist,
        dropped_per_round=dropped_hist, round_times=round_times, upload_bytes=up_bytes,
        download_bytes=down_bytes, final_update=mean,
        telemetry=_telemetry(channel, tier, cfg, extra=extra),
    )


def _run_fleet_async(params, cfg: FedConfig, fleet: FleetConfig,
                     dev: torch.device) -> FleetResult:
    (rng, channel, avail, pool, sizes, bcast, tier, agg, atk, gate,
     fctrl, pools) = _setup(params, cfg, fleet, dev)
    if fctrl is not None:
        # arrivals outlive rung switches, so the rung pools concatenate into
        # ONE pool: an event's payload index stays valid whatever later
        # dispatches select
        rung_offset: dict[str, int] = {}
        pool = []
        for rung, (rp, _) in pools.items():
            rung_offset[rung] = len(pool)
            pool = pool + rp
        sizes = np.array([len(b) for b in pool], dtype=np.int64)
    P = max(1, fleet.update_pool)     # honest pool size (twins live at P + j)
    n_conc = cfg.max_concurrency or max(int(np.ceil(cfg.participation * cfg.n_clients)), 1)
    n_conc = min(n_conc, cfg.n_clients)
    buffer_k = max(1, min(cfg.buffer_k, n_conc))
    max_stale = cfg.max_staleness if cfg.max_staleness > 0 else float("inf")
    w_k = float(fleet.examples_per_client)
    heap = EventHeap(capacity=max(fleet.heap_capacity, n_conc))

    version = 0
    up_bytes = down_bytes = 0
    client_up_bytes = 0
    q_clients_total = q_bytes_total = 0
    dropped = dropped_bytes = 0
    staleness_hist: list[int] = []
    fold_times, parts_hist = [], []
    mean = None

    def dispatch(ids: np.ndarray, t0: float) -> None:
        nonlocal down_bytes
        pool_idx = _pool_indices(ids, P, atk)
        if fctrl is not None:
            # the batch ships from the rung selected at dispatch time
            pool_idx = pool_idx + rung_offset[fctrl.select()]
        down = channel.transfer_batch(ids, len(bcast), "down", share_nic=fleet.share_nic,
                                      compat=fleet.compat)
        comp = channel.compute_time_batch(ids, fleet.examples_per_client * cfg.local_epochs)
        up = channel.transfer_batch(ids, sizes[pool_idx], "up", compat=fleet.compat)
        if fctrl is not None:
            fctrl.observe_round(int(sizes[pool_idx].sum()), float(up.sum()))
        down_bytes += len(bcast) * int(ids.size)
        heap.push_many(t0 + down + comp + up,
                       [(int(k), int(j), version) for k, j in zip(ids, pool_idx)])

    ids0, wait0 = _draw_or_wait(avail, 0.0, n_conc, cfg.n_clients, rng)
    dispatch(ids0, wait0)

    buf_k: list[int] = []
    buf_j: list[int] = []
    buf_w: list[float] = []
    buf_s: list[float] = []
    last_fold_t = 0.0
    while version < cfg.rounds:
        if len(heap) == 0:  # pragma: no cover - dispatch always refills
            raise RuntimeError("fleet starved: no in-flight clients")
        now, _seq, (k, j, born) = heap.pop()
        staleness = version - born
        staleness_hist.append(staleness)
        up_bytes += int(sizes[j])
        client_up_bytes += int(sizes[j])
        if staleness > max_stale and cfg.staleness_policy == "drop":
            dropped += 1
            dropped_bytes += int(sizes[j])
        else:
            w = w_k * (1.0 + staleness) ** (-cfg.staleness_exponent)
            if staleness > max_stale:     # "downweight": the excess discounts again
                w *= (1.0 + staleness - max_stale) ** (-cfg.staleness_exponent)
            buf_k.append(k)
            buf_j.append(j)
            buf_w.append(w)
            buf_s.append(float(staleness))

        if len(buf_k) >= buffer_k:
            q_upd, q_b = _ingest_grouped(
                np.asarray(buf_k), np.asarray(buf_j), np.asarray(buf_w), pool, cfg, tier, agg,
                staleness=np.asarray(buf_s), compat=fleet.compat, gate=gate)
            q_clients_total += q_upd
            q_bytes_total += q_b
            if len(buf_k) > q_upd:
                if tier is not None:
                    mean, info = tier.fold()
                    up_bytes += info["edge_to_root_bytes"]
                else:
                    mean = agg.finalize(reset=True)
            # else the whole buffer was quarantined: the fold still closes
            # (a poisoned fleet cannot stall the loop) and the model holds
            parts_hist.append(len(buf_k) - q_upd)
            buf_k, buf_j, buf_w, buf_s = [], [], [], []
            version += 1
            fold_times.append(now - last_fold_t)
            last_fold_t = now
            # the batch refill at the fold boundary: top the fleet back up
            if version < cfg.rounds:
                need = n_conc - len(heap)
                if need > 0:
                    ids, wait = _draw_or_wait(avail, now, need, cfg.n_clients, rng)
                    dispatch(ids, now + wait)

    extra = {
        "staleness_hist": (np.bincount(np.asarray(staleness_hist, dtype=np.int64)).tolist()
                           if staleness_hist else []),
        "dropped_updates": dropped,
        "dropped_update_bytes": dropped_bytes,
    }
    # staleness drops never reach the gate: the gated hop is the arrivals
    # net of them
    defense = _defense_extra(gate, tier, client_up_bytes - dropped_bytes, q_clients_total,
                             q_bytes_total)
    if defense:
        extra.update(defense)
    if fctrl is not None:
        extra["controller"] = fctrl.telemetry()
    return FleetResult(
        rounds_run=version, participants_per_round=parts_hist,
        dropped_per_round=[0] * version, round_times=fold_times, upload_bytes=up_bytes,
        download_bytes=down_bytes, final_update=mean,
        telemetry=_telemetry(channel, tier, cfg, extra=extra),
    )
