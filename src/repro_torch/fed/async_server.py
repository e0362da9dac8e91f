"""Event-driven buffered-asynchronous federated server, FedBuf-style (port
of ``repro.fed.async_server``).

The sync server (Algorithm 2) waits each round for its slowest survivor.
This one has no barrier:

  - ``max_concurrency`` clients (0 → ⌈λN⌉) are always in flight. Each
    downloads the current global model through ``comm.wire``, trains and
    uploads; its arrival time is download + compute + upload from
    ``comm.channel``, the upload through ``Channel.transfer_timed`` so
    simultaneous arrivals contend for a capped server NIC.
  - A refill draws one client ONLINE at dispatch time
    (``FedConfig.availability``); if none is, the availability clock moves
    to the next change while the event clock stays the NIC's prune horizon.
  - Arrivals pop from an ``EventHeap`` in simulated-time order (ties in
    push order). Every ``buffer_k`` accepted arrivals are one MIX.
  - An arrival that started from version v at global version V has
    staleness s = V − v and weight |D_k|·(1 + s)^(-α); the buffer mean
    moves the global by θ ← (1-η)·θ + η·Σ ŵ_i·θ_i.
  - ``max_staleness`` (0 = off) caps s: past it an update is dropped
    ("drop": its bytes were paid for and are booked as waste) or discounted
    again by (1 + s − cap)^(-α) ("downweight").
  - ``adaptive_buffer`` retunes K after each mix: an EWMA of inter-arrival
    gaps estimates the arrival rate and K ← clip(round(target / gap), 1,
    concurrency); a target of 0 locks it to the first mix's latency.

Arrivals stream into ONE long-lived ``fed.aggregator.Aggregator`` on the
run's device (the packed fan-in kernel; ``finalize(reset=True)`` per mix
keeps its segment table and pinned staging buffer across mixes), or into
the edge tier (``fed.hierarchy.EdgeTier``) when ``cfg.hierarchy`` is on.
``cfg.fused_aggregation=False`` buffers the blobs and folds them in list
order instead (``_weighted_mix``). The broadcast is encoded once per
model version. With a defense, the content gate vets each arrival before
staleness and weighting; seeded attackers poison their upload at dispatch.

Determinism: one ``np.random.default_rng(cfg.seed)`` gives the initial
draw, every refill draw and every client's batch permutations; the channel
(seed ``cfg.seed + 1``) draws per dispatch the download's jitter (and
loss), then the upload's. Draws come in the reference's order, so bytes,
arrival times, staleness, drops and the ``buffer_k`` trajectory equal the
reference's for the same seed.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.comm.channel import Channel
from repro_torch.comm.wire import decode_update
from repro_torch.data.federated import ClientDataset
from repro_torch.device import resolve_device
from repro_torch.fed.aggregator import Aggregator, _f32
from repro_torch.fed.attackers import attacker_ids, poison_blob
from repro_torch.fed.availability import draw_one, draw_participants, make_availability
from repro_torch.fed.defense import UpdateGate
from repro_torch.fed.fleet import EventHeap
from repro_torch.fed.hierarchy import EdgeTier
from repro_torch.fed.simulation import (
    FedConfig, FedResult, PhaseTimer, _check_ported, _make_local_steps, _phase, _rebuild,
    broadcast_blob, dequantize_tree, make_run_controller, receive_broadcast, resolve_rule,
    train_client,
)
from repro_torch.optim.optimizers import Optimizer
from repro_torch.tree import tree_leaves

Pytree = Any


def _mix(global_params: Pytree, mean: Pytree, eta: float) -> Pytree:
    """(1-η)·global + η·mean, leaf by leaf: each Python-float factor rounds
    to fp32 and multiplies in fp32, as a weakly typed scalar does in JAX."""
    g, m = tree_leaves(global_params), tree_leaves(mean)
    if len(g) != len(m):
        raise ValueError(f"the mean has {len(m)} leaves, the global model {len(g)}")
    keep, move = _f32(1.0 - eta), _f32(eta)
    return _rebuild(global_params, [keep * a + move * b for a, b in zip(g, m)])


def _weighted_mix(global_params: Pytree, buffered: list, eta: float,
                  agg: Aggregator | None, device: torch.device) -> Pytree:
    """θ ← (1-η)·θ + η·Σ ŵ_i·dequant(blob_i) over one mix's arrivals.

    On the fused path the arrivals already streamed into the long-lived
    ``agg`` as they landed, and ``finalize(reset=True)`` normalizes by Σ ŵ.
    Without it (``cfg.fused_aggregation=False``) ``buffered`` holds the
    (staleness-discounted weight, wire blob) pairs: the weights are
    normalized in float64, each rounds to fp32, and the dequantized models
    fold in list order, acc = m_0·ŵ_0, then acc + ŵ·m.
    """
    if agg is not None:
        mean = agg.finalize(reset=True)
    else:
        raw = np.array([w for w, _ in buffered], dtype=np.float64)
        wts = [_f32(w) for w in raw / raw.sum()]
        models = [tree_leaves(dequantize_tree(decode_update(b), device)) for _, b in buffered]
        folded = []
        for leaves in zip(*models):
            acc = leaves[0] * wts[0]
            for w, leaf in zip(wts[1:], leaves[1:]):
                acc = acc + w * leaf
            folded.append(acc)
        mean = _rebuild(global_params, folded)
    return _mix(global_params, mean, eta)


def run_federated_async(
    apply_fn: Callable,
    global_params: Pytree,
    clients: list[ClientDataset],
    cfg: FedConfig,
    optimizer: Optimizer,
    eval_fn: Callable[[Pytree], tuple[float, float]],
    *,
    eval_every: int = 10,
    device: str | torch.device = "cuda",
    timer: PhaseTimer | None = None,
) -> FedResult:
    """Run ``cfg.rounds`` buffered mixes on ``device``; ``eval_fn`` scores
    the global model every ``eval_every`` mixes and after the last. A
    ``timer`` collects wall seconds per phase of each mix."""
    _check_ported(cfg)
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    fp_step, qat_step = _make_local_steps(apply_fn, optimizer, cfg)
    channel = Channel(cfg.channel, len(clients), seed=cfg.seed + 1)
    avail = make_availability(cfg.availability, len(clients), seed=cfg.seed)

    n_conc = cfg.max_concurrency or max(int(np.ceil(cfg.participation * len(clients))), 1)
    n_conc = min(n_conc, len(clients))
    buffer_k = max(1, min(cfg.buffer_k, n_conc))
    max_stale = cfg.max_staleness if cfg.max_staleness > 0 else float("inf")
    if cfg.staleness_policy not in ("drop", "downweight"):
        raise ValueError(f"unknown staleness_policy {cfg.staleness_policy!r} "
                         "(expected 'drop' or 'downweight')")

    version = 0
    up_bytes = 0
    down_bytes = 0
    events = EventHeap(capacity=max(2 * n_conc, 16))
    buffered: list = []           # (weight, wire blob): the list path only
    rule, trim_frac = resolve_rule(cfg)
    tier = (EdgeTier(cfg.hierarchy, cfg.fttq, len(clients), fused_encode=cfg.fused_encode,
                     device=dev, rule=rule, trim_frac=trim_frac)
            if cfg.hierarchy.enabled else None)
    # ONE aggregator for the whole run: arrivals stream in as they land and
    # finalize(reset=True) per mix keeps its table and staging buffer
    agg = (Aggregator(chunk_c=cfg.agg_chunk_c, device=dev, rule=rule, trim_frac=trim_frac)
           if cfg.fused_aggregation and tier is None else None)
    attackers = (attacker_ids(cfg.attack, len(clients)) if cfg.attack is not None
                 else frozenset())
    gate = (UpdateGate(cfg.defense, global_params)
            if cfg.defense is not None and cfg.defense.enabled else None)
    # the controller's encodes are bucketed by the version they trained from
    ctrl = make_run_controller(cfg, rule)
    arrived_bytes = 0             # client-hop bytes presented to the gate
    n_buffered = 0
    acc_hist, loss_hist = [], []
    agg_times, staleness_hist, parts_hist = [], [], []
    # the list path's waste ledger; the fused path books it on the aggregator
    dropped_updates = 0
    dropped_update_bytes = 0
    last_agg_t = 0.0
    ewma_gap: float | None = None   # adaptive buffer_k: EWMA of inter-arrival gaps
    last_arrival = 0.0
    auto_target = 0.0

    # the broadcast changes only when a mix bumps `version`: encode and
    # decode it once per version
    blob_cache = {"version": -1, "blob": b"", "params": None}

    def current_broadcast() -> tuple[bytes, Any]:
        if blob_cache["version"] != version:
            blob_cache["blob"] = broadcast_blob(global_params, cfg, timer=timer)
            with _phase(timer, "wire"):
                blob_cache["params"] = receive_broadcast(blob_cache["blob"], dev)
            blob_cache["version"] = version
        return blob_cache["blob"], blob_cache["params"]

    def dispatch(k: int, t0: float, clock: float) -> None:
        """Send the current global to client k and enqueue its arrival.
        ``clock`` is the event-loop time, the NIC window's prune horizon;
        ``t0`` runs ahead of it after a wait for an empty fleet."""
        nonlocal down_bytes
        blob, start_params = current_broadcast()
        down_bytes += len(blob)
        if ctrl is not None:
            ctrl.note_round(version)
        up_blob = train_client(clients[k], start_params, cfg, optimizer, fp_step, qat_step,
                               rng, controller=ctrl, client_id=k, device=dev, timer=timer)
        if k in attackers:
            # colluders key their rng on the version they trained from
            with _phase(timer, "attack"):
                up_blob = poison_blob(up_blob, cfg.attack, k, round_idx=version)
        t_down = channel.transfer(k, len(blob), "down")
        t_comp = channel.compute_time(k, len(clients[k]) * cfg.local_epochs)
        t_up = channel.transfer_timed(k, len(up_blob), t0 + t_down + t_comp, "up",
                                      now_s=clock)
        if ctrl is not None:
            ctrl.observe_upload(k, len(up_blob), t_up)
        events.push(t0 + (t_down + t_comp + t_up), (k, up_blob, version))

    def refill(now: float) -> None:
        """Dispatch one online client, waiting for the next availability
        change while nobody is; ``now`` stays the prune horizon."""
        t = now
        while True:
            k = draw_one(avail, t, len(clients), rng)
            if k >= 0:
                dispatch(k, t, now)
                return
            t = avail.next_change(t)
            if not np.isfinite(t):
                raise RuntimeError("no client is ever available")

    if timer is not None:
        timer.start_round(0)
    t0 = 0.0
    start = draw_participants(avail, t0, n_conc, len(clients), rng)
    while start.size == 0:
        t0 = avail.next_change(t0)
        if not np.isfinite(t0):
            raise RuntimeError("no client is ever available")
        start = draw_participants(avail, t0, n_conc, len(clients), rng)
    for k in start:
        dispatch(int(k), t0, 0.0)

    while version < cfg.rounds:
        if len(events) == 0:  # pragma: no cover - dispatch always refills
            raise RuntimeError("async server starved: no in-flight clients")
        now, _, (k, up_blob, born) = events.pop()
        up_bytes += len(up_blob)
        arrived_bytes += len(up_blob)
        staleness = version - born
        gap = now - last_arrival
        last_arrival = now
        ewma_gap = gap if ewma_gap is None else 0.8 * ewma_gap + 0.2 * gap

        refused = False
        if gate is not None:
            with _phase(timer, "gate"):
                refused = not gate.check(up_blob).ok
        if refused:
            # quarantined before staleness and weighting: it never enters
            # the buffer and never counts toward buffer_k
            if agg is not None:
                agg.note_quarantined(len(up_blob))
            elif tier is not None:
                tier.note_quarantined(len(up_blob))
        elif staleness > max_stale and cfg.staleness_policy == "drop":
            staleness_hist.append(staleness)
            if agg is not None:
                agg.note_dropped(len(up_blob))
            else:
                dropped_updates += 1
                dropped_update_bytes += len(up_blob)
        else:
            staleness_hist.append(staleness)
            weight = len(clients[k]) * ((1.0 + staleness) ** (-cfg.staleness_exponent))
            if staleness > max_stale:   # "downweight": the excess discounts again
                weight *= (1.0 + staleness - max_stale) ** (-cfg.staleness_exponent)
            with _phase(timer, "aggregate"):
                if tier is not None:
                    tier.add(k, up_blob, weight, staleness=float(staleness))
                elif agg is not None:
                    agg.add(up_blob, weight=weight)
                else:
                    buffered.append((weight, up_blob))
            n_buffered += 1

        if n_buffered >= buffer_k:
            with _phase(timer, "aggregate"):
                if tier is not None:
                    # the edge→root hop is upstream wire traffic too
                    mean, fold_info = tier.fold()
                    up_bytes += fold_info["edge_to_root_bytes"]
                    global_params = _mix(global_params, mean, cfg.mixing_rate)
                else:
                    global_params = _weighted_mix(global_params, buffered, cfg.mixing_rate,
                                                  agg, dev)
            buffered = []
            n_buffered = 0
            version += 1
            parts_hist.append(buffer_k)
            agg_times.append(now - last_agg_t)
            last_agg_t = now
            if cfg.adaptive_buffer and ewma_gap and ewma_gap > 0:
                target = cfg.target_mix_latency_s
                if target <= 0:
                    if auto_target == 0.0:   # lock the first K's latency
                        auto_target = ewma_gap * buffer_k
                    target = auto_target
                buffer_k = int(np.clip(round(target / ewma_gap), 1, n_conc))
            if version % eval_every == 0 or version == cfg.rounds:
                acc, ls = eval_fn(global_params)
                acc_hist.append(float(acc))
                loss_hist.append(float(ls))
            if timer is not None and version < cfg.rounds:
                timer.start_round(version)

        # keep the fleet saturated with a fresh online client
        if version < cfg.rounds:
            refill(now)

    summary = channel.summary()
    if agg is not None:
        dropped_updates, dropped_update_bytes = agg.dropped_updates, agg.dropped_bytes
    telemetry = {
        "staleness_hist": (np.bincount(np.asarray(staleness_hist, dtype=np.int64)).tolist()
                           if staleness_hist else []),
        "dropped_updates": dropped_updates,
        "dropped_update_bytes": dropped_update_bytes,
        # every mix fires at exactly buffer_k accepted arrivals
        "buffer_k_per_agg": parts_hist,
        "retrans_bytes": summary.get("retrans_bytes", 0),
        "retries": summary.get("retries", 0),
        "goodput_fraction": summary.get("goodput_fraction", 1.0),
        "availability": cfg.availability.kind,
    }
    if ctrl is not None:
        telemetry["controller"] = ctrl.telemetry()
    if gate is not None:
        telemetry["defense"] = gate.telemetry()
        # every arrived byte passed the gate (then was ingested or dropped
        # for staleness) or was quarantined
        telemetry["defense"]["ledger_balanced"] = (
            arrived_bytes == gate.passed_bytes + gate.quarantined_bytes)
    if tier is not None:
        telemetry["hierarchy"] = tier.telemetry()
    return FedResult(
        accuracy=acc_hist, loss=loss_hist, upload_bytes=up_bytes, download_bytes=down_bytes,
        rounds_run=version, participants_per_round=parts_hist, round_times=agg_times,
        dropped_per_round=[0] * version, transfer_summary=summary,
        staleness_per_agg=staleness_hist, telemetry=telemetry,
    )
