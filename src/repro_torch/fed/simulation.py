"""Round-based federated simulation: the synchronous server of paper
Algorithm 2 and the entry point of both servers (port of
``repro.fed.simulation``).

Each round:
  1. SELECTION      — sample ⌈λN⌉ clients from those online.
  2. CONFIGURATION  — the server re-quantizes the global model (T-FedAvg),
                      serializes it through ``comm.wire`` and broadcasts
                      the buffer; clients decode it.
  3. REPORTING      — clients train E local epochs (FTTQ QAT for T-FedAvg),
                      serialize their update and upload; the server streams
                      the survivors' buffers through ``fed.aggregator``.

Transfer and compute times come from ``comm.channel``: a straggler is a
client whose download + compute + upload passed the round deadline.

Determinism: one ``np.random.default_rng(cfg.seed)`` serves the
participant draws and every client's batch permutations; the channel is
seeded ``cfg.seed + 1``. Per round the draws come in the reference's
order — selection, the broadcast's ``transfer_concurrent`` jitters, then
for each trained client in pre-time order its batch permutations and its
upload transfer — so byte counts, round times, participants and dropped
stragglers equal the reference's for the same seed.

Byzantine robustness: seeded attackers (``fed.attackers``) poison their
upload after training and before it is sent; the content gate
(``fed.defense.UpdateGate``, alive across rounds) vets the survivors
before the aggregator, whose rule ``cfg.defense.rule`` may be robust.
Quarantined uploads count as upload bytes; a round whose every survivor
is quarantined holds the model.

Hierarchy: with ``cfg.hierarchy.n_edges > 0`` the survivors fan into
regional edges (``fed.hierarchy.EdgeTier``, alive across rounds), each
shipping one record to the root; that edge→root hop is booked as upload.

Adaptive compression: with ``cfg.controller`` (``fed.controller``) each
upload's codec is chosen per client and the dropped mass is carried by
error feedback; a round may then mix codecs, which only rule "mean"
aggregates. ``controller=None`` constructs nothing: the run is the static
codec path byte for byte.

``run_federated`` dispatches on ``cfg.mode``: "sync" is this server,
"async" the buffered-asynchronous one in ``fed.async_server``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.comm.channel import Channel, ChannelConfig
from repro_torch.comm.wire import decode_update, encode_update
from repro_torch.core import fttq as fttq_mod
from repro_torch.core.compression import CompressionSpec, compress_pytree, decompress_pytree
from repro_torch.core.tfedavg import (
    TernaryUpdate, client_update_payload, server_aggregate, server_requantize,
)
from repro_torch.data.federated import ClientDataset
from repro_torch.device import resolve_device
from repro_torch.fed.aggregator import Aggregator
from repro_torch.fed.attackers import AttackConfig, attacker_ids, poison_blob
from repro_torch.fed.availability import (
    AvailabilityConfig, draw_participants, make_availability,
)
from repro_torch.fed.controller import (
    CompressionController, ControllerConfig, make_controller,
)
from repro_torch.fed.defense import DefenseConfig, UpdateGate
from repro_torch.fed.hierarchy import EdgeTier, HierarchyConfig
from repro_torch.optim.optimizers import Optimizer, apply_updates
from repro_torch.tree import flatten_with_path, tree_leaves, tree_map

Pytree = Any


@dataclasses.dataclass
class FedConfig:
    algorithm: str = "tfedavg"          # "fedavg" | "tfedavg"
    mode: str = "sync"                  # "sync" | "async" (buffered, FedBuf-style)
    n_clients: int = 100
    participation: float = 0.1          # λ
    local_epochs: int = 5               # E
    batch_size: int = 64                # B
    rounds: int = 100                   # sync rounds / async aggregations
    fttq: fttq_mod.FTTQConfig = dataclasses.field(default_factory=fttq_mod.FTTQConfig)
    channel: ChannelConfig = dataclasses.field(default_factory=ChannelConfig)
    # per-direction codecs; None → tfedavg ships ternary both ways, fedavg fp32
    compression: CompressionSpec | None = None
    seed: int = 0
    # True → stream survivor blobs through fed.aggregator.Aggregator (the
    # packed fan-in kernel); False → core.tfedavg.server_aggregate
    fused_aggregation: bool = True
    agg_chunk_c: int = 16               # clients per fan-in kernel launch
    # True → quantize→pack kernel encode; False → the per-leaf reference
    fused_encode: bool = True
    # async server: aggregate every K arrivals, K clients in flight
    # (0 → ⌈λN⌉), arrival weight ∝ (1+staleness)^-α, and the global moves
    # by (1-η)·global + η·buffer mean
    buffer_k: int = 4
    max_concurrency: int = 0
    staleness_exponent: float = 0.5
    mixing_rate: float = 1.0
    availability: AvailabilityConfig = dataclasses.field(default_factory=AvailabilityConfig)
    # the edge tier (n_edges=0 → flat)
    hierarchy: HierarchyConfig = dataclasses.field(default_factory=HierarchyConfig)
    # async staleness cap (0 → none): past it an update is dropped ("drop")
    # or discounted again by the excess ("downweight")
    max_staleness: int = 0
    staleness_policy: str = "drop"
    # async: retune buffer_k after every mix so the time between mixes
    # tracks target_mix_latency_s (0 → the first mix's latency)
    adaptive_buffer: bool = False
    target_mix_latency_s: float = 0.0
    # content defense (None or enabled=False → the undefended ingest path)
    # and seeded attackers (None → every client honest)
    defense: DefenseConfig | None = None
    attack: AttackConfig | None = None
    # adaptive per-client compression (None or enabled=False → the static
    # codec path, bit for bit)
    controller: ControllerConfig | None = None


@dataclasses.dataclass
class FedResult:
    accuracy: list
    loss: list
    upload_bytes: int
    download_bytes: int
    rounds_run: int
    participants_per_round: list
    round_times: list = dataclasses.field(default_factory=list)
    dropped_per_round: list = dataclasses.field(default_factory=list)
    transfer_summary: dict = dataclasses.field(default_factory=dict)
    staleness_per_agg: list = dataclasses.field(default_factory=list)
    telemetry: dict = dataclasses.field(default_factory=dict)

    @property
    def total_time_s(self) -> float:
        return float(sum(self.round_times))


def _check_ported(cfg: FedConfig) -> None:
    if cfg.algorithm not in ("fedavg", "tfedavg"):
        raise ValueError(f"unknown algorithm {cfg.algorithm!r}")


def make_run_controller(cfg: FedConfig, rule: str) -> CompressionController | None:
    """The run's controller, or None; a mixed-codec round has no robust
    decomposition, so a controller needs rule "mean"."""
    ctrl = make_controller(cfg)
    if ctrl is not None and rule != "mean":
        raise ValueError("adaptive compression requires aggregation rule 'mean': "
                         "mixed-codec rounds have no robust-vote decomposition")
    return ctrl


class PhaseTimer:
    """Wall seconds per phase of every round (of every mix, on the async
    server). Each phase ends by synchronizing the device, so its time holds
    the device work it queued; without a timer the server never
    synchronizes for timing."""

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.rounds: list[dict[str, float]] = []

    def start_round(self, r: int) -> None:
        self.rounds.append({})

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            cur = self.rounds[-1]
            cur[name] = cur.get(name, 0.0) + time.perf_counter() - t0


def _phase(timer: PhaseTimer | None, name: str):
    return timer.phase(name) if timer is not None else contextlib.nullcontext()


def _ce_loss(apply_fn, params, xb, yb) -> torch.Tensor:
    return F.cross_entropy(apply_fn(params, xb), yb.long())


def _rebuild(tree: Pytree, leaves) -> Pytree:
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _make_local_steps(apply_fn, optimizer: Optimizer, cfg: FedConfig):
    """Per-batch steps for the fp32 (FedAvg) and QAT (T-FedAvg) paths."""

    def fp_step(params, opt_state, xb, yb):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = _ce_loss(apply_fn, _rebuild(params, leaves), xb, yb)
            grads = torch.autograd.grad(loss, leaves)
        updates, opt_state = optimizer.update(_rebuild(params, grads), opt_state, params)
        return apply_updates(params, updates), opt_state, loss.detach()

    fcfg = cfg.fttq

    def qat_step(params, wq, opt_state, xb, yb):
        p_leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        w_leaves = [w.detach().requires_grad_(True) for w in tree_leaves(wq)]
        with torch.enable_grad():
            q = fttq_mod.quantize_tree(_rebuild(params, p_leaves), _rebuild(wq, w_leaves), fcfg)
            loss = _ce_loss(apply_fn, q, xb, yb)
            grads = torch.autograd.grad(loss, p_leaves + w_leaves)
        g_p, g_w = grads[:len(p_leaves)], grads[len(p_leaves):]
        updates, opt_state = optimizer.update(_rebuild(params, g_p), opt_state, params)
        params = apply_updates(params, updates)
        # w_q trains by SGD (Alg. 1); its gradient sums over the whole leaf,
        # so the step divides by the leaf's size, even for per-row factors
        size = {path: p.numel() for path, p in flatten_with_path(params)}
        new_w = [w - 0.05 * g / float(size[path])
                 for (path, w), g in zip(flatten_with_path(wq), g_w)]
        return params, _rebuild(wq, new_w), opt_state, loss.detach()

    return fp_step, qat_step


# --------------------------------------------------------------------------
# Protocol pieces.
# --------------------------------------------------------------------------


def resolve_rule(cfg: FedConfig) -> tuple[str, float]:
    """The (aggregation rule, trim fraction) of a run. With the defense off
    it is the weighted mean; the robust rules live on the streaming
    aggregator, so they require ``fused_aggregation=True``."""
    if cfg.defense is None or not cfg.defense.enabled:
        return "mean", 0.2
    if cfg.defense.rule != "mean" and not cfg.fused_aggregation:
        raise ValueError(
            f"robust rule {cfg.defense.rule!r} requires fused_aggregation=True "
            "(the reference loop only computes the weighted mean)")
    return cfg.defense.rule, cfg.defense.trim_frac


def resolve_compression(cfg: FedConfig) -> CompressionSpec:
    """The run's per-direction codec pair (explicit, or from the algorithm:
    T-FedAvg ships ternary both ways, FedAvg raw fp32)."""
    if cfg.compression is not None:
        return cfg.compression
    kind = "ternary" if cfg.algorithm == "tfedavg" else "none"
    return CompressionSpec.symmetric(kind=kind, fttq=cfg.fttq, fused_encode=cfg.fused_encode)


def dequantize_tree(tree: Pytree, device: str | torch.device = "cuda") -> Pytree:
    """Decode every wire leaf of a decoded update onto ``device``; raw
    leaves pass."""
    return decompress_pytree(tree, resolve_device(device))


def broadcast_blob(global_params: Pytree, cfg: FedConfig, *,
                   timer: PhaseTimer | None = None) -> bytes:
    """The downstream payload, serialized: T-FedAvg re-quantizes with the
    fixed Δ = server_delta, then the residual codec takes the raw leaves."""
    dspec = resolve_compression(cfg).downstream
    with _phase(timer, "requantize"):
        if dspec.kind == "ternary":
            tree = server_requantize(global_params, dspec.fttq, fused=dspec.fused_encode)
            tree, _ = compress_pytree(tree, dspec)
        else:
            tree, _ = compress_pytree(global_params, dspec)
    with _phase(timer, "wire"):
        return encode_update(tree)


def receive_broadcast(blob: bytes, device: str | torch.device = "cuda") -> Pytree:
    """Client side of CONFIGURATION: decode the buffer and dequantize onto
    ``device``; every recipient of the same buffer shares the result."""
    return dequantize_tree(decode_update(blob), device)


def train_client(client: ClientDataset, start_params: Pytree, cfg: FedConfig,
                 optimizer: Optimizer, fp_step, qat_step, rng: np.random.Generator,
                 *, controller: CompressionController | None = None, client_id: int = -1,
                 device: str | torch.device = "cuda",
                 timer: PhaseTimer | None = None) -> bytes:
    """One client's round: train from the decoded broadcast, then
    serialize the upload through the upstream codec spec, or with a
    ``controller`` through its rung for ``client_id`` and error feedback
    (the training is the same either way)."""
    dev = resolve_device(device)
    spec = resolve_compression(cfg).upstream
    with _phase(timer, "train"):
        x = torch.from_numpy(client.x).to(dev)
        y = torch.from_numpy(client.y).to(dev)
        params_k = start_params
        opt_state = optimizer.init(params_k)
        batches = client.index_batches(cfg.batch_size, rng, cfg.local_epochs)
        if cfg.algorithm == "tfedavg":
            wq = fttq_mod.init_wq_tree(params_k, cfg.fttq)
            for sel in batches:
                idx = torch.from_numpy(sel).to(dev)
                params_k, wq, opt_state, _ = qat_step(params_k, wq, opt_state, x[idx], y[idx])
        else:
            for sel in batches:
                idx = torch.from_numpy(sel).to(dev)
                params_k, opt_state, _ = fp_step(params_k, opt_state, x[idx], y[idx])
    if controller is not None:
        return controller.client_payload(
            client_id, params_k, wq if cfg.algorithm == "tfedavg" else None, start_params,
            timer=timer)
    with _phase(timer, "encode"):
        if cfg.algorithm == "tfedavg":
            payload = client_update_payload(params_k, wq, cfg.fttq, fused=spec.fused_encode)
        else:
            payload = params_k
        payload, _ = compress_pytree(payload, spec)
    with _phase(timer, "wire"):
        return encode_update(payload)


# --------------------------------------------------------------------------
# Synchronous server (paper Algorithm 2).
# --------------------------------------------------------------------------


def run_federated_sync(
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
    """Run ``cfg.rounds`` sync rounds on ``device``; ``eval_fn`` scores the
    aggregated model every ``eval_every`` rounds and after the last. A
    ``timer`` collects wall seconds per phase of each round."""
    _check_ported(cfg)
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    fp_step, qat_step = _make_local_steps(apply_fn, optimizer, cfg)
    channel = Channel(cfg.channel, len(clients), seed=cfg.seed + 1)
    avail = make_availability(cfg.availability, len(clients), seed=cfg.seed)
    deadline = cfg.channel.deadline_s if cfg.channel.deadline_s > 0 else float("inf")
    rule, trim_frac = resolve_rule(cfg)
    # the edge tier lives across rounds: its plans and byte ledger persist
    tier = (EdgeTier(cfg.hierarchy, cfg.fttq, len(clients), fused_encode=cfg.fused_encode,
                     device=dev, rule=rule, trim_frac=trim_frac)
            if cfg.hierarchy.enabled else None)
    agg = (Aggregator(chunk_c=cfg.agg_chunk_c, device=dev, rule=rule, trim_frac=trim_frac)
           if cfg.fused_aggregation and tier is None else None)
    # the seeded attacker cohort, and a gate that lives across rounds so its
    # scale history warms up
    attackers = (attacker_ids(cfg.attack, len(clients)) if cfg.attack is not None
                 else frozenset())
    gate = (UpdateGate(cfg.defense, global_params)
            if cfg.defense is not None and cfg.defense.enabled else None)
    gated_bytes = 0            # survivor bytes presented to the gate
    ctrl = make_run_controller(cfg, rule)

    up_bytes = 0
    down_bytes = 0
    dropped_blob_bytes = 0
    acc_hist, loss_hist, parts_hist = [], [], []
    round_times, dropped_hist = [], []
    up_per_round, down_per_round = [], []
    n_sel = max(int(np.ceil(cfg.participation * len(clients))), 1)
    t_now = 0.0

    for r in range(cfg.rounds):
        if timer is not None:
            timer.start_round(r)
        if ctrl is not None:
            ctrl.note_round(r)
        round_up0, round_down0 = up_bytes, down_bytes
        # ---- selection (from the clients online right now) --------------
        wait_s = 0.0
        selected = draw_participants(avail, t_now, n_sel, len(clients), rng)
        while selected.size == 0:   # fleet empty: wait for the next arrival
            t_next = avail.next_change(t_now + wait_s)
            if not np.isfinite(t_next):
                raise RuntimeError("no client is ever available")
            wait_s = t_next - t_now
            selected = draw_participants(avail, t_next, n_sel, len(clients), rng)

        # ---- configuration (one serialized broadcast buffer) ------------
        blob = broadcast_blob(global_params, cfg, timer=timer)
        down_bytes += len(blob) * len(selected)
        with _phase(timer, "wire"):
            start_params = receive_broadcast(blob, dev)

        # ---- local training + reporting ---------------------------------
        # a client whose download + compute alone passes the deadline is
        # dropped before training; the fastest one always trains.
        sel = [int(k) for k in selected]
        down_times = channel.transfer_concurrent(sel, [len(blob)] * len(sel), "down")
        pre = []
        for t_down, k in zip(down_times, sel):
            t_comp = channel.compute_time(k, len(clients[k]) * cfg.local_epochs)
            pre.append((t_down + t_comp, k))
        pre.sort()

        arrivals = []
        for pt, k in pre:
            if pt > deadline and arrivals:
                continue
            up_blob = train_client(clients[k], start_params, cfg, optimizer, fp_step,
                                   qat_step, rng, controller=ctrl, client_id=k, device=dev,
                                   timer=timer)
            if k in attackers:
                # decode → poison → re-encode: the frame stays wire-valid
                with _phase(timer, "attack"):
                    up_blob = poison_blob(up_blob, cfg.attack, k, round_idx=r)
            t_up = channel.transfer(k, len(up_blob), "up")
            if ctrl is not None:
                # the channel's metered view: bytes over seconds with retransmissions
                ctrl.observe_upload(k, len(up_blob), t_up)
            arrivals.append((pt + t_up, k, up_blob))

        # ---- stragglers: emergent from the channel ----------------------
        arrivals.sort(key=lambda a: a[0])
        survivors = [a for a in arrivals if a[0] <= deadline]
        if not survivors:            # never lose a round: keep the fastest
            survivors = [arrivals[0]]
        dropped_blob_bytes += sum(len(a[2]) for a in arrivals[len(survivors):])
        n_dropped = len(pre) - len(survivors)
        dropped_hist.append(n_dropped)
        parts_hist.append(len(survivors))
        last_survivor = max(a[0] for a in survivors)
        round_times.append(wait_s + (max(deadline, last_survivor) if n_dropped
                                     else last_survivor))
        t_now += round_times[-1]

        # ---- ingest gate: quarantined uploads were shipped and paid for,
        # so their bytes count as upload AND as quarantine ----------------
        if gate is not None:
            with _phase(timer, "gate"):
                accepted = []
                for total, k, up_blob in survivors:
                    gated_bytes += len(up_blob)
                    if gate.check(up_blob).ok:
                        accepted.append((total, k, up_blob))
                    else:
                        up_bytes += len(up_blob)
                        if tier is not None:
                            tier.note_quarantined(len(up_blob))
                survivors = accepted

        # ---- aggregation (the server decodes the real upload buffers) ---
        with _phase(timer, "aggregate"):
            if not survivors:
                # every survivor was quarantined: hold the model this round
                pass
            elif tier is not None:
                # survivors fan into their edges; each edge ships one record
                # to the root, and that hop is booked as upload
                for _, k, up_blob in survivors:
                    up_bytes += len(up_blob)
                    tier.add(k, up_blob, weight=len(clients[k]))
                global_params, fold_info = tier.fold()
                up_bytes += fold_info["edge_to_root_bytes"]
            elif agg is not None:
                for _, k, up_blob in survivors:
                    up_bytes += len(up_blob)
                    agg.add(up_blob, weight=len(clients[k]))
                global_params = agg.finalize(reset=True)
            else:
                updates = []
                for _, k, up_blob in survivors:
                    up_bytes += len(up_blob)
                    updates.append(TernaryUpdate(payload=decode_update(up_blob),
                                                 n_samples=len(clients[k]), client_id=k))
                global_params = server_aggregate(updates, dev)
        up_per_round.append(up_bytes - round_up0)
        down_per_round.append(down_bytes - round_down0)

        if (r + 1) % eval_every == 0 or r == cfg.rounds - 1:
            acc, ls = eval_fn(global_params)
            acc_hist.append(float(acc))
            loss_hist.append(float(ls))

    summary = channel.summary()
    telemetry = {
        "dropped_updates": int(sum(dropped_hist)),
        "dropped_update_bytes": dropped_blob_bytes,
        "retrans_bytes": summary.get("retrans_bytes", 0),
        "retries": summary.get("retries", 0),
        "goodput_fraction": summary.get("goodput_fraction", 1.0),
        "availability": cfg.availability.kind,
        "upload_bytes_per_round": up_per_round,
        "download_bytes_per_round": down_per_round,
    }
    if ctrl is not None:
        telemetry["controller"] = ctrl.telemetry()
    if gate is not None:
        telemetry["defense"] = gate.telemetry()
        # every survivor byte presented to the gate was ingested or quarantined
        telemetry["defense"]["ledger_balanced"] = (
            gated_bytes == gate.passed_bytes + gate.quarantined_bytes)
    if tier is not None:
        telemetry["hierarchy"] = tier.telemetry()
    return FedResult(
        accuracy=acc_hist, loss=loss_hist, upload_bytes=up_bytes,
        download_bytes=down_bytes, rounds_run=cfg.rounds,
        participants_per_round=parts_hist, round_times=round_times,
        dropped_per_round=dropped_hist, transfer_summary=summary, telemetry=telemetry,
    )


def run_federated(apply_fn: Callable, global_params: Pytree, clients: list[ClientDataset],
                  cfg: FedConfig, optimizer: Optimizer,
                  eval_fn: Callable[[Pytree], tuple[float, float]], *,
                  eval_every: int = 10, device: str | torch.device = "cuda",
                  timer: PhaseTimer | None = None) -> FedResult:
    """Unified entry point, dispatching on ``cfg.mode``: "sync" runs
    Algorithm 2's round-synchronous server (this module), "async" the
    buffered-asynchronous one (``fed.async_server``)."""
    if cfg.mode == "async":
        from repro_torch.fed.async_server import run_federated_async

        return run_federated_async(apply_fn, global_params, clients, cfg, optimizer, eval_fn,
                                   eval_every=eval_every, device=device, timer=timer)
    if cfg.mode != "sync":
        raise ValueError(f"unknown federated mode {cfg.mode!r}")
    return run_federated_sync(apply_fn, global_params, clients, cfg, optimizer, eval_fn,
                              eval_every=eval_every, device=device, timer=timer)
