"""Hierarchical edge-aggregation tier: client → edge → root (port of
``repro.fed.hierarchy``).

Clients upload to a regional EDGE, each edge folds its region with a
streaming ``fed.aggregator.Aggregator`` (the packed fan-in kernel), and
ships ONE record upstream, so the root's ingress grows with the number of
edges, not of clients.

Two upstream modes (``HierarchyConfig.requantize_at_edge``):

  - True (default): the edge re-quantizes its regional mean with the
    server-side FTTQ path (``core.tfedavg.server_requantize``: fixed
    Δ = server_delta, the Prop-4.1 scale, one ``quantize_pack_segments``
    launch per edge), so the edge→root hop ships 2-bit codes too. Lossy:
    one extra ternary rounding per tier.
  - False: the edge ships its dense regional mean as raw fp32 records.
    Lossless: the 2-tier mean equals a flat ``Aggregator`` over the union
    of clients, bit for bit when the per-edge partial sums are exact. The
    root then folds raw records only, through the aggregator's dense
    fallback, and launches no kernel.

Weights compose exactly: an edge's record carries W_e = Σ_{k∈e} w_k, so
the root mean Σ_e W_e·mean_e / Σ_e W_e is the flat mean when the hop is
lossless. Every hop is a ``comm.wire`` buffer, and the tier keeps a byte
ledger that survives folds: client→edge bytes ingested by the edges, and
edge→root bytes shipped (``upstream_bytes``) against those the root
ingested (``root_ingest_bytes``).

Placement is a pure function of the client id (``edge_of``), folds draw
no randomness and requantizing uses the fixed server Δ, so a seeded run
with the tier on is reproducible; ``HierarchyConfig(n_edges=0)`` (the
default) is the flat topology. Edge and root aggregators live on the
tier's ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.comm.wire import encode_update
from repro_torch.core import fttq as fttq_mod
from repro_torch.core.tfedavg import server_requantize
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.fed.aggregator import Aggregator

Pytree = Any


@dataclasses.dataclass(frozen=True)
class HierarchyConfig:
    """The tier's knobs (``FedConfig.hierarchy``).

    Attributes:
      n_edges: number of edge aggregators; 0 = flat (no tier).
      requantize_at_edge: True → an edge re-quantizes its regional mean to
        ternary before the upstream hop; False → it ships the dense mean.
      assignment: "mod" → client k reports to edge k % n_edges; "block" →
        edge k·E // N (contiguous regions).
      edge_chunk_c: clients per fan-in kernel launch at each edge.
      root_chunk_c: edge records per fan-in kernel launch at the root.
    """

    n_edges: int = 0
    requantize_at_edge: bool = True
    assignment: str = "mod"
    edge_chunk_c: int = 16
    root_chunk_c: int = 16

    @property
    def enabled(self) -> bool:
        return self.n_edges > 0


def edge_of(client_id: int, n_clients: int, cfg: HierarchyConfig) -> int:
    """The edge client ``client_id`` reports to."""
    if cfg.assignment == "mod":
        return int(client_id) % cfg.n_edges
    if cfg.assignment == "block":
        return (int(client_id) * cfg.n_edges) // max(int(n_clients), 1)
    raise ValueError(f"unknown edge assignment {cfg.assignment!r}")


def edges_of(client_ids: np.ndarray, n_clients: int, cfg: HierarchyConfig) -> np.ndarray:
    """``edge_of`` over an array of client ids."""
    ids = np.asarray(client_ids, dtype=np.int64)
    if cfg.assignment == "mod":
        return ids % cfg.n_edges
    if cfg.assignment == "block":
        return (ids * cfg.n_edges) // max(int(n_clients), 1)
    raise ValueError(f"unknown edge assignment {cfg.assignment!r}")


class EdgeTier:
    """One tier of edge aggregators plus the root fan-in.

    Long-lived like ``Aggregator``: each edge's and the root's plans and
    staging buffers persist across folds (``fold`` resets the accumulated
    state only); the byte ledger is cumulative.
    """

    def __init__(self, cfg: HierarchyConfig, fttq: fttq_mod.FTTQConfig, n_clients: int, *,
                 fused_encode: bool = True, device: str | torch.device = DEFAULT_DEVICE,
                 rule: str = "mean", trim_frac: float = 0.2):
        if cfg.n_edges < 1:
            raise ValueError(f"EdgeTier needs n_edges ≥ 1, got {cfg.n_edges}")
        self.cfg = cfg
        self.fttq = fttq
        self.n_clients = int(n_clients)
        self.fused_encode = fused_encode
        self.device = resolve_device(device)
        # the aggregation rule applies at both tiers
        self.rule = rule
        self.trim_frac = trim_frac
        # edges are created when their first client arrives
        self._edges: dict[int, Aggregator] = {}
        self._edge_weight = np.zeros(cfg.n_edges, dtype=np.float64)
        self._edge_clients = np.zeros(cfg.n_edges, dtype=np.int64)
        self._edge_staleness = np.zeros(cfg.n_edges, dtype=np.float64)
        self._root = Aggregator(chunk_c=cfg.root_chunk_c, device=self.device, rule=rule,
                                trim_frac=trim_frac)
        # cumulative ledger (never reset)
        self.ingest_bytes = np.zeros(cfg.n_edges, dtype=np.int64)
        self.upstream_bytes = np.zeros(cfg.n_edges, dtype=np.int64)
        self.clients_seen = np.zeros(cfg.n_edges, dtype=np.int64)
        self.root_ingest_bytes = 0
        self.folds = 0
        # client blobs a defense gate refused before they reached an edge
        self.quarantined_updates = 0
        self.quarantined_bytes = 0

    # -- ingest ------------------------------------------------------------

    def _edge_agg(self, e: int) -> Aggregator:
        agg = self._edges.get(e)
        if agg is None:
            agg = Aggregator(chunk_c=self.cfg.edge_chunk_c, device=self.device,
                             rule=self.rule, trim_frac=self.trim_frac)
            self._edges[e] = agg
        return agg

    def note_quarantined(self, nbytes: int, updates: int = 1) -> None:
        """Book gate-refused client bytes (shipped, never ingested)."""
        self.quarantined_updates += int(updates)
        self.quarantined_bytes += int(nbytes)

    def add(self, client_id: int, blob: bytes, weight: float, staleness: float = 0.0) -> None:
        """Route one client's wire blob to its edge."""
        e = edge_of(client_id, self.n_clients, self.cfg)
        self._edge_agg(e).add(blob, weight=weight)
        self._edge_weight[e] += float(weight)
        self._edge_clients[e] += 1
        self._edge_staleness[e] += float(staleness)
        self.ingest_bytes[e] += len(blob)
        self.clients_seen[e] += 1

    def add_cohort(self, edge: int, blob: bytes, weight: float, n_clients: int,
                   staleness_sum: float = 0.0) -> None:
        """``n_clients`` clients of one edge shipped byte-identical blobs:
        the edge folds ONE add at the cohort's summed ``weight`` while the
        ledger books every client's bytes."""
        self._edge_agg(edge).add(blob, weight=weight)
        self._edge_weight[edge] += float(weight)
        self._edge_clients[edge] += int(n_clients)
        self._edge_staleness[edge] += float(staleness_sum)
        self.ingest_bytes[edge] += int(n_clients) * len(blob)
        self.clients_seen[edge] += int(n_clients)

    @property
    def pending_clients(self) -> int:
        return int(self._edge_clients.sum())

    # -- the edge→root hop -------------------------------------------------

    def collect(self) -> list[tuple[int, bytes, float]]:
        """Flush every edge with pending clients into one upstream blob
        each: (edge, blob, regional weight W_e), edges in ascending order."""
        out = []
        for e in sorted(self._edges):
            if self._edge_clients[e] == 0:
                continue
            mean = self._edges[e].finalize(reset=True)
            if self.cfg.requantize_at_edge:
                mean = server_requantize(mean, self.fttq, fused=self.fused_encode)
            blob = encode_update(mean)
            w = float(self._edge_weight[e])
            self.upstream_bytes[e] += len(blob)
            out.append((e, blob, w))
        self._edge_weight[:] = 0.0
        self._edge_clients[:] = 0
        return out

    def fold(self) -> tuple[Pytree, dict]:
        """One tier round: the edges flush upstream, the root folds their
        records at weights W_e; returns the global mean and the round's
        ``edges_active`` and ``edge_to_root_bytes``."""
        records = self.collect()
        if not records:
            raise ValueError("EdgeTier.fold: no client updates were added")
        round_up = 0
        for _e, blob, w in records:
            self._root.add(blob, weight=w)
            self.root_ingest_bytes += len(blob)
            round_up += len(blob)
        mean = self._root.finalize(reset=True)
        self.folds += 1
        return mean, {"edges_active": len(records), "edge_to_root_bytes": round_up}

    # -- ledger ------------------------------------------------------------

    def telemetry(self) -> dict:
        """The cumulative per-tier breakdown; ``ledger_balanced`` says that
        what the edges shipped is what the root ingested."""
        c2e = int(self.ingest_bytes.sum())
        e2r = int(self.upstream_bytes.sum())
        return {
            "n_edges": self.cfg.n_edges,
            "requantize_at_edge": self.cfg.requantize_at_edge,
            "rule": self.rule,
            "quarantined_updates": self.quarantined_updates,
            "quarantined_bytes": self.quarantined_bytes,
            "client_to_edge_bytes": c2e,
            "edge_to_root_bytes": e2r,
            "root_ingest_bytes": self.root_ingest_bytes,
            "ledger_balanced": e2r == self.root_ingest_bytes,
            "clients_per_edge": self.clients_seen.tolist(),
            "bytes_per_edge": self.ingest_bytes.tolist(),
            "upstream_bytes_per_edge": self.upstream_bytes.tolist(),
            "mean_staleness_per_edge": (
                self._edge_staleness / np.maximum(self.clients_seen, 1)).tolist(),
            "folds": self.folds,
        }
