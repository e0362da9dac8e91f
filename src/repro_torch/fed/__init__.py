"""Federated runtime (port of ``repro.fed``): the synchronous and the
buffered-asynchronous T-FedAvg / FedAvg servers, the vectorized fleet
simulator (``run_fleet``), the edge→root tier, the streaming fan-in
aggregator with its robust rules, the content defense gate, seeded
attackers, client availability, the event queue and the adaptive
compression controller."""

from repro_torch.fed.aggregator import AGG_RULES, Aggregator
from repro_torch.fed.attackers import ATTACKS, AttackConfig, attacker_ids, poison_blob
from repro_torch.fed.availability import (
    AlwaysOn,
    AvailabilityConfig,
    ClientAvailability,
    DiurnalChurn,
    TraceReplay,
    make_availability,
)
from repro_torch.fed.async_server import run_federated_async
from repro_torch.fed.controller import (
    CompressionController,
    ControllerConfig,
    FleetCohortController,
    make_controller,
)
from repro_torch.fed.defense import DefenseConfig, UpdateGate, Verdict
from repro_torch.fed.fleet import EventHeap, FleetConfig, FleetResult, run_fleet
from repro_torch.fed.hierarchy import EdgeTier, HierarchyConfig, edge_of, edges_of
from repro_torch.fed.simulation import FedConfig, FedResult, run_federated, run_federated_sync

__all__ = [
    "Aggregator", "FedConfig", "FedResult", "run_federated", "run_federated_sync",
    "run_federated_async", "EventHeap", "FleetConfig", "FleetResult", "run_fleet",
    "HierarchyConfig", "EdgeTier", "edge_of", "edges_of",
    "AvailabilityConfig", "ClientAvailability", "AlwaysOn", "DiurnalChurn",
    "TraceReplay", "make_availability",
    "AGG_RULES", "ATTACKS", "AttackConfig", "attacker_ids", "poison_blob",
    "DefenseConfig", "UpdateGate", "Verdict",
    "CompressionController", "ControllerConfig", "FleetCohortController", "make_controller",
]
