"""Federated runtime (port of ``repro.fed``): the synchronous T-FedAvg /
FedAvg server, the streaming fan-in aggregator with its robust rules, the
content defense gate, seeded attackers and client availability."""

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
from repro_torch.fed.defense import DefenseConfig, UpdateGate, Verdict
from repro_torch.fed.simulation import FedConfig, FedResult, run_federated, run_federated_sync

__all__ = [
    "Aggregator", "FedConfig", "FedResult", "run_federated", "run_federated_sync",
    "AvailabilityConfig", "ClientAvailability", "AlwaysOn", "DiurnalChurn",
    "TraceReplay", "make_availability",
    "AGG_RULES", "ATTACKS", "AttackConfig", "attacker_ids", "poison_blob",
    "DefenseConfig", "UpdateGate", "Verdict",
]
