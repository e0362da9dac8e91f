"""Federated runtime (port of ``repro.fed``): the synchronous T-FedAvg /
FedAvg server, the streaming fan-in aggregator and client availability."""
