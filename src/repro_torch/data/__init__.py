"""Synthetic data and federated partitioners (port of ``repro.data``)."""

from repro_torch.data.federated import (
    ClientDataset, emd_to_global, partition_iid, partition_noniid, partition_unbalanced,
)
from repro_torch.data.synthetic import synthetic_classification, synthetic_tokens, token_batches

__all__ = ["ClientDataset", "emd_to_global", "partition_iid", "partition_noniid",
           "partition_unbalanced", "synthetic_classification", "synthetic_tokens",
           "token_batches"]
