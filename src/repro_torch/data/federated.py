"""Federated partitioners reproducing the paper's §V data distributions:

  - IID (N_c = #classes): every client gets an IID subset,
  - non-IID by label (N_c classes per client, paper §V.C / Fig. 9),
  - unbalanced sizes parameterized by β = median(S_N)/max(S_N) (§V.E, eq. 29).

Copy of ``repro.data.federated`` (pure numpy): the same seed gives the same
client splits and batch order. ``ClientDataset.index_batches`` yields the
batch indices that ``batches`` slices with, drawing the same permutations,
so a trainer can gather batches from a copy of the data on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ClientDataset:
    x: np.ndarray
    y: np.ndarray
    client_id: int

    def __len__(self):
        return len(self.y)

    def index_batches(self, batch_size: int, rng: np.random.Generator,
                      epochs: int = 1):
        for _ in range(epochs):
            order = rng.permutation(len(self.y))
            for i in range(0, len(order) - batch_size + 1, batch_size):
                yield order[i : i + batch_size]

    def batches(self, batch_size: int, rng: np.random.Generator, epochs: int = 1):
        for sel in self.index_batches(batch_size, rng, epochs):
            yield self.x[sel], self.y[sel]


def partition_iid(x, y, n_clients: int, seed: int = 0) -> list[ClientDataset]:
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(y))
    shards = np.array_split(order, n_clients)
    return [ClientDataset(x[s], y[s], k) for k, s in enumerate(shards)]


def partition_noniid(x, y, n_clients: int, n_classes_per_client: int,
                     seed: int = 0) -> list[ClientDataset]:
    """Label-partitioned: each client holds samples from N_c classes; the
    union of clients covers the dataset (paper Fig. 9 construction)."""
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    # assign classes to clients round-robin with wraparound so every client
    # has exactly N_c classes and all samples are used.
    client_classes = [
        [classes[(k * n_classes_per_client + j) % len(classes)]
         for j in range(n_classes_per_client)]
        for k in range(n_clients)
    ]
    # shard each class's samples among clients that own it.
    owners: dict[int, list[int]] = {int(c): [] for c in classes}
    for k, cc in enumerate(client_classes):
        for c in cc:
            owners[int(c)].append(k)
    parts: dict[int, list[np.ndarray]] = {k: [] for k in range(n_clients)}
    for c, ks in owners.items():
        idx = np.where(y == c)[0]
        rng.shuffle(idx)
        for holder, shard in zip(ks, np.array_split(idx, len(ks))):
            parts[holder].append(shard)
    out = []
    for k in range(n_clients):
        sel = np.concatenate(parts[k]) if parts[k] else np.empty((0,), np.int64)
        rng.shuffle(sel)
        out.append(ClientDataset(x[sel], y[sel], k))
    return out


def partition_unbalanced(x, y, n_clients: int, beta: float,
                         seed: int = 0) -> list[ClientDataset]:
    """Unbalanced sizes with median/max ratio ≈ β (paper eq. 29): one client
    holds the bulk; the rest share the remainder roughly equally."""
    assert 0 < beta <= 1
    rng = np.random.default_rng(seed)
    n = len(y)
    # sizes: one "max" client of size M, others at median m = β·M.
    # M + (K-1)·β·M = n  →  M = n / (1 + (K-1)β)
    m_max = n / (1 + (n_clients - 1) * beta)
    sizes = [int(m_max)] + [int(m_max * beta)] * (n_clients - 1)
    sizes[-1] += n - sum(sizes)  # absorb rounding
    order = rng.permutation(n)
    out, ofs = [], 0
    for k, s in enumerate(sizes):
        sel = order[ofs : ofs + s]
        ofs += s
        out.append(ClientDataset(x[sel], y[sel], k))
    return out


def emd_to_global(clients: list[ClientDataset], n_classes: int) -> float:
    """Mean earth-mover's distance between client label distributions and the
    global distribution (the divergence driver of Lemma 4.1/4.2)."""
    all_y = np.concatenate([c.y for c in clients])
    global_p = np.bincount(all_y, minlength=n_classes) / len(all_y)
    ds = []
    for c in clients:
        if len(c) == 0:
            continue
        p = np.bincount(c.y, minlength=n_classes) / len(c)
        ds.append(0.5 * np.abs(p - global_p).sum())  # total-variation EMD on labels
    return float(np.mean(ds))
