"""Seeded Byzantine attacker models at the payload level (port of
``repro.fed.attackers``).

Each attacker turns an HONEST encoded update blob into a poisoned but
wire-valid one (decode → transform → re-encode), so framing, CRC and the
record grammar hold and only the content gate or a robust rule can catch
it. The work is numpy on the wire bytes, with the reference's generator
keys and draw order, so a poisoned blob is byte-identical to the
reference's.

  sign_flip      ternary codes negated (0 ↔ 2), float payloads negated —
                 invisible to the gate; defeated by the majority vote.
  scale_blowup   scales and float payloads × ``blowup`` — caught by the
                 gate's scale bound once its history is warm.
  gaussian       codes replaced by uniform valid codes, floats by noise of
                 the payload's standard deviation — gate-invisible.
  nan_poison     NaN scales and float payloads — caught by the gate's
                 finiteness checks from the first round.
  collude        the cohort ships ONE identical sign-flipped payload (the
                 generator is keyed on the round, not the client).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.comm.wire import decode_update_leaves, encode_update, tree_from_records
from repro_torch.core.compression import DowncastTensor, TopKTensor
from repro_torch.core.ternary import TernaryTensor
from repro_torch.dtypes import to_numpy

ATTACKS = ("sign_flip", "scale_blowup", "gaussian", "nan_poison", "collude")

# byte → the byte with every 2-bit code c mapped to 2 − c (value negation);
# the reserved code 3 maps to itself
_FLIP_LUT = np.array(
    [sum((((2 - c) if (c := (b >> (2 * j)) & 0x3) < 3 else 3) << (2 * j))
         for j in range(4))
     for b in range(256)],
    dtype=np.uint8,
)

# the 81 byte values whose four 2-bit fields are all valid codes {0, 1, 2}
_VALID_BYTES = np.array(
    [b for b in range(256) if all(((b >> (2 * j)) & 0x3) != 3 for j in range(4))],
    dtype=np.uint8,
)


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    """Who attacks and how. ``n_attackers == 0`` (the default) is all-honest."""

    kind: str = "sign_flip"
    n_attackers: int = 0
    seed: int = 0
    blowup: float = 1000.0

    def __post_init__(self):
        if self.kind not in ATTACKS:
            raise ValueError(f"kind must be one of {ATTACKS}, got {self.kind!r}")
        if self.n_attackers < 0:
            raise ValueError("n_attackers must be >= 0")
        if self.blowup <= 1.0:
            raise ValueError("blowup must be > 1")


def attacker_ids(cfg: AttackConfig, n_clients: int) -> frozenset[int]:
    """The seeded attacker cohort: a deterministic f-subset of the clients."""
    f = min(cfg.n_attackers, n_clients)
    if f == 0:
        return frozenset()
    rng = np.random.default_rng([cfg.seed, 0xBAD])
    return frozenset(int(i) for i in rng.choice(n_clients, size=f, replace=False))


def _poison_float(t: torch.Tensor, kind: str, blowup: float,
                  rng: np.random.Generator) -> torch.Tensor:
    if kind in ("sign_flip", "collude"):
        return -t
    if kind == "scale_blowup":
        return t * torch.tensor(blowup, dtype=t.dtype)
    if kind == "gaussian":
        std = float(np.std(t.to(torch.float64).numpy())) or 1.0
        return torch.from_numpy(rng.normal(0.0, std, size=tuple(t.shape))).to(t.dtype)
    if kind == "nan_poison":
        return torch.full_like(t, float("nan"))
    raise ValueError(f"unknown attack kind {kind!r}")


def _poison_leaf(leaf, kind: str, blowup: float, rng: np.random.Generator):
    if isinstance(leaf, TernaryTensor):
        packed = to_numpy(leaf.packed).copy()
        w_q = leaf.w_q.clone()
        if kind in ("sign_flip", "collude"):
            packed = _FLIP_LUT[packed]
        elif kind == "scale_blowup":
            w_q = w_q * torch.tensor(blowup, dtype=w_q.dtype)
        elif kind == "gaussian":
            packed = rng.choice(_VALID_BYTES, size=packed.shape)
        elif kind == "nan_poison":
            w_q = torch.full_like(w_q, float("nan"))
        return TernaryTensor(packed=torch.from_numpy(packed), w_q=w_q,
                             shape=tuple(leaf.shape), dtype=leaf.dtype)
    # a payload is poisoned where the reference's numpy counts it as
    # floating: bfloat16 is not (ROADMAP Queue 3), integers never are
    if isinstance(leaf, TopKTensor):
        return TopKTensor(indices=leaf.indices, values=_poison_payload(
            leaf.values, kind, blowup, rng), shape=tuple(leaf.shape), dtype=leaf.dtype)
    if isinstance(leaf, DowncastTensor):
        return DowncastTensor(data=_poison_payload(leaf.data, kind, blowup, rng),
                              orig_dtype=leaf.orig_dtype)
    return _poison_payload(leaf, kind, blowup, rng)


def _poison_payload(t: torch.Tensor, kind: str, blowup: float,
                    rng: np.random.Generator) -> torch.Tensor:
    if t.is_floating_point() and t.dtype != torch.bfloat16:
        return _poison_float(t, kind, blowup, rng)
    return t


def poison_blob(blob: bytes, cfg: AttackConfig, client_id: int, round_idx: int = 0) -> bytes:
    """One honest update blob → this attacker's payload. Colluders draw from
    a generator keyed on the round only, so the cohort re-encodes identical
    poison; every other kind keys on the client too."""
    key = ([cfg.seed, 0x5161, round_idx] if cfg.kind == "collude"
           else [cfg.seed, 0x5161, round_idx, client_id])
    rng = np.random.default_rng(key)
    poisoned = [(path, _poison_leaf(leaf, cfg.kind, cfg.blowup, rng))
                for path, leaf in decode_update_leaves(bytes(blob))]
    return encode_update(tree_from_records(poisoned))
