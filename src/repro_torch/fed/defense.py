"""Byzantine-robust ingest: the payload quarantine gate (port of
``repro.fed.defense``).

Framing and CRC catch byte-level faults; a well-formed but poisoned update
(NaN scales, a 1000× scale blowup, reserved 2-bit codes) passes them. The
gate inspects the decoded CONTENT of each upload against the broadcast
model before it reaches the aggregator, and books a failure as the third
ledger outcome:

    shipped == ingested + dropped + quarantined

Checks, in order (the first failure wins; reasons are telemetry keys):

  malformed          the blob does not decode (``WireError``)
  structure          record paths, logical shapes or dtypes differ from the
                     broadcast tree
  scale_nonfinite    a ternary scale is NaN or Inf
  scale_bound        max |scale| exceeds ``scale_bound`` × the running
                     median of accepted payloads' scales for that leaf (live
                     once ``min_history`` have been seen)
  code_plane         a packed ternary byte holds the reserved code 3
  payload_nonfinite  a raw float payload is NaN or Inf

The gate runs on host bytes — the blob's zero-copy records — and never
mutates a blob, so a defended round of honest clients is byte-identical to
an undefended one. Only accepted payloads feed the scale history. The gate
draws no randomness: verdicts and telemetry are a pure function of the
blob sequence.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any

import numpy as np
import torch

from repro_torch.comm.wire import WireError, decode_update_leaves, tree_leaf_paths
from repro_torch.core.compression import DowncastTensor, TopKTensor
from repro_torch.core.ternary import TernaryTensor
from repro_torch.dtypes import dtype_name, to_numpy
from repro_torch.fed.aggregator import AGG_RULES

# Quarantine reasons, in check order.
REASONS = ("malformed", "structure", "scale_nonfinite", "scale_bound",
           "code_plane", "payload_nonfinite")

# byte → does any of its four 2-bit fields hold the reserved code 3?
_HAS_CODE3 = np.array(
    [any(((b >> (2 * j)) & 0x3) == 3 for j in range(4)) for b in range(256)],
    dtype=bool,
)


@dataclasses.dataclass(frozen=True)
class DefenseConfig:
    """The content defense. ``enabled=False`` (the default) keeps the gate
    out of the ingest path. ``rule`` is the aggregation statistic; only
    "mean" is the undefended weighted mean."""

    enabled: bool = False
    rule: str = "mean"
    scale_bound: float = 10.0   # max |scale| / running median before quarantine
    min_history: int = 4        # accepted payloads before the bound is live
    trim_frac: float = 0.2      # per-side trim of the trimmed_mean rule

    def __post_init__(self):
        if self.rule not in AGG_RULES:
            raise ValueError(f"rule must be one of {AGG_RULES}, got {self.rule!r}")
        if self.scale_bound <= 1.0:
            raise ValueError("scale_bound must be > 1 (it is a ratio)")
        if self.min_history < 1:
            raise ValueError("min_history must be >= 1")
        if not 0.0 <= self.trim_frac < 0.5:
            raise ValueError("trim_frac must be in [0, 0.5)")


@dataclasses.dataclass(frozen=True)
class Verdict:
    """Outcome of one gate check: ``ok`` passes the update to the
    aggregator; otherwise ``reason`` is one of ``REASONS`` and ``detail``
    names the offending record."""

    ok: bool
    reason: str = ""
    detail: str = ""


def _leaf_signature(leaf: Any) -> tuple[tuple, str]:
    """(logical shape, wire dtype name) of a wire or dense leaf, from
    metadata only (a leaf on the card is not read)."""
    if isinstance(leaf, (TernaryTensor, TopKTensor)):
        return tuple(int(s) for s in leaf.shape), str(leaf.dtype)
    if isinstance(leaf, DowncastTensor):
        return tuple(leaf.data.shape), str(leaf.orig_dtype)
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), dtype_name(leaf.dtype)
    arr = np.asarray(leaf)
    return tuple(arr.shape), dtype_name(arr.dtype)


def _host_floats(x) -> np.ndarray:
    """A scale or payload as host numpy values (bfloat16 widened to fp32)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    return np.asarray(x)


class UpdateGate:
    """The content gate, built from the BROADCAST params tree, the structure
    every honest update mirrors. ``check(blob)`` returns a ``Verdict`` and
    updates the telemetry; the caller books quarantined bytes in its ledger
    (``Aggregator.note_quarantined``)."""

    def __init__(self, cfg: DefenseConfig, params: Any):
        self.cfg = cfg
        self._ref = {path: _leaf_signature(leaf) for path, leaf in tree_leaf_paths(params)}
        self._scale_hist: dict[str, list[float]] = {}
        self.passed_updates = 0
        self.passed_bytes = 0
        self.quarantined_updates = 0
        self.quarantined_bytes = 0
        self.reasons: Counter[str] = Counter()

    def _check_records(self, pairs) -> Verdict:
        seen = dict(pairs)
        if set(seen) != set(self._ref):
            missing = sorted(set(self._ref) - set(seen))
            extra = sorted(set(seen) - set(self._ref))
            return Verdict(False, "structure", f"missing={missing[:3]} extra={extra[:3]}")
        for path, leaf in seen.items():
            if _leaf_signature(leaf) != self._ref[path]:
                return Verdict(False, "structure",
                               f"{path!r}: {_leaf_signature(leaf)} != {self._ref[path]}")
        # content checks, cheapest to catch first
        for path, leaf in seen.items():
            if isinstance(leaf, TernaryTensor):
                scale = _host_floats(leaf.w_q)
                if not np.all(np.isfinite(scale)):
                    return Verdict(False, "scale_nonfinite", path)
                v = self._scale_verdict(path, scale)
                if v is not None:
                    return v
                if _HAS_CODE3[to_numpy(leaf.packed)].any():
                    return Verdict(False, "code_plane", path)
            else:
                payload = (leaf.data if isinstance(leaf, DowncastTensor)
                           else leaf.values if isinstance(leaf, TopKTensor) else leaf)
                # the reference's np.floating test passes bfloat16 payloads
                # unchecked; the port gives the same verdicts (ROADMAP Queue 3)
                if payload.dtype == torch.bfloat16:
                    continue
                payload = _host_floats(payload)
                if (np.issubdtype(payload.dtype, np.floating)
                        and not np.all(np.isfinite(payload))):
                    return Verdict(False, "payload_nonfinite", path)
        return Verdict(True)

    def _scale_verdict(self, path: str, scale: np.ndarray) -> Verdict | None:
        hist = self._scale_hist.get(path, ())
        if len(hist) < self.cfg.min_history:
            return None
        med = float(np.median(hist))
        rep = float(np.max(np.abs(scale)))
        if rep > self.cfg.scale_bound * max(med, np.finfo(np.float32).tiny):
            return Verdict(False, "scale_bound",
                           f"{path!r}: |scale| {rep:.3g} vs median {med:.3g}")
        return None

    def check(self, blob: bytes) -> Verdict:
        """Gate one update payload; a pass feeds its scales to the history."""
        try:
            pairs = decode_update_leaves(bytes(blob))
        except WireError as e:
            verdict = Verdict(False, "malformed", str(e)[:120])
        else:
            verdict = self._check_records(pairs)
        if verdict.ok:
            self.passed_updates += 1
            self.passed_bytes += len(blob)
            for path, leaf in pairs:
                if isinstance(leaf, TernaryTensor):
                    self._scale_hist.setdefault(path, []).append(
                        float(np.max(np.abs(_host_floats(leaf.w_q)))))
        else:
            self.quarantined_updates += 1
            self.quarantined_bytes += len(blob)
            self.reasons[verdict.reason] += 1
        return verdict

    def telemetry(self) -> dict:
        return {
            "enabled": self.cfg.enabled,
            "rule": self.cfg.rule,
            "passed_updates": self.passed_updates,
            "passed_bytes": self.passed_bytes,
            "quarantined_updates": self.quarantined_updates,
            "quarantined_bytes": self.quarantined_bytes,
            "reasons": dict(self.reasons),
        }
