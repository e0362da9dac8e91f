"""Per-client adaptive compression with generic error feedback (port of
``repro.fed.controller``).

Each upload's codec is chosen per client from two measured signals:

  - **upload goodput** (bytes/s, the channel's metered view of each
    transfer): a client whose link runs well below the fleet's mean ships
    the cheapest rung;
  - **update divergence** ‖θ_k − θ‖ / ‖θ‖: a large update ships the
    paper's ternary codec, a small one the sparse rung, with the dropped
    mass kept;

and what an encode drops is kept: every client carries an error-feedback
residual tree (Sattler et al., arXiv:1903.02891) on the run's device,
folded into its weights before the next encode (corrected = θ_k +
residual) and replaced by corrected − decode(encode(corrected)). The ladder
spans the codec registry — "fp16", "bf16", "ternary", "topk", "topk16" —
and a round may mix rungs: every record carries its kind byte.

On the T-FedAvg path the ternary rung goes through the same
``core.tfedavg.client_update_payload`` as the static path (the trained w_q
scales, one ``quantize_pack`` launch per upload on the card).

The controller holds no rng: its choices are a pure function of the
config and the observations, which the servers feed in their
deterministic event order. ``FedConfig.controller = None`` constructs
nothing, so such a run is the static path byte for byte. Telemetry lands
in ``FedResult.telemetry["controller"]``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch

from repro_torch.comm.wire import encode_update
from repro_torch.core.compression import (
    CodecSpec, available_codecs, compress_pytree, decompress_pytree,
)
from repro_torch.core.tfedavg import client_update_payload
from repro_torch.tree import tree_leaves, tree_map

Pytree = Any

# the rungs the controller may select, highest fidelity first; each is a
# codec for quantizable leaves, the rest follow ``residual_codec``
LADDER = ("fp16", "bf16", "ternary", "topk", "topk16")


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """The controller's knobs (``FedConfig.controller``).

    enabled: False behaves as ``controller=None`` (nothing is constructed).
    error_feedback: keep per-client residual trees and fold them back
      before each encode.
    warmup_encodes: a client's first N uploads ship ternary whatever the
      signals.
    divergence_high: at or above it an update ships ternary (or
      ``fidelity_rung`` on a fast link); below it ``aggressive_rung``.
    slow_factor: goodput below slow_factor × the fleet mean ships
      ``aggressive_rung`` (0 disables).
    fast_factor: goodput above fast_factor × the fleet mean with a large
      update ships ``fidelity_rung`` (0 disables).
    topk_fraction: the fraction the top-k rungs keep.
    residual_codec: the codec of the non-quantizable leaves on every rung.
    ewma: smoothing of the goodput and divergence EWMAs
      (new = ewma·obs + (1 − ewma)·old).
    """

    enabled: bool = True
    error_feedback: bool = True
    warmup_encodes: int = 1
    divergence_high: float = 0.05
    slow_factor: float = 0.5
    fast_factor: float = 0.0
    aggressive_rung: str = "topk16"
    fidelity_rung: str = "fp16"
    topk_fraction: float = 0.05
    residual_codec: str = "none"
    ewma: float = 0.5

    def __post_init__(self):
        for field in ("aggressive_rung", "fidelity_rung"):
            rung = getattr(self, field)
            if rung not in LADDER:
                raise ValueError(f"{field} {rung!r} not in ladder {LADDER}")
        if self.residual_codec not in available_codecs():
            raise ValueError(f"unknown residual_codec {self.residual_codec!r}")
        if not 0.0 < self.ewma <= 1.0:
            raise ValueError(f"ewma must be in (0, 1], got {self.ewma}")


def tree_l2(tree: Pytree) -> float:
    """The L2 norm over every floating leaf of a tree, in float64; the
    per-leaf sums cross to the host in one transfer and add up in leaf
    order."""
    sums = []
    for leaf in tree_leaves(tree):
        t = torch.as_tensor(leaf).detach()
        if t.is_floating_point():
            t = t.to(torch.float64).reshape(-1)
            sums.append(torch.dot(t, t))
    total = 0.0
    for s in torch.stack(sums).tolist() if sums else ():
        total += s
    return math.sqrt(total)


def _tree_zip(fn, a: Pytree, b: Pytree) -> Pytree:
    it = iter(tree_leaves(b))
    return tree_map(lambda x: fn(x, next(it)), a)


def _device_of(tree: Pytree) -> torch.device:
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


class CompressionController:
    """The per-client control loop; one per federated run. The servers
    drive it through ``note_round(r)`` (telemetry buckets: a round, or a
    model version on the async server), ``client_payload`` (the encode
    ``train_client`` calls instead of the static path),
    ``observe_upload(k, nbytes, seconds)`` and ``telemetry()``."""

    def __init__(self, cfg: ControllerConfig, fed_cfg: Any):
        self.cfg = cfg
        self.fed = fed_cfg   # FedConfig: fttq, fused_encode
        self._residual: dict[int, Pytree] = {}
        self._goodput: dict[int, float] = {}
        self._divergence: dict[int, float] = {}
        self._encodes: dict[int, int] = {}
        self._round = 0
        self._rung_counts: dict[int, dict[str, int]] = {}
        self._residual_l2: dict[int, float] = {}
        self._bytes_by_kind: dict[str, int] = {}
        self._specs: dict[str, CodecSpec] = {}

    # -- policy ------------------------------------------------------------

    def spec_for(self, rung: str) -> CodecSpec:
        """The codec spec one ladder rung resolves to."""
        spec = self._specs.get(rung)
        if spec is None:
            spec = CodecSpec(kind=rung, residual=self.cfg.residual_codec, fttq=self.fed.fttq,
                             topk_fraction=self.cfg.topk_fraction,
                             fused_encode=self.fed.fused_encode)
            self._specs[rung] = spec
        return spec

    def _fleet_mean(self) -> float:
        return sum(self._goodput.values()) / len(self._goodput)

    def select(self, client_id: int) -> str:
        """The rung of client ``client_id``'s next upload: a pure function
        of the observation EWMAs."""
        k = int(client_id)
        if self._encodes.get(k, 0) < self.cfg.warmup_encodes:
            return "ternary"
        div = self._divergence.get(k, float("inf"))
        gp = self._goodput.get(k)
        if (gp is not None and self.cfg.slow_factor > 0
                and gp < self.cfg.slow_factor * self._fleet_mean()):
            return self.cfg.aggressive_rung
        if div >= self.cfg.divergence_high:
            if (gp is not None and self.cfg.fast_factor > 0
                    and gp > self.cfg.fast_factor * self._fleet_mean()):
                return self.cfg.fidelity_rung
            return "ternary"
        return self.cfg.aggressive_rung

    # -- observations ------------------------------------------------------

    def note_round(self, round_idx: int) -> None:
        self._round = int(round_idx)

    def observe_upload(self, client_id: int, nbytes: int, seconds: float) -> None:
        """Fold one metered upload (payload bytes over seconds, with
        retransmissions) into the client's goodput EWMA."""
        if seconds <= 0:
            return
        k, a = int(client_id), self.cfg.ewma
        gp = float(nbytes) / float(seconds)
        old = self._goodput.get(k)
        self._goodput[k] = gp if old is None else a * gp + (1 - a) * old

    def _observe_divergence(self, k: int, params_k: Pytree, start_params: Pytree) -> None:
        base = tree_l2(start_params)
        div = tree_l2(_tree_zip(torch.sub, params_k, start_params)) / (base + 1e-12)
        a = self.cfg.ewma
        old = self._divergence.get(k)
        self._divergence[k] = div if old is None else a * div + (1 - a) * old

    # -- the encode hook ---------------------------------------------------

    def client_payload(self, client_id: int, params_k: Pytree, wq_tree: Pytree | None,
                       start_params: Pytree, *, timer=None) -> bytes:
        """One client's upload under its rung, with error feedback:
        corrected = θ_k + residual_k, residual_k ← corrected − decode(wire).
        Returns the wire blob. A ``PhaseTimer`` books the encode and the
        serialization as "encode" and "wire"."""

        def phase(name):
            return timer.phase(name) if timer is not None else contextlib.nullcontext()

        k = int(client_id)
        ef = self.cfg.error_feedback
        with phase("encode"):
            self._observe_divergence(k, params_k, start_params)
            rung = self.select(k)
            spec = self.spec_for(rung)
            res = self._residual.get(k) if ef else None
            if rung == "ternary" and wq_tree is not None:
                # the QAT wire path: the corrected weights keep their trained scales
                corrected = params_k if res is None else _tree_zip(torch.add, params_k, res)
                payload = client_update_payload(corrected, wq_tree, self.fed.fttq,
                                                fused=spec.fused_encode)
                payload, _ = compress_pytree(payload, spec)
                new_res = (_tree_zip(torch.sub, corrected,
                                     decompress_pytree(payload, _device_of(corrected)))
                           if ef else None)
            else:
                payload, new_res = compress_pytree(
                    params_k, dataclasses.replace(spec, error_feedback=ef), residual=res)
            if ef:
                self._residual[k] = new_res
            self._encodes[k] = self._encodes.get(k, 0) + 1
        with phase("wire"):
            blob = encode_update(payload)
        r = self._round
        counts = self._rung_counts.setdefault(r, {})
        counts[rung] = counts.get(rung, 0) + 1
        if ef:
            self._residual_l2[r] = self._residual_l2.get(r, 0.0) + tree_l2(new_res)
        self._bytes_by_kind[rung] = self._bytes_by_kind.get(rung, 0) + len(blob)
        return blob

    # -- reporting ---------------------------------------------------------

    def residual_l2(self, client_id: int) -> float:
        res = self._residual.get(int(client_id))
        return 0.0 if res is None else tree_l2(res)

    def telemetry(self) -> dict:
        rounds = sorted(self._rung_counts)
        return {
            "enabled": True,
            "error_feedback": self.cfg.error_feedback,
            "rounds": rounds,
            "rung_counts_per_round": [self._rung_counts[r] for r in rounds],
            # Σ over a round's encodes of ‖residual‖₂: bounded while error
            # feedback is healthy
            "residual_l2_per_round": [self._residual_l2.get(r, 0.0) for r in rounds],
            "bytes_by_kind": dict(sorted(self._bytes_by_kind.items())),
            "clients_seen": len(self._encodes),
        }


def make_controller(fed_cfg: Any) -> CompressionController | None:
    """The run's controller, or None when the config leaves it off (then
    nothing is constructed and the run is the static path)."""
    ctrl_cfg = getattr(fed_cfg, "controller", None)
    if ctrl_cfg is None or not ctrl_cfg.enabled:
        return None
    return CompressionController(ctrl_cfg, fed_cfg)


# --------------------------------------------------------------------------
# The cohort-level policy of the vectorized fleet path.
# --------------------------------------------------------------------------


class FleetCohortController:
    """The fleet's approximation of the per-client loop: fleet rounds ship
    pre-encoded payloads, so there is no divergence signal and no residual,
    and the policy runs per cohort on the mean upload goodput. The warmup
    rounds ship ternary; after them a round whose goodput EWMA falls below
    ``slow_factor`` × the first observed goodput ships ``aggressive_rung``,
    else ternary. No rng: the trajectory is a function of the channel's."""

    def __init__(self, cfg: ControllerConfig):
        self.cfg = cfg
        self._ewma: float | None = None
        self._baseline: float | None = None
        self._rounds = 0
        self.rung_per_round: list[str] = []

    def observe_round(self, nbytes: int, seconds: float) -> None:
        """Fold one round's upload (Σ bytes, Σ seconds)."""
        if seconds <= 0:
            return
        gp = float(nbytes) / float(seconds)
        a = self.cfg.ewma
        self._ewma = gp if self._ewma is None else a * gp + (1 - a) * self._ewma
        if self._baseline is None:
            self._baseline = gp

    def select(self) -> str:
        self._rounds += 1
        if self._rounds <= self.cfg.warmup_encodes or self._ewma is None:
            rung = "ternary"
        elif (self.cfg.slow_factor > 0 and self._baseline is not None
              and self._ewma < self.cfg.slow_factor * self._baseline):
            rung = self.cfg.aggressive_rung
        else:
            rung = "ternary"
        self.rung_per_round.append(rung)
        return rung

    def telemetry(self) -> dict:
        return {"enabled": True, "cohort_policy": True,
                "rung_per_round": list(self.rung_per_round), "goodput_ewma": self._ewma}
