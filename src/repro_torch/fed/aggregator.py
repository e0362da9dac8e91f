"""Streaming fused fan-in aggregation for the T-FedAvg server.

Port of ``repro.fed.aggregator``, rule ``"mean"``. Wire blobs stream in one
at a time (``add``); their ternary records are decoded ZERO-COPY (CPU
tensors viewing the buffer) into reusable stacked ``(bucket, R, LANES)``
uint8 staging buffers, and every full chunk is folded into a running dense
fp32 sum on the aggregation device by one launch of the packed fan-in
kernel per (leaf, scale segment) group (``kernels.aggregate`` through
``parallel.fanin``). ``finalize`` flushes the remainder and returns the
|D_k|-weighted mean tree. The server's memory is one running partial per
leaf plus one chunk of packed bytes, whatever the client count.

  - A client's scale folds into its kernel coefficient,
    coeff = |D_k| · w_q, computed as a Python float product and rounded to
    fp32 once, as the reference does.
  - A leaf with one scale per leading index (a stacked layer, a conv weight
    with one factor per kernel row) aggregates per SCALE SEGMENT: each
    segment is a contiguous byte range of the wire stream, so the split is
    a zero-copy slice. ResNet18*'s 3×3 conv leaves are 3 segments each;
    ``head/w`` is one flat segment.
  - A partial chunk pads up to a BUCKET, the smallest power of two ≥ its
    client count capped at ``chunk_c``, with zero bytes and coefficient 0.
  - Raw leaves (biases, norms) and any other non-ternary record take the
    dense fallback: Σ weight·leaf in fp32 on the device.

The staging buffer is host memory, copied to the device synchronously
before the launch that reads it, so it can be refilled as soon as the copy
returns. The result equals the reference ``Aggregator``'s bit for bit (the
kernel sums clients in order, each term exact) and the list reference
``core.tfedavg.server_aggregate`` within fp32 reordering.

The robust rules ``majority``, ``trimmed_mean`` and ``median`` wait for
the robust slice and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.comm.wire import WireError, decode_update_leaves, tree_from_records
from repro_torch.core.compression import decode_wire_leaf
from repro_torch.core.ternary import TernaryTensor
from repro_torch.device import resolve_device
from repro_torch.dtypes import torch_dtype
from repro_torch.kernels.aggregate import LANES, padded_rows
from repro_torch.parallel.fanin import fanin_weighted_sum

Pytree = Any

AGG_RULES = ("mean", "majority", "trimmed_mean", "median")


def bucket_for(c: int, chunk_c: int) -> int:
    """The smallest power of two ≥ c, capped at ``chunk_c``."""
    if c >= chunk_c:
        return chunk_c
    b = 1
    while b < c:
        b <<= 1
    return min(b, chunk_c)


def _f32(x: float) -> float:
    """``x`` rounded to fp32, as a Python float."""
    return float(np.float32(x))


@dataclasses.dataclass
class _Group:
    """Pending rows of one (leaf, scale segment) kernel input."""

    nbytes: int                  # real packed bytes per client segment
    n_elements: int              # logical elements per segment
    rows: int                    # padded byte-rows R (``padded_rows``)
    views: list = dataclasses.field(default_factory=list)   # np byte views
    coeffs: list = dataclasses.field(default_factory=list)  # weight · scale
    partial: Any = None          # running fp32 flat sum on the device


@dataclasses.dataclass
class _LeafPlan:
    """How one record path aggregates: fused kernel groups or dense fallback."""

    fused: bool
    shape: tuple = ()
    dtype: str = "float32"
    n_segments: int = 1
    scale_size: int = 1


class Aggregator:
    """Streaming |D_k|-weighted mean of wire-encoded client updates::

        agg = Aggregator(chunk_c=16, device="cuda")
        for blob, n_samples in arrivals:
            agg.add(blob, weight=n_samples)
        global_params = agg.finalize()

    ``finalize(reset=True)`` (or ``reset()``) clears the accumulated state
    and keeps the leaf plans and staging buffers for the next round.
    """

    def __init__(self, chunk_c: int = 16, *, device: str | torch.device = "cuda",
                 mesh=None, rule: str = "mean"):
        if chunk_c < 1:
            raise ValueError(f"chunk_c must be ≥ 1, got {chunk_c}")
        if rule not in AGG_RULES:
            raise ValueError(f"rule must be one of {AGG_RULES}, got {rule!r}")
        if rule != "mean":
            raise NotImplementedError(f"aggregation rule {rule!r} is not ported yet")
        self.chunk_c = chunk_c
        self.device = resolve_device(device)
        self.mesh = mesh
        self.rule = rule
        self._paths: list[str] | None = None   # record order of client 0
        self._plans: dict[str, _LeafPlan] = {}
        self._groups: dict[tuple[str, int], _Group] = {}
        self._fallback: dict[str, torch.Tensor] = {}
        # paths whose fallback received adds since the last reset: a
        # mixed-codec round detours fused paths there, and a later round
        # must not fold in the (zeroed) leftovers of an earlier one.
        self._fallback_touched: set[str] = set()
        self._fallback_dtype: dict[str, torch.dtype] = {}
        self._buffers: dict[tuple[int, int], np.ndarray] = {}
        self._pending = 0
        self._n_clients = 0
        self._total_weight = 0.0
        # updates received and paid for but not folded in (cumulative
        # across resets): dropped by policy, or refused by a defense gate.
        self.dropped_updates = 0
        self.dropped_bytes = 0
        self.quarantined_updates = 0
        self.quarantined_bytes = 0

    # -- ingest ------------------------------------------------------------

    def note_dropped(self, nbytes: int) -> None:
        """Record one received-but-discarded update (its bytes were spent)."""
        self.dropped_updates += 1
        self.dropped_bytes += int(nbytes)

    def note_quarantined(self, nbytes: int) -> None:
        """Record one update a defense gate refused."""
        self.quarantined_updates += 1
        self.quarantined_bytes += int(nbytes)

    def add(self, blob: bytes, weight: float) -> None:
        """Decode one client's wire buffer (zero-copy) and stage it; a full
        chunk launches the kernel once per leaf group."""
        if weight < 0:
            raise ValueError(f"client weight must be ≥ 0, got {weight}")
        pairs = decode_update_leaves(blob)
        paths = [p for p, _ in pairs]
        if len(set(paths)) != len(paths):
            raise WireError("duplicate record paths in client update")
        if self._paths is None:
            self._paths = paths
            for path, leaf in pairs:
                self._plan_leaf(path, leaf)
        elif paths != self._paths:
            raise ValueError(
                "client update structure changed mid-aggregation: "
                f"{len(paths)} records vs {len(self._paths)}"
            )
        for path, leaf in pairs:
            self._add_leaf(path, leaf, float(weight))
        self._total_weight += float(weight)
        self._n_clients += 1
        self._pending += 1
        if self._pending >= self.chunk_c:
            self._flush()

    def _plan_leaf(self, path: str, leaf) -> None:
        if isinstance(leaf, TernaryTensor):
            shape = tuple(int(s) for s in leaf.shape)
            n = leaf.n_elements
            scale_shape = tuple(leaf.w_q.shape)
            size = leaf.w_q.numel()
            trailing_ok = len(scale_shape) <= 1 or all(s == 1 for s in scale_shape[1:])
            if size == 1:
                segs = 1
            elif (trailing_ok and shape and size == shape[0]
                  and n % size == 0 and (n // size) % 4 == 0):
                segs = size     # per-leading-dim scales, byte-aligned
            else:
                segs = 0        # odd scale layout → dense fallback
            if segs:
                self._plans[path] = _LeafPlan(fused=True, shape=shape, dtype=leaf.dtype,
                                              n_segments=segs, scale_size=size)
                seg_elems = n // segs
                seg_bytes = (seg_elems + 3) // 4 if segs == 1 else seg_elems // 4
                rows = padded_rows(seg_bytes)
                for s in range(segs):
                    self._groups[(path, s)] = _Group(nbytes=seg_bytes,
                                                     n_elements=seg_elems, rows=rows)
                return
        self._plans[path] = _LeafPlan(fused=False)

    def _add_leaf(self, path: str, leaf, weight: float) -> None:
        plan = self._plans[path]
        if not plan.fused or not isinstance(leaf, TernaryTensor):
            # a raw leaf, or a mixed-codec round's non-ternary record on a
            # path planned fused: the mean is additive, so it detours
            # through the dense fallback and finalize sums both routes.
            self._add_fallback(path, leaf, weight)
            return
        if tuple(int(s) for s in leaf.shape) != plan.shape:
            raise ValueError(f"leaf {path!r} changed shape mid-aggregation")
        packed = leaf.packed.numpy().reshape(-1)     # zero-copy views of the blob
        scale = leaf.w_q.to(torch.float64).reshape(-1).numpy()
        if scale.size != plan.scale_size:
            raise ValueError(f"leaf {path!r} changed scale layout")
        for s in range(plan.n_segments):
            g = self._groups[(path, s)]
            g.views.append(packed[s * g.nbytes:(s + 1) * g.nbytes])
            g.coeffs.append(weight * float(scale[s if scale.size > 1 else 0]))

    def _add_fallback(self, path: str, leaf, weight: float) -> None:
        dense = decode_wire_leaf(leaf, self.device)
        if path not in self._fallback_dtype:
            # float leaves keep their dtype, integer leaves become fp32
            self._fallback_dtype[path] = (dense.dtype if dense.is_floating_point()
                                          else torch.float32)
        if path not in self._fallback:
            self._fallback[path] = torch.zeros(dense.shape, dtype=torch.float32,
                                               device=self.device)
        self._fallback[path] += dense.to(torch.float32) * _f32(weight)
        self._fallback_touched.add(path)

    # -- kernel launches ---------------------------------------------------

    def _buffer(self, c_pad: int, rows: int) -> np.ndarray:
        buf = self._buffers.get((c_pad, rows))
        if buf is None:
            buf = self._buffers[(c_pad, rows)] = np.empty((c_pad, rows * LANES), np.uint8)
        return buf

    def _flush(self) -> None:
        for g in self._groups.values():
            self._flush_group(g)
        self._pending = 0

    def _flush_group(self, g: _Group) -> None:
        c = len(g.views)
        if c == 0:
            return
        c_pad = bucket_for(c, self.chunk_c)
        buf = self._buffer(c_pad, g.rows)
        for i, v in enumerate(g.views):
            buf[i, :g.nbytes] = v
            buf[i, g.nbytes:] = 0
        buf[c:] = 0
        coeffs = np.zeros((c_pad,), np.float32)
        coeffs[:c] = g.coeffs
        # a synchronous host→device copy: it has returned before ``buf`` is
        # refilled (on the CPU the plain version runs before the return)
        stacked = torch.from_numpy(buf).reshape(c_pad, g.rows, LANES).to(self.device)
        out = fanin_weighted_sum(stacked, torch.from_numpy(coeffs).to(self.device),
                                 mesh=self.mesh)
        g.partial = out if g.partial is None else g.partial + out
        g.views.clear()
        g.coeffs.clear()

    # -- result ------------------------------------------------------------

    @property
    def n_clients(self) -> int:
        """Client updates added since construction / the last reset."""
        return self._n_clients

    def reset(self) -> None:
        """Clear the accumulated state, keeping plans and staging buffers."""
        for g in self._groups.values():
            g.views.clear()
            g.coeffs.clear()
            g.partial = None
        for acc in self._fallback.values():
            acc.zero_()
        self._fallback_touched.clear()
        self._pending = 0
        self._n_clients = 0
        self._total_weight = 0.0

    def finalize(self, *, reset: bool = False) -> Pytree:
        """Flush pending rows and return the weighted-mean tree
        (Σ |D_k|/Σ|D_k| · dequant(payload_k)) on the aggregation device."""
        if self._n_clients == 0:
            raise ValueError("Aggregator.finalize: no client updates were added")
        if self._total_weight <= 0:
            raise ValueError("Aggregator.finalize: total client weight is zero")
        self._flush()
        inv = _f32(1.0 / self._total_weight)
        pairs = []
        for path in self._paths:
            plan = self._plans[path]
            if plan.fused:
                parts = []
                for s in range(plan.n_segments):
                    g = self._groups[(path, s)]
                    parts.append(g.partial[:g.n_elements] if g.partial is not None
                                 else torch.zeros(g.n_elements, device=self.device))
                flat = parts[0] if len(parts) == 1 else torch.cat(parts)
                if path in self._fallback_touched:
                    flat = flat + self._fallback[path].reshape(-1)
                leaf = (flat * inv).reshape(plan.shape).to(torch_dtype(plan.dtype))
            else:
                leaf = (self._fallback[path] * inv).to(self._fallback_dtype[path])
            pairs.append((path, leaf))
        out = tree_from_records(pairs)
        if reset:
            self.reset()
        return out
