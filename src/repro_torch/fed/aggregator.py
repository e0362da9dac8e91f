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

Robust rules (``rule=``; "mean" is the default):
  - "majority": ternary leaves are decided coordinate-wise by weighted
    plurality over the 2-bit codes. The ``vote`` kernel counts the ±1 vote
    masses off the same staging buffers with the RAW weights as
    coefficients (a vote is scale-free); the masses accumulate across
    chunk flushes, and ``finalize`` multiplies the winning codes by each
    segment's robust scale, the weighted median of the client scales.
    Raw leaves take the coordinate-wise weighted median.
  - "trimmed_mean" / "median": every leaf is decoded dense and kept per
    client (O(C·model) memory: exact order statistics need the whole
    sample), then reduced coordinate-wise.
A mixed-codec round has no robust decomposition, so a non-ternary record
on a path planned for the vote raises. The order statistics and their sums
run in the reference's order (a stable sort, an fp32 cumulative weight
client by client, numpy's summation order), so every rule equals the
reference ``Aggregator`` bit for bit.
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
from repro_torch.kernels.vote import majority_from_counts
from repro_torch.parallel.fanin import fanin_vote_counts, fanin_weighted_sum

Pytree = Any

AGG_RULES = ("mean", "majority", "trimmed_mean", "median")


def _sorted_with_weights(stack: torch.Tensor, weights: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``stack`` sorted along axis 0 (stable, as numpy's ``kind="stable"``)
    and each client's weight carried along."""
    svals, order = torch.sort(stack, dim=0, stable=True)
    w = weights.to(device=stack.device, dtype=torch.float32)
    w = w.reshape((-1,) + (1,) * (stack.ndim - 1)).expand(stack.shape)
    return svals, torch.gather(w, 0, order)


def _pairwise_rows(rows: list[torch.Tensor]) -> torch.Tensor:
    """numpy's pairwise float sum (eight accumulators, blocks of 128)."""
    n = len(rows)
    if n < 8:
        acc = rows[0]
        for r in rows[1:]:
            acc = acc + r
        return acc
    if n <= 128:
        acc = list(rows[:8])
        i = 8
        while i < n - n % 8:
            acc = [a + r for a, r in zip(acc, rows[i:i + 8])]
            i += 8
        res = ((acc[0] + acc[1]) + (acc[2] + acc[3])) + ((acc[4] + acc[5]) + (acc[6] + acc[7]))
        for r in rows[i:]:
            res = res + r
        return res
    half = n // 2
    half -= half % 8
    return _pairwise_rows(rows[:half]) + _pairwise_rows(rows[half:])


def _sum0(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(axis=0)`` in numpy's order: client by client from row 0, or
    pairwise where a row holds one element (the reduced axis is then the
    contiguous one)."""
    rows = list(x.unbind(0))
    if x[0].numel() == 1:
        return _pairwise_rows(rows)
    acc = rows[0]
    for r in rows[1:]:
        acc = acc + r
    return acc


def weighted_median(stack: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise weighted median along axis 0 (the lower median: the
    first sorted value whose cumulative weight reaches half the total), as
    ``repro.fed.aggregator.weighted_median`` computes it."""
    svals, sw = _sorted_with_weights(stack, weights)
    cum = [sw[0]]
    for i in range(1, sw.shape[0]):
        cum.append(cum[-1] + sw[i])
    cum = torch.stack(cum)
    # cum never decreases, so this counts what numpy's argmax(cum >= half) finds
    idx = (cum < cum[-1] / 2.0).sum(0)
    return torch.gather(svals, 0, idx.unsqueeze(0))[0]


def trimmed_mean(stack: torch.Tensor, weights: torch.Tensor, trim_frac: float) -> torch.Tensor:
    """Coordinate-wise trimmed weighted mean along axis 0: sort, drop
    ⌊trim_frac·C⌋ values per side (at least one survives), then the
    weighted mean of the survivors."""
    c = stack.shape[0]
    k = min(int(trim_frac * c), (c - 1) // 2)
    svals, sw = _sorted_with_weights(stack, weights)
    if k:
        svals, sw = svals[k:c - k], sw[k:c - k]
    return _sum0(svals * sw) / _sum0(sw)


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
    # rule "majority": the running (2, 4R·LANES) ±1 vote masses, and every
    # client's (scale, weight) for the robust scale at finalize
    counts: Any = None
    scale_samples: list = dataclasses.field(default_factory=list)


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
                 mesh=None, rule: str = "mean", trim_frac: float = 0.2):
        if chunk_c < 1:
            raise ValueError(f"chunk_c must be ≥ 1, got {chunk_c}")
        if rule not in AGG_RULES:
            raise ValueError(f"rule must be one of {AGG_RULES}, got {rule!r}")
        if not 0.0 <= trim_frac < 0.5:
            raise ValueError(f"trim_frac must be in [0, 0.5), got {trim_frac}")
        self.chunk_c = chunk_c
        self.device = resolve_device(device)
        self.mesh = mesh
        self.rule = rule
        self.trim_frac = trim_frac
        # exact order statistics need every client's dense leaf: these two
        # rules plan no leaf for the kernels
        self._dense_rule = rule in ("trimmed_mean", "median")
        self._client_dense: dict[str, list] = {}   # path → [(weight, fp32 leaf)]
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
        if not self._dense_rule and isinstance(leaf, TernaryTensor):
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
        if plan.fused and not isinstance(leaf, TernaryTensor) and self.rule != "mean":
            raise ValueError(
                f"leaf {path!r}: mixed wire kinds under rule {self.rule!r} (only "
                "'mean' aggregates mixed-codec rounds; pin one codec per round "
                "for robust rules)")
        if not plan.fused or not isinstance(leaf, TernaryTensor):
            # a raw leaf, or (rule "mean") a mixed-codec round's non-ternary
            # record on a path planned fused: the mean is additive, so it
            # detours through the dense fallback and finalize sums both routes.
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
            seg_scale = float(scale[s if scale.size > 1 else 0])
            if self.rule == "majority":
                # votes are scale-free: the coefficient is the raw weight,
                # and the scale joins at finalize as a weighted median
                g.coeffs.append(weight)
                g.scale_samples.append((seg_scale, weight))
            else:
                g.coeffs.append(weight * seg_scale)

    def _add_fallback(self, path: str, leaf, weight: float) -> None:
        dense = decode_wire_leaf(leaf, self.device)
        if path not in self._fallback_dtype:
            # float leaves keep their dtype, integer leaves become fp32
            self._fallback_dtype[path] = (dense.dtype if dense.is_floating_point()
                                          else torch.float32)
        if self.rule != "mean":
            # the order statistics need the whole per-client sample
            self._client_dense.setdefault(path, []).append((weight, dense.to(torch.float32)))
            return
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
        coeffs_t = torch.from_numpy(coeffs).to(self.device)
        if self.rule == "majority":
            # a zero byte is four code-0 slots (−1 votes): coefficient 0
            # cancels the padding rows, and real clients' zeroed tails land
            # past n_elements
            out = fanin_vote_counts(stacked, coeffs_t, mesh=self.mesh)
            g.counts = out if g.counts is None else g.counts + out
        else:
            out = fanin_weighted_sum(stacked, coeffs_t, mesh=self.mesh)
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
            g.counts = None
            g.scale_samples.clear()
        for acc in self._fallback.values():
            acc.zero_()
        self._fallback_touched.clear()
        for samples in self._client_dense.values():
            samples.clear()
        self._pending = 0
        self._n_clients = 0
        self._total_weight = 0.0

    def finalize(self, *, reset: bool = False) -> Pytree:
        """Flush pending rows and return the aggregate tree on the
        aggregation device: under rule "mean" Algorithm 2's weighted mean
        Σ |D_k|/Σ|D_k| · dequant(payload_k), else the robust statistic."""
        if self._n_clients == 0:
            raise ValueError("Aggregator.finalize: no client updates were added")
        if self._total_weight <= 0:
            raise ValueError("Aggregator.finalize: total client weight is zero")
        self._flush()
        inv = _f32(1.0 / self._total_weight)
        pairs = []
        for path in self._paths:
            plan = self._plans[path]
            if plan.fused and self.rule == "majority":
                leaf = self._majority_leaf(path, plan)
            elif plan.fused:
                parts = []
                for s in range(plan.n_segments):
                    g = self._groups[(path, s)]
                    parts.append(g.partial[:g.n_elements] if g.partial is not None
                                 else torch.zeros(g.n_elements, device=self.device))
                flat = parts[0] if len(parts) == 1 else torch.cat(parts)
                if path in self._fallback_touched:
                    flat = flat + self._fallback[path].reshape(-1)
                leaf = (flat * inv).reshape(plan.shape).to(torch_dtype(plan.dtype))
            elif self.rule == "mean":
                leaf = (self._fallback[path] * inv).to(self._fallback_dtype[path])
            else:
                samples = self._client_dense[path]
                stack = torch.stack([d for _, d in samples])
                ws = torch.tensor([w for w, _ in samples], dtype=torch.float32)
                if self.rule == "trimmed_mean":
                    acc = trimmed_mean(stack, ws, self.trim_frac)
                else:   # "median", and the majority rule's raw leaves
                    acc = weighted_median(stack, ws)
                leaf = acc.to(self._fallback_dtype[path])
            pairs.append((path, leaf))
        out = tree_from_records(pairs)
        if reset:
            self.reset()
        return out

    def _majority_leaf(self, path: str, plan: _LeafPlan) -> torch.Tensor:
        """The plurality codes of each scale segment times the weighted
        median of the clients' scales for it."""
        parts = []
        for s in range(plan.n_segments):
            g = self._groups[(path, s)]
            votes = majority_from_counts(g.counts[:, :g.n_elements], self._total_weight)
            vals = torch.tensor([v for v, _ in g.scale_samples], dtype=torch.float32)
            ws = torch.tensor([w for _, w in g.scale_samples], dtype=torch.float32)
            scale = weighted_median(vals, ws).to(self.device)
            parts.append(votes.to(torch.float32) * scale)
        flat = parts[0] if len(parts) == 1 else torch.cat(parts)
        return flat.reshape(plan.shape).to(torch_dtype(plan.dtype))
