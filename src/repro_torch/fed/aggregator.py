"""Streaming fused fan-in aggregation for the T-FedAvg server.

Port of ``repro.fed.aggregator``, rule ``"mean"``. Wire blobs stream in one
at a time (``add``); their ternary records are decoded ZERO-COPY (CPU
tensors viewing the buffer) and kept until a flush, which stages every
pending client's bytes of every (leaf, scale segment) into one row of one
staging buffer and folds them into a running dense fp32 sum on the
aggregation device with ONE launch of the packed fan-in kernel
(``kernels.aggregate`` through ``parallel.fanin``). ``finalize`` flushes
the remainder and returns the |D_k|-weighted mean tree. The server's
memory is one running flat partial plus one chunk of packed bytes,
whatever the client count.

  - A client's scale folds into its kernel coefficient,
    coeff = |D_k| · w_q, computed as a Python float product and rounded to
    fp32 once, as the reference does: a (C, S) matrix, one column per
    segment.
  - A leaf with one scale per leading index (a stacked layer, a conv weight
    with one factor per kernel row) aggregates per SCALE SEGMENT: each
    segment is a contiguous byte range of the wire stream. ResNet18*'s 3×3
    conv leaves are 3 segments each; ``head/w`` is one flat segment.
  - The segment table (``kernels.aggregate.fanin_table``) depends only on
    the leaf plan: it is built once, from the first client's records, and
    kept on the device. A staged row holds exactly each segment's bytes at
    a 4-byte aligned offset; a flush stages exactly its clients, a flush
    every ``chunk_c`` adds, and the flushes add up as ``partial + out``.
    The outputs lie in one flat buffer, a leaf's segments side by side, so
    ``finalize`` takes each leaf as a view.
  - Raw leaves (biases, norms) and any other non-ternary record take the
    dense fallback: Σ weight·leaf in fp32 on the device.

On a CUDA aggregator the staging buffer is pinned host memory, and a flush
moves its bytes and coefficients to the device in one non-blocking copy; the
buffer is refilled only after that copy's event has completed. On a CPU
aggregator it is plain memory that the plain version reads in place. The
result equals the reference ``Aggregator``'s bit for bit (the kernel sums
clients in order, each term exact; the reference's padding rows add only
0·u terms) and the list reference ``core.tfedavg.server_aggregate`` within
fp32 reordering.

Robust rules (``rule=``; "mean" is the default):
  - "majority": ternary leaves are decided coordinate-wise by weighted
    plurality over the 2-bit codes. The ``vote`` kernel counts the ±1 vote
    masses off the same staging buffer with the RAW weights as
    coefficients (a vote is scale-free); the masses accumulate across
    chunk flushes, and ``finalize`` decides the whole flat buffer at once:
    one plurality, every segment's robust scale from one weighted median
    over the (C, S) client scales, and one multiply.
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
from torch.profiler import record_function

from repro_torch.comm.wire import WireError, decode_update_leaves, tree_from_records
from repro_torch.core.compression import decode_wire_leaf
from repro_torch.core.ternary import TernaryTensor
from repro_torch.device import resolve_device
from repro_torch.dtypes import torch_dtype
from repro_torch.kernels.aggregate import FanInTable, fanin_table
from repro_torch.kernels.vote import majority_from_counts
from repro_torch.parallel.fanin import fanin_vote_counts_segments, fanin_weighted_sum_segments

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


def _f32(x: float) -> float:
    """``x`` rounded to fp32, as a Python float."""
    return float(np.float32(x))


@dataclasses.dataclass
class _LeafPlan:
    """How one record path aggregates: fused kernel segments or dense fallback."""

    fused: bool
    shape: tuple = ()
    dtype: str = "float32"
    n_segments: int = 1
    scale_size: int = 1
    first: int = 0            # its first segment's index in the table
    seg_bytes: int = 0        # packed bytes per segment
    seg_elements: int = 0     # elements per segment
    out_off: int = 0          # its first element in the flat output
    # (wire offset, staged offset, bytes) copies that stage one client's leaf
    runs: tuple = ()


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
        self._groups: dict[tuple[str, int], int] = {}   # (path, segment) → table index
        self._segments: list[tuple[int, int]] = []      # (bytes, elements) per segment
        self._table: FanInTable | None = None
        self._slots: torch.Tensor | None = None   # output slot per segment (majority)
        self._fallback: dict[str, torch.Tensor] = {}
        # paths whose fallback received adds since the last reset: a
        # mixed-codec round detours fused paths there, and a later round
        # must not fold in the (zeroed) leftovers of an earlier one.
        self._fallback_touched: set[str] = set()
        self._fallback_dtype: dict[str, torch.dtype] = {}
        # the staging buffer, one row of bytes per client then one row of
        # coefficients per client; on a CUDA aggregator pinned, with its
        # device copy and the event of the last copy out of it
        self._staging: torch.Tensor | None = None
        self._staging_dev: torch.Tensor | None = None
        self._copied: torch.cuda.Event | None = None
        # per pending client: ([(plan, wire bytes)], coefficient row)
        self._pending: list[tuple[list, np.ndarray]] = []
        self._partial: torch.Tensor | None = None   # running flat fp32 sum
        self._counts: torch.Tensor | None = None    # rule "majority": (2, n) masses
        # rule "majority": every client's segment scales and weight
        self._scale_rows: list[np.ndarray] = []
        self._scale_weights: list[float] = []
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
        """Decode one client's wire buffer (zero-copy) and keep it; a full
        chunk is staged and folded in one kernel launch."""
        if weight < 0:
            raise ValueError(f"client weight must be ≥ 0, got {weight}")
        with record_function("aggregator.add"):
            pairs = decode_update_leaves(blob)
            paths = [p for p, _ in pairs]
            if len(set(paths)) != len(paths):
                raise WireError("duplicate record paths in client update")
            if self._paths is None:
                self._paths = paths
                for path, leaf in pairs:
                    self._plan_leaf(path, leaf)
                self._plan_table()
            elif paths != self._paths:
                raise ValueError(
                    "client update structure changed mid-aggregation: "
                    f"{len(paths)} records vs {len(self._paths)}"
                )
            # a client's coefficients: its weight (rule "majority", one for
            # every segment) or weight · scale per segment, 0 where a leaf
            # detours to the fallback
            coeffs = (np.full(1, weight, np.float32) if self.rule == "majority"
                      else np.zeros(len(self._segments), np.float32))
            staged = ([], coeffs)
            scales = np.zeros(len(self._segments))
            for path, leaf in pairs:
                self._add_leaf(path, leaf, float(weight), staged, scales)
            if self._table is not None:
                self._pending.append(staged)
                if self.rule == "majority":
                    self._scale_rows.append(scales)
                    self._scale_weights.append(float(weight))
            self._total_weight += float(weight)
            self._n_clients += 1
        if len(self._pending) >= self.chunk_c:
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
                seg_elems = n // segs
                seg_bytes = (seg_elems + 3) // 4 if segs == 1 else seg_elems // 4
                first = len(self._segments)
                for s in range(segs):
                    self._groups[(path, s)] = first + s
                    self._segments.append((seg_bytes, seg_elems))
                self._plans[path] = _LeafPlan(fused=True, shape=shape, dtype=leaf.dtype,
                                              n_segments=segs, scale_size=size, first=first,
                                              seg_bytes=seg_bytes, seg_elements=seg_elems)
                return
        self._plans[path] = _LeafPlan(fused=False)

    def _plan_table(self) -> None:
        """The segment table on the device, each fused leaf's output offset
        and staging copies, and the staging buffer for ``chunk_c`` clients."""
        if not self._segments:
            return
        table = fanin_table([b for b, _ in self._segments], [n for _, n in self._segments],
                            self.device)
        for plan in self._plans.values():
            if not plan.fused:
                continue
            plan.out_off = table.out_offsets[plan.first]
            runs = []
            for s in range(plan.n_segments):
                wire, stage = s * plan.seg_bytes, table.byte_offsets[plan.first + s]
                if runs and (runs[-1][0] + runs[-1][2], runs[-1][1] + runs[-1][2]) == (wire, stage):
                    runs[-1][2] += plan.seg_bytes     # contiguous in both: one copy
                else:
                    runs.append([wire, stage, plan.seg_bytes])
            plan.runs = tuple(tuple(r) for r in runs)
        self._table = table
        n_coeffs = 1 if self.rule == "majority" else table.n_segments
        cuda = self.device.type == "cuda"
        size = self.chunk_c * (table.row_bytes + 4 * n_coeffs)
        self._staging = torch.empty(size, dtype=torch.uint8, pin_memory=cuda)
        if cuda:
            self._staging_dev = torch.empty(size, dtype=torch.uint8, device=self.device)
            self._copied = torch.cuda.Event()
        if self.rule == "majority":
            self._slots = torch.tensor([-(-n // 4) * 4 for n in table.n_out], device=self.device)

    def _add_leaf(self, path: str, leaf, weight: float, staged, scales: np.ndarray) -> None:
        plan = self._plans[path]
        if plan.fused and not isinstance(leaf, TernaryTensor) and self.rule != "mean":
            raise ValueError(
                f"leaf {path!r}: mixed wire kinds under rule {self.rule!r} (only "
                "'mean' aggregates mixed-codec rounds; pin one codec per round "
                "for robust rules)")
        if not plan.fused or not isinstance(leaf, TernaryTensor):
            # a raw leaf, or (rule "mean") a mixed-codec round's non-ternary
            # record on a path planned fused: the mean is additive, so it
            # detours through the dense fallback and finalize sums both
            # routes; the client's kernel coefficients there stay 0.
            self._add_fallback(path, leaf, weight)
            return
        if tuple(int(s) for s in leaf.shape) != plan.shape:
            raise ValueError(f"leaf {path!r} changed shape mid-aggregation")
        scale = leaf.w_q.to(torch.float64).reshape(-1).numpy()
        if scale.size != plan.scale_size:
            raise ValueError(f"leaf {path!r} changed scale layout")
        staged[0].append((plan, leaf.packed.numpy().reshape(-1)))   # zero-copy view
        for s in range(plan.n_segments):
            seg_scale = float(scale[s if scale.size > 1 else 0])
            if self.rule == "majority":
                # votes are scale-free: the coefficient is the raw weight,
                # and the scale joins at finalize as a weighted median
                scales[plan.first + s] = seg_scale
            else:
                staged[1][plan.first + s] = weight * seg_scale

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

    def _flush(self) -> None:
        """Stage the pending clients (exactly their bytes, then their
        coefficients), move them in one copy and fold them in one launch."""
        c = len(self._pending)
        if c == 0:
            return
        table = self._table
        row = table.row_bytes
        k = self._pending[0][1].size
        nbytes = c * (row + 4 * k)
        with record_function("aggregator.stage"):
            if self._copied is not None:
                self._copied.synchronize()      # the last copy out of the buffer is done
            host = self._staging.numpy()
            for i, (leaves, coeffs) in enumerate(self._pending):
                dst = host[i * row:(i + 1) * row]
                for plan, packed in leaves:
                    for wire, stage, n in plan.runs:
                        dst[stage:stage + n] = packed[wire:wire + n]
            host[c * row:nbytes].view(np.float32).reshape(c, k)[:] = [
                coeffs for _, coeffs in self._pending]
        with record_function("aggregator.copy"):
            if self._staging_dev is None:
                buf = self._staging[:nbytes]     # the plain version reads it in place
            else:
                buf = self._staging_dev[:nbytes]
                buf.copy_(self._staging[:nbytes], non_blocking=True)
                self._copied.record()
        staged = buf[:c * row].view(c, row)
        coeffs = buf[c * row:].view(torch.float32).view(c, k)
        with record_function("aggregator.launch"):
            if self.rule == "majority":
                # a client's weight is its coefficient in every segment
                out = fanin_vote_counts_segments(staged, coeffs.reshape(c), table,
                                                 mesh=self.mesh)
                self._counts = out if self._counts is None else self._counts + out
            else:
                out = fanin_weighted_sum_segments(staged, coeffs, table, mesh=self.mesh)
                self._partial = out if self._partial is None else self._partial + out
        self._pending.clear()

    # -- result ------------------------------------------------------------

    @property
    def n_clients(self) -> int:
        """Client updates added since construction / the last reset."""
        return self._n_clients

    def reset(self) -> None:
        """Clear the accumulated state, keeping plans and staging buffers."""
        self._pending.clear()
        self._partial = None
        self._counts = None
        self._scale_rows.clear()
        self._scale_weights.clear()
        for acc in self._fallback.values():
            acc.zero_()
        self._fallback_touched.clear()
        for samples in self._client_dense.values():
            samples.clear()
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
        with record_function("aggregator.finalize"):
            out = self._finalize()
        if reset:
            self.reset()
        return out

    def _finalize(self) -> Pytree:
        inv = _f32(1.0 / self._total_weight)
        flat_all = self._partial
        if self.rule == "majority" and self._table is not None:
            flat_all = self._majority()
        pairs = []
        for path in self._paths:
            plan = self._plans[path]
            if plan.fused:
                n = plan.n_segments * plan.seg_elements
                flat = flat_all[plan.out_off:plan.out_off + n]   # the leaf's segments: a view
                if self.rule == "mean":
                    if path in self._fallback_touched:
                        flat = flat + self._fallback[path].reshape(-1)
                    flat = flat * inv
                leaf = flat.reshape(plan.shape).to(torch_dtype(plan.dtype))
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
        return tree_from_records(pairs)

    def _majority(self) -> torch.Tensor:
        """Every fused element decided at once: the plurality codes of the
        whole flat counts buffer times each segment's robust scale, the
        weighted median of the clients' scales for it (coordinate-wise, so
        one median over the (C, S) stack gives every segment's)."""
        votes = majority_from_counts(self._counts, self._total_weight)
        vals = torch.from_numpy(np.stack(self._scale_rows)).to(torch.float32)
        ws = torch.tensor(self._scale_weights, dtype=torch.float32)
        scales = weighted_median(vals, ws).to(self.device)
        return votes.to(torch.float32) * torch.repeat_interleave(scales, self._slots)
