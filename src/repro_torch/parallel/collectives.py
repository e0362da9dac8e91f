"""Ternary-compressed collectives: the paper's wire protocol applied to the
cross-pod gradient sync (port of ``repro.parallel.collectives``).

A ring all-reduce of fp32 gradients moves 2·(P−1)/P·4 B per element.
``ternary_allreduce`` instead, on every pod (rank of the ``"pod"`` group):

  1. FTTQ-quantizes its local tensor (denom = max|x| + 1e-12, threshold
     Δ = T_k · mean|x| / denom, the trained scale w_q), the client upload;
  2. packs it to 2 bits an element, four codes a byte;
  3. all-gathers the packed bytes and the w_q over the pod group
     (0.25·(P−1) B an element a rank receives);
  4. dequantizes and averages the P contributions locally,
     Σ_p w_q,p · (code_p − 1) / P, the server's aggregate, which every pod
     computes for itself.

Error feedback carries the quantization residual x − w_q·I_t into the next
step, as the reference does (``residual`` / ``new_residual``).

On the card the tree form runs the whole compressed part of a gradient tree
through two of the repo's kernels: ONE ``quantize_pack_segments`` launch per
rank covers every compressed leaf (one segment each; flat 4-codes-a-byte
packing, which for a contiguous leaf whose last dim is a multiple of 4 is
the reference's last-dim packing byte for byte), the dense reductions for
(denom, Δ) are plain, and the dequant-mean is ONE
``packed_weighted_sum_segments`` (``aggregate``) launch over the gathered
(P, bytes) rows with coefficients w_q,p, divided by P after the sum as the
reference divides its scanned total. The same kernel at C = 1 gives the
residual's reconstruction w_q·I_t. w_q comes from the kernel's moments,
Σ|x/denom|·denom / (count + 1e-8), where the reference sums |x| and adds
1e-12: equal within fp32 rounding, not bit for bit. Leaves the policy does
not compress (not ``is_quantizable``, or a last dim that is not a multiple
of 4) take an exact mean, one all-reduce for all of them.

The collectives (``all_reduce_``, ``all_gather``, ``all_to_all``) run over a
``torch.distributed`` group, or are the identity for ``None`` (an axis of
size 1). Rule: a CUDA tensor on a ``gloo`` group (several ranks sharing one
GPU, where NCCL will not go) is staged through a pinned host buffer, copied
back after the collective; every other case hands the tensor to the
backend as it is. Each collective adds the bytes a rank receives from the
others to ``wire_bytes()``, counted from its payload, not read from the
backend: an all-gather (P−1)·n, which is what any algorithm must deliver;
an all-reduce 2·(P−1)/P·n, an all-to-all and a reduce-scatter (P−1)/P·n,
a ring algorithm's counts, a model of the traffic (``gloo`` may move other
amounts).

``set_mesh`` / ``current_mesh`` hold the mesh that code below the trainer
reads without being handed it (the a2a MoE layer finds its expert-parallel
and batch subgroups there), as the reference's ``compat.set_mesh`` does.

Under tensor parallelism and FSDP each rank holds a shard of some leaves
(``shards``, a ``parallel.tensor.Shards``: the "model" and "data" axes
that cut each leaf) and the pods' ranks of one (data, model) index sync
the same shards. The scalars stay the whole leaf's, as in the reference
(its ``jnp.max``/``jnp.mean`` run on the GSPMD-sharded leaf): max|x| and
Σ|x| are all-reduced over every axis that cuts the leaf (MAX, SUM) before
the one quantize_pack launch writes them into the segment table, and each
leaf's w_q is its shards' kernel moments summed over those axes after it.
The compressed-leaf policy reads the whole leaf's shape. The launches per
rank stay one quantize_pack and two aggregate.

``ternary_allreduce_tree_plain`` is the plain PyTorch version of the whole
collective, the reference's arithmetic step by step with no kernel;
``pods_mean_plain`` is the same over a list of per-pod trees in one process.
"""

from __future__ import annotations

import collections
import contextlib
import math
from typing import Any, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.fttq import FTTQConfig, is_quantizable
from repro_torch.dtypes import flush_subnormal, flush_subnormal_, flushed_abs, flushed_op, xla_op
from repro_torch.kernels.aggregate import fanin_table, packed_weighted_sum_segments
from repro_torch.kernels.quantize_pack import n_tiles, quantize_pack_segments, segment_layout
from repro_torch.tree import flatten_with_path, path_str, tree_leaves, tree_map

Pytree = Any

_WIRE: collections.Counter = collections.Counter()
_CALLS: collections.Counter = collections.Counter()


def _count(kind: str, nbytes: int) -> None:
    _WIRE[kind] += nbytes
    _CALLS[kind] += 1


def wire_calls() -> dict:
    """Calls of each collective over a group of size > 1 since the last
    ``reset_wire_bytes``."""
    return dict(_CALLS)


def wire_bytes() -> dict:
    """Bytes this process received from other ranks, by collective, since
    the last ``reset_wire_bytes``: the all-gather's exact, the all-reduce's
    and the all-to-all's as a ring algorithm would receive them (a model,
    not the backend's measured traffic)."""
    return dict(_WIRE)


def reset_wire_bytes() -> None:
    _WIRE.clear()
    _CALLS.clear()


def compressed_bytes_per_element(n_pods: int) -> float:
    """Wire bytes a rank receives per gradient element of the ternary
    all-gather."""
    return 0.25 * (n_pods - 1)


_MESH: list = []


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` (a ``launch.mesh.Mesh``) the current one."""
    _MESH.append(mesh)
    try:
        yield mesh
    finally:
        _MESH.pop()


def current_mesh():
    """The innermost ``set_mesh``'s mesh, or None."""
    return _MESH[-1] if _MESH else None


# --------------------------------------------------------------------------
# Collectives over one group, with the gloo staging rule.
# --------------------------------------------------------------------------


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(t: torch.Tensor, group) -> bool:
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


_NARROW = (torch.bfloat16, torch.float16)


def all_reduce_(t: torch.Tensor, group, *, mean: bool = False, op: str = "sum") -> torch.Tensor:
    """In-place sum (or mean, or with ``op="max"`` maximum) of ``t`` over
    ``group``. A bf16 or fp16 sum over more than two ranks is taken in fp32
    and rounded once, as XLA promotes a narrow all-reduce to fp32; summed in
    ``t``'s dtype, each add would round (over two ranks that is the same
    single rounding, so the narrow tensor travels as it is)."""
    p = group_size(group)
    if p == 1:
        return t
    if op == "sum" and p > 2 and t.dtype in _NARROW:
        wide = t.to(torch.float32)
        all_reduce_(wide, group)
        t.copy_(wide)
        return t.div_(p) if mean else t
    buf = _host(t) if _staged(t, group) else t
    dist.all_reduce(buf, group=group, op=_OPS[op])
    if buf is not t:
        t.copy_(buf)
    _count("all_reduce", 2 * (p - 1) * t.numel() * t.element_size() // p)
    return t.div_(p) if mean else t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(P, *t.shape): every rank's ``t`` in group-rank order."""
    p = group_size(group)
    if p == 1:
        return t[None]
    staged = _staged(t, group)
    src = _host(t) if staged else t.contiguous()
    out = torch.empty((p,) + tuple(t.shape), dtype=t.dtype, device=src.device,
                      pin_memory=staged)
    dist.all_gather(list(out.unbind(0)), src, group=group)
    _count("all_gather", (p - 1) * t.numel() * t.element_size())
    return out.to(t.device) if staged else out


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all`` without its byte count."""
    staged = _staged(t, group)
    src = _host(t) if staged else t.contiguous()
    out = torch.empty_like(src, pin_memory=staged) if staged else torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(t.device) if staged else out


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """The tiled all-to-all along dim 0: chunk j of this rank's ``t`` goes to
    group rank j, and chunk i of the result came from group rank i."""
    p = group_size(group)
    if p == 1:
        return t
    out = _all_to_all(t, group)
    _count("all_to_all", (p - 1) * t.numel() * t.element_size() // p)
    return out


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's chunk along ``dim`` (in group-rank order) of the sum of
    every rank's ``t`` over ``group``. NCCL has the operation
    (``reduce_scatter_tensor``); ``gloo`` has none, so there it is the tiled
    all-to-all (chunk j of every rank to group rank j, staged as
    ``all_to_all`` stages a CUDA tensor) and a local sum of the P chunks
    received, added in group-rank order so that every run gives the same
    bits. A bf16 or fp16 sum is taken in fp32 and rounded once, as XLA's
    promoted all-reduce takes it (NCCL's is then in fp32 over more than
    two ranks). Adds (P−1)/P·n bytes of what crosses the wire to
    ``wire_bytes()["reduce_scatter"]``, a reduce-scatter's count."""
    p = group_size(group)
    if p == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    if dist.get_backend(group) == "gloo":
        parts = _all_to_all(x, group).unflatten(0, (p, -1))
        out = parts[0].to(torch.float32)
        for k in range(1, p):
            out += parts[k]
        out = out.to(x.dtype)
    elif p > 2 and x.dtype in _NARROW:
        out = reduce_scatter(x.to(torch.float32), group).to(x.dtype)
        return out.movedim(0, dim).contiguous()
    else:
        out = torch.empty((x.shape[0] // p,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, x, group=group)
    _count("reduce_scatter", (p - 1) * t.numel() * t.element_size() // p)
    return out.movedim(0, dim).contiguous()


# --------------------------------------------------------------------------
# The compressed mean on the kernels.
# --------------------------------------------------------------------------


def _restage(gathered: torch.Tensor, offsets: Sequence[int], nbytes: Sequence[int],
             table) -> torch.Tensor:
    """The gathered (P, bytes) rows moved from the encode's back-to-back
    layout to the fan-in table's 4-byte aligned one."""
    staged = torch.zeros((gathered.shape[0], table.row_bytes), dtype=torch.uint8,
                         device=gathered.device)
    for src, dst, n in zip(offsets, table.byte_offsets, nbytes):
        staged[:, dst:dst + n] = gathered[:, src:src + n]
    return staged


def collective_scalars(flat: Sequence[torch.Tensor], t_k: float,
                       axes: Sequence[tuple] = ()) -> torch.Tensor:
    """The (S, 2) segment table rows (denom = max|x| + 1e-12, Δ = T_k ·
    mean|x| / denom) of flat fp32 tensors, each a whole leaf or (where
    ``axes[i]`` names mesh axes) a shard whose max and Σ|x| are all-reduced
    over those axes first."""
    from repro_torch.parallel.tensor import reduce_over

    axes = list(axes) or [()] * len(flat)
    absx = [flushed_abs(f) for f in flat]
    mx = reduce_over([torch.linalg.vector_norm(a, float("inf")) for a in absx], axes, "max")
    l1 = reduce_over([torch.linalg.vector_norm(a, 1) for a in absx], axes)
    del absx
    n = [f.numel() * math.prod(a.size for a in ax) for f, ax in zip(flat, axes)]
    mx = torch.stack(mx) + 1e-12
    mean_abs = flushed_op(torch.div, torch.stack(l1),
                          torch.tensor(n, dtype=torch.float32, device=mx.device))
    delta = xla_op(torch.div, xla_op(torch.mul, t_k, mean_abs), mx)
    return torch.stack([mx, delta], dim=1).contiguous()


def _corrected(x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """x + residual as XLA adds them (operands and sum flushed), in a new
    tensor."""
    return flush_subnormal_(flush_subnormal(x).add_(flush_subnormal(residual)))


def _new_residual_(xf: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
    """xf − recon as XLA subtracts them, in xf's memory. xf is a corrected
    input (``_corrected``), already flushed, and recon = w_q · (code − 1)
    with w_q flushed, so no operand holds a subnormal: only the
    difference is flushed."""
    return flush_subnormal_(xf.sub_(recon))


def _compressed_mean(xs: Sequence[torch.Tensor], group, t_k: float, recon: bool,
                     axes: Sequence[tuple] = ()):
    """The mean over ``group`` of the ternary codes of every fp32 tensor in
    ``xs`` (each one segment; numel a multiple of 4): one quantize_pack
    launch, one all-gather of the bytes and of the w_q, one aggregate
    launch. Where ``axes[i]`` names mesh axes, a tensor is a shard over
    them and its (denom, Δ) and w_q are its whole leaf's. Returns (means,
    reconstructions w_q·I_t or None), fp32 tensors shaped as ``xs``."""
    flat = [x.reshape(-1) for x in xs]
    scal = collective_scalars(flat, t_k, axes)
    packed, moments, wq = quantize_pack_segments(flat, scal, with_scales=True)

    sizes = [f.numel() for f in flat]
    lay = segment_layout(sizes)
    at = [i for i, a in enumerate(axes) if a]
    if at:
        wq = _shard_scales(wq, moments, scal, lay, at, [axes[i] for i in at])
    nbytes = [n // 4 for n in sizes]
    table = fanin_table(nbytes, sizes, packed.device)
    gathered = all_gather(packed, group)
    wqs = all_gather(wq, group)
    staged = (gathered if tuple(lay.byte_offsets) == table.byte_offsets
              and lay.n_bytes == table.row_bytes
              else _restage(gathered, lay.byte_offsets, nbytes, table))
    # the fold's sum is flushed as XLA's scan adds; so is the division by P
    total = flush_subnormal_(packed_weighted_sum_segments(staged, wqs, table)
                             .div_(group_size(group)))
    means = [total[o:o + n].view(x.shape) for o, n, x in zip(table.out_offsets, sizes, xs)]
    if not recon:
        return means, None
    me = group_rank(group)
    own = packed_weighted_sum_segments(staged[me:me + 1], wq[None], table)
    return means, [own[o:o + n].view(x.shape) for o, n, x in zip(table.out_offsets, sizes, xs)]


def _shard_scales(wq, moments, scal, lay, at: list, axes: list) -> torch.Tensor:
    """``wq`` with the scales of the segments ``at`` (shards over
    ``axes``, one tuple each) made from their kernel moments summed over
    those axes (Σ|x/denom| and the selected count, in fp64 so the count
    stays exact)."""
    from repro_torch.parallel.tensor import reduce_over

    part = torch.stack(reduce_over(
        [torch.stack([moments[t:t + n_tiles(n), 0].sum().to(torch.float64),
                      moments[t:t + n_tiles(n), 1].sum().to(torch.float64)])
         for t, n in ((lay.tile_starts[i], lay.sizes[i]) for i in at)], axes))
    wq = wq.clone()
    num, cnt = part.to(torch.float32).unbind(1)
    wq[at] = xla_op(torch.mul, xla_op(torch.div, num, cnt + 1e-8), scal[at, 0])
    return wq


def ternary_allreduce(x: torch.Tensor, group, *, t_k: float = 0.7,
                      residual: torch.Tensor | None = None):
    """Mean over ``group`` of FTTQ-compressed tensors. Returns (mean in
    x.dtype, new_residual or None). Requires x.shape[-1] % 4 == 0 (the tree
    form takes an exact mean otherwise)."""
    if x.shape[-1] % 4:
        raise ValueError(f"ternary_allreduce: last dim {x.shape[-1]} is not a multiple of 4")
    xf = x.to(torch.float32)
    if residual is not None:
        xf = _corrected(xf, residual)
    (mean,), recon = _compressed_mean([xf.contiguous()], group, t_k, residual is not None)
    new_residual = _new_residual_(xf, recon[0]) if residual is not None else None
    return mean.to(x.dtype), new_residual


def compressed_leaf(path, leaf, cfg: FTTQConfig, last_dim: int | None = None) -> bool:
    """Whether the tree form compresses this leaf: the FTTQ policy's
    ``is_quantizable`` and a last dim (the whole leaf's, ``last_dim``, for a
    shard) that is a multiple of 4."""
    last = last_dim if last_dim is not None else (leaf.shape[-1] if leaf.ndim else 0)
    return is_quantizable(path, leaf, cfg) and leaf.ndim > 0 and last % 4 == 0


def _leaf_cuts(items, shards) -> list:
    """Each item's cuts ((MeshAxis, dim), ...): empty where whole."""
    return [shards.cuts.get(path_str(path), ()) if shards is not None else ()
            for path, _ in items]


def _whole_last(leaf, cut) -> int | None:
    if not cut:
        return None
    return leaf.shape[-1] * math.prod(a.size for a, d in cut if d == leaf.ndim - 1)


def ternary_allreduce_tree(grads: Pytree, group, *, cfg: FTTQConfig | None = None,
                           residuals: Pytree | None = None, error_feedback: bool = True,
                           shards=None):
    """``ternary_allreduce`` leaf-wise over a gradient tree: quantizable
    leaves whose last dim is a multiple of 4 take the compressed path (all
    of them in one quantize_pack and one aggregate launch), the rest an
    exact mean (one all-reduce). The leaves that ``shards`` (a
    ``parallel.tensor.Shards``) cuts are this rank's shards, quantized with
    their whole leaf's scalars. Returns (synced grads, new residuals):
    zeros where a leaf has none, as the reference returns them."""
    cfg = cfg or FTTQConfig()
    items = flatten_with_path(grads)
    cuts = _leaf_cuts(items, shards)
    res = tree_leaves(residuals) if residuals is not None else [None] * len(items)
    out: list = [None] * len(items)
    new_res: list = [None] * len(items)
    comp = [i for i, (path, leaf) in enumerate(items)
            if compressed_leaf(path, leaf, cfg, _whole_last(leaf, cuts[i]))]
    exact = sorted(set(range(len(items))) - set(comp))

    if comp:
        xfs = []
        for i in comp:
            leaf = items[i][1]
            r = res[i] if error_feedback and res[i] is not None else (
                torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.device)
                if error_feedback else None)
            xf = leaf.to(torch.float32)
            xfs.append((_corrected(xf, r) if r is not None else xf).contiguous())
        means, recons = _compressed_mean(xfs, group, cfg.t_k, error_feedback,
                                         [tuple(a for a, _ in cuts[i]) for i in comp])
        for k, i in enumerate(comp):
            leaf = items[i][1]
            out[i] = means[k].to(leaf.dtype)
            new_res[i] = (_new_residual_(xfs[k], recons[k]) if error_feedback else
                          torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.device))
        del xfs, means, recons
    if exact:
        flat = flush_subnormal_(torch.cat([items[i][1].reshape(-1).to(torch.float32)
                                           for i in exact]))
        # pmean as XLA forms it: the flushed sum, then the flushed quotient
        flush_subnormal_(flush_subnormal_(all_reduce_(flat, group)).div_(group_size(group)))
        at = 0
        for i in exact:
            leaf = items[i][1]
            out[i] = flat[at:at + leaf.numel()].view(leaf.shape).to(leaf.dtype)
            new_res[i] = torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.device)
            at += leaf.numel()
    return _rebuild(grads, out), _rebuild(grads, new_res)


def _rebuild(tree: Pytree, leaves: list) -> Pytree:
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


# --------------------------------------------------------------------------
# The plain PyTorch version: the reference's arithmetic, no kernel.
# --------------------------------------------------------------------------


def quantize_lastdim_plain(x: torch.Tensor, t_k: float, scalars=None):
    """The reference's ``_quantize_lastdim`` on fp32 x: (packed bytes along
    the last dim, w_q, reconstruction w_q·I_t). ``scalars``: a shard's
    whole-leaf (max|x| + 1e-12, Δ, w_q) (``shard_scalars_plain``)."""
    absx = flushed_abs(x)
    if scalars is None:
        mx = absx.max() + 1e-12
        delta = xla_op(torch.div, xla_op(torch.mul, t_k, flush_subnormal(absx.mean())), mx)
    else:
        mx, delta, w_q = scalars
    xs = xla_op(torch.div, x, mx)
    sel = xs.abs() > delta
    i_t = torch.where(sel, torch.sign(xs), 0.0)
    if scalars is None:
        w_q = flushed_op(torch.div, torch.where(sel, absx, 0.0).sum(), sel.sum() + 1e-12)
    c = (i_t.to(torch.int8) + 1).to(torch.uint8).reshape(*x.shape[:-1], x.shape[-1] // 4, 4)
    packed = c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4) | (c[..., 3] << 6)
    return packed, w_q.to(torch.float32), (w_q * i_t).to(x.dtype)


def shard_scalars_plain(xs: Sequence[torch.Tensor], t_k: float, axes: tuple) -> list:
    """(max|x| + 1e-12, Δ, w_q) of every pod's whole leaf, from this rank's
    shards ``xs`` (one per pod, fp32) and the other ranks' over ``axes``
    (the ``MeshAxis`` tuple that cuts the leaf): the reference's
    ``_quantize_lastdim`` scalars on the whole leaf."""
    from repro_torch.parallel.tensor import reduce_over

    absx = [flushed_abs(x) for x in xs]
    (mx,) = reduce_over([torch.stack([a.max() for a in absx])], [axes], "max")
    (total,) = reduce_over([torch.stack([a.sum() for a in absx])], [axes])
    mx = mx + 1e-12
    mean = flushed_op(torch.div, total, xs[0].numel() * math.prod(a.size for a in axes))
    delta = xla_op(torch.div, xla_op(torch.mul, t_k, mean), mx)
    sel = [xla_op(torch.div, x, m).abs() > d for x, m, d in zip(xs, mx, delta)]
    part = torch.stack([torch.stack([torch.where(s, a, 0.0).sum(), s.sum().to(torch.float32)])
                        for s, a in zip(sel, absx)])
    (part,) = reduce_over([part], [axes])
    num, cnt = part.unbind(1)
    return list(zip(mx, delta, flushed_op(torch.div, num, cnt + 1e-12)))


def unpack_lastdim_plain(packed: torch.Tensor) -> torch.Tensor:
    """Packed last-dim bytes → fp32 I_t in {-1, 0, 1} (the reference's
    ``_unpack_lastdim``)."""
    codes = torch.stack([(packed >> s) & 3 for s in (0, 2, 4, 6)], dim=-1)
    return (codes.to(torch.int8) - 1).reshape(*packed.shape[:-1], -1).to(torch.float32)


def leaf_mean_plain(xs: Sequence[torch.Tensor], *, t_k: float, compressed: bool,
                    residuals: Sequence[torch.Tensor] | None = None, axes: tuple = ()):
    """One leaf's synced value from every pod's copy ``xs`` (pod order), as
    the reference computes it: the compressed mean (a scan over pods from
    zeros, then / P) with the per-pod new residuals, or the exact mean and
    zero residuals. With ``axes``, ``xs`` are shards over those mesh axes,
    quantized with their whole leaf's scalars. Returns (mean in the leaf's
    dtype, new residual per pod)."""
    p = len(xs)

    def zeros(x):
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)

    if not compressed:
        total = xs[0]
        for x in xs[1:]:
            total = xla_op(torch.add, total, x)
        return xla_op(torch.div, total, p), [zeros(x) for x in xs]
    total = torch.zeros(xs[0].shape, dtype=torch.float32, device=xs[0].device)
    new_res = []
    xfs = [_corrected(x.to(torch.float32), residuals[k]) if residuals is not None
           else x.to(torch.float32) for k, x in enumerate(xs)]
    scalars = shard_scalars_plain(xfs, t_k, axes) if axes else [None] * p
    for k, x in enumerate(xs):
        xf = xfs[k]
        packed, w_q, recon = quantize_lastdim_plain(xf, t_k, scalars[k])
        new_res.append(_new_residual_(xf, recon) if residuals is not None else zeros(x))
        total = xla_op(torch.add, total, w_q * unpack_lastdim_plain(packed))
    return xla_op(torch.div, total, p).to(xs[0].dtype), new_res


def pods_mean_plain(grads_per_pod: Sequence[Pytree], *, cfg: FTTQConfig | None = None,
                    residuals_per_pod: Sequence[Pytree] | None = None,
                    error_feedback: bool = True):
    """``ternary_allreduce_tree`` over P pods' gradient trees held in one
    process, in plain PyTorch. Returns (synced tree, [new residuals per
    pod])."""
    cfg = cfg or FTTQConfig()
    items = [flatten_with_path(g) for g in grads_per_pod]
    res = ([tree_leaves(r) for r in residuals_per_pod] if residuals_per_pod is not None
           else None)
    out, new_res = [], [[] for _ in grads_per_pod]
    for j, (path, leaf) in enumerate(items[0]):
        xs = [it[j][1] for it in items]
        comp = compressed_leaf(path, leaf, cfg)
        rs = None
        if comp and error_feedback:
            rs = ([r[j] for r in res] if res is not None else
                  [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in xs])
        mean, nr = leaf_mean_plain(xs, t_k=cfg.t_k, compressed=comp, residuals=rs)
        out.append(mean)
        for k, r in enumerate(nr):
            new_res[k].append(r)
    tree = grads_per_pod[0]
    return _rebuild(tree, out), [_rebuild(tree, r) for r in new_res]


def ternary_allreduce_tree_plain(grads: Pytree, group, *, cfg: FTTQConfig | None = None,
                                 residuals: Pytree | None = None,
                                 error_feedback: bool = True, shards=None):
    """The plain version of ``ternary_allreduce_tree`` across ranks: each
    leaf's fp32 copies (and residuals) gathered from every pod, then
    ``leaf_mean_plain`` (a shard's with its whole leaf's scalars); this
    rank keeps its own pod's new residual. Returns what
    ``ternary_allreduce_tree`` returns."""
    cfg = cfg or FTTQConfig()
    me = group_rank(group)
    items = flatten_with_path(grads)
    cuts = _leaf_cuts(items, shards)
    res = tree_leaves(residuals) if residuals is not None else [None] * len(items)
    out, new_res = [], []
    for (path, leaf), r, cut in zip(items, res, cuts):
        comp = compressed_leaf(path, leaf, cfg, _whole_last(leaf, cut))
        xs = list(all_gather(leaf, group).unbind(0))
        rs = None
        if comp and error_feedback:
            r = r if r is not None else torch.zeros(leaf.shape, dtype=torch.float32,
                                                    device=leaf.device)
            rs = list(all_gather(r, group).unbind(0))
        mean, nr = leaf_mean_plain(xs, t_k=cfg.t_k, compressed=comp, residuals=rs,
                                   axes=tuple(a for a, _ in cut))
        out.append(mean)
        new_res.append(nr[me])
        del xs, rs
    return _rebuild(grads, out), _rebuild(grads, new_res)
