"""Parameter, batch and cache sharding rules (port of
``repro.parallel.sharding``).

Layout on one pod: mesh ("data", "model").
  - TP over "model": attention QKV out-columns, MLP hidden, vocab, experts;
  - FSDP over "data": the other matrix axis of every weight;
  - EP over "model" for MoE expert stacks;
  - batch over "data" (and "pod" where present); long-context decode at
    batch 1 shards the KV cache's sequence axis over "data" instead.

Across pods: mesh ("pod", "data", "model"), parameters replicated over
"pod" (each pod is one of the paper's clients); the cross-pod gradient sync
is ``parallel.collectives``.

A spec is a ``PartitionSpec``: a tuple with one entry per tensor dim (an
axis name, a tuple of axis names, or None), or the empty tuple for a
replicated leaf, entry for entry the reference's ``PartitionSpec``. The
rules are path regexes to per-dim logical axes, resolved against the
actual shapes with the reference's divisibility guard (a dim is sharded
only where the mesh axis divides it). ``param_shardings`` turns the specs
into DTensor placements (``Shard(d)`` / ``Replicate()`` per mesh dim) on the
mesh's ``DeviceMesh``. ``axis_dim`` / ``axis_dims`` read off which dim of
each leaf a mesh axis shards (``model_dims`` for "model"): every rank holds
its chunk of each dim its spec names, over "model" (tensor parallelism)
and over "data" (FSDP), and computes on them (``parallel.tensor``).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

from repro_torch.configs.shapes import SHAPES
from repro_torch.models.transformer import ModelConfig, param_shapes
from repro_torch.tree import path_str, tree_map_with_path

Pytree = Any


class PartitionSpec(tuple):
    """Per-dim mesh axes of one tensor (a tree leaf, not a node). As JAX's
    does, it writes an entry of one axis name as that name, and of none as
    None."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


# (path regex, per-dim logical axes from the LAST dim backwards).
# "tp" → model axis; "fsdp" → data axis; "ep" → model axis; None → replicated.
# Leading unlisted dims (e.g. the stacked layer dim) are replicated.
_RULES: list[tuple[str, tuple]] = [
    (r"embed/table$",               ("tp", None)),        # vocab-parallel rows
    (r"lm_head$",                   ("fsdp", "tp")),
    (r"attn/w[qkv]$",               ("fsdp", "tp")),
    (r"attn/wo$",                   ("tp", "fsdp")),
    (r"mlp/w_(in|gate)$",           ("fsdp", "tp")),
    (r"mlp/w_out$",                 ("tp", "fsdp")),
    (r"moe/router$",                ("fsdp", None)),
    (r"moe/w_(in|gate)$",           ("ep", "fsdp", None)),   # (E, D, F)
    (r"moe/w_out$",                 ("ep", None, "fsdp")),   # (E, F, D)
    (r"moe/shared/w_(in|gate)$",    ("fsdp", "tp")),
    (r"moe/shared/w_out$",          ("tp", "fsdp")),
    (r"mamba/in_proj$",             ("fsdp", "tp")),
    (r"mamba/out_proj$",            ("tp", "fsdp")),
    (r"mamba/conv_w$",              (None, "tp")),
    # everything else (norms, biases, scalars, a_log, …): replicated.
]

_AXIS_MAP = {"tp": "model", "fsdp": "data", "ep": "model", None: None}


def mesh_sizes(mesh) -> dict:
    """Axis name → size of a ``Mesh`` or ``MeshSpec``."""
    return dict(zip(mesh.axis_names, mesh.shape))


def spec_for(path: str, shape: tuple, mesh_axis_sizes: dict) -> PartitionSpec:
    """The spec of one leaf: the first matching rule, each listed dim given
    its mesh axis where that axis divides it; ``P()`` where no rule matches."""
    for pat, dims in _RULES:
        if re.search(pat, path):
            ndim = len(shape)
            entries: list = [None] * ndim
            for i, logical in enumerate(reversed(dims)):
                d = ndim - 1 - i
                if d < 0:
                    break
                ax = _AXIS_MAP[logical]
                if ax is None:
                    continue
                if shape[d] % mesh_axis_sizes.get(ax, 1) == 0 and shape[d] > 0:
                    entries[d] = ax
            return P(*entries)
    return P()


def param_specs(cfg: ModelConfig, mesh) -> Pytree:
    """A ``PartitionSpec`` tree matching ``init_params(cfg)``."""
    sizes = mesh_sizes(mesh)
    return tree_map_with_path(lambda path, shape: spec_for(path_str(path), shape, sizes),
                              param_shapes(cfg), is_leaf=lambda x: isinstance(x, tuple))


def axis_dim(spec: PartitionSpec, axis: str = "model") -> int | None:
    """The tensor dim a spec shards over mesh axis ``axis``, or None."""
    for d, entry in enumerate(spec):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return d
    return None


def axis_dims(cfg: ModelConfig, mesh, axis: str) -> Pytree:
    """Per leaf of ``init_params(cfg)``, the dim mesh axis ``axis`` shards
    (None for a leaf whole over it): what the divisibility guard decided."""
    return tree_map_with_path(lambda _, spec: axis_dim(spec, axis), param_specs(cfg, mesh),
                              is_leaf=is_spec)


def model_dims(cfg: ModelConfig, mesh) -> Pytree:
    """``axis_dims`` of the "model" axis."""
    return axis_dims(cfg, mesh, "model")


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh; ``placements`` are its DTensor placements, one per
    mesh dim: ``Shard(d)`` where the spec puts that axis on tensor dim d,
    else ``Replicate()``."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        on = {}
        for d, entry in enumerate(self.spec):
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                if ax is not None:
                    on[ax] = d
        return tuple(Shard(on[a]) if a in on else Replicate() for a in self.mesh.axis_names)


def param_shardings(cfg: ModelConfig, mesh) -> Pytree:
    return tree_map_with_path(lambda _, spec: NamedSharding(mesh, spec),
                              param_specs(cfg, mesh), is_leaf=is_spec)


def logical_batch_axes(mesh) -> tuple:
    """The mesh axes that jointly carry the batch dimension."""
    return tuple(n for n in ("pod", "data") if n in mesh.axis_names)


def batch_specs(cfg: ModelConfig, shape_name: str, mesh) -> dict:
    """Specs of the input batch of a shape cell (``configs.SHAPES``)."""
    spec = SHAPES[shape_name]
    bax = logical_batch_axes(mesh)
    sizes = mesh_sizes(mesh)
    total = math.prod(sizes[a] for a in bax) if bax else 1
    bsz = spec.global_batch
    batch_axis = bax if bsz % max(total, 1) == 0 and bsz >= total else None

    def rows(*rest):
        return P(batch_axis, *rest) if batch_axis else P()

    out: dict = {}
    if spec.kind == "decode":
        out["tokens"] = rows(None)
        out["cache"] = cache_specs(cfg, mesh, batch_sharded=batch_axis is not None)
        out["pos"] = P()
    else:
        out["embeds" if cfg.family == "audio" else "tokens"] = (
            rows(None, None) if cfg.family == "audio" else rows(None))
        if spec.kind == "train":
            out["labels"] = rows(None)
    if cfg.family == "vlm":
        out["vision_embeds"] = rows(None, None)
    return out


def cache_specs(cfg: ModelConfig, mesh, *, batch_sharded: bool) -> dict:
    """KV and SSM cache specs. ``batch_sharded``: batch over ("pod",
    "data"), KV heads over "model" where divisible; otherwise (long
    context, batch 1) the SEQUENCE axis goes over "data" instead."""
    sizes = mesh_sizes(mesh)
    bax = logical_batch_axes(mesh)
    tp = sizes.get("model", 1)
    head_ax = "model" if cfg.n_kv_heads % tp == 0 and cfg.n_kv_heads >= tp else None
    # too few KV heads for the model axis: shard the sequence over "model"
    seq_ax_model = "model" if head_ax is None else None

    def kv():
        if batch_sharded:
            return P(None, bax, seq_ax_model, head_ax, None)
        return P(None, None, ("data",) if seq_ax_model is None else ("data", "model"),
                 head_ax, None)

    specs: dict = {}
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        specs["k"] = kv()
        specs["v"] = kv()
    if cfg.family in ("ssm", "hybrid"):
        conv_ch = cfg.ssm_expand * cfg.d_model + 2 * cfg.ssm_state
        specs["conv"] = P(None, bax if batch_sharded else None, None,
                          "model" if conv_ch % tp == 0 else None)
        specs["ssd"] = P(None, bax if batch_sharded else None,
                         "model" if cfg.ssm_heads % tp == 0 else None, None, None)
    if cfg.family == "hybrid":
        specs["attn_k"] = kv()
        specs["attn_v"] = kv()
    return specs
