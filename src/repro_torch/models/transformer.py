"""The model zoo's LM, every family of the reference (port of
``repro.models.transformer``):

  dense  — granite-20b, gemma3-4b (5:1 local:global sliding window),
           olmo-1b (non-parametric LN), yi-9b
  moe    — qwen3-moe-30b-a3b (128e top-8), deepseek-moe-16b (2 shared + 64 top-6)
  ssm    — mamba2-370m (SSD)
  hybrid — zamba2-1.2b (Mamba2 backbone + ONE shared attention block applied
           before every ``attn_every``-th layer, one KV cache slot per
           application)
  vlm    — llama-3.2-vision-11b (a gated cross-attention layer after every
           ``cross_every``-th layer, over patch embeddings)
  audio  — hubert-xlarge (encoder-only; the inputs are frame embeddings)

Parameters are nested dicts of tensors with the reference's keys and
layouts, layers stacked on a leading axis: ``embed/table`` (V, D);
``blocks`` — ``attn/{wq,wk,wv,wo}`` and ``mlp/{w_in,w_gate,w_out}`` in
(in, out) layout, or ``moe/{router,w_in,w_gate,w_out,shared}``, or
``mamba/*`` — with ``attn_norm``/``mlp_norm`` (or ``norm``) for parametric
norms; ``cross`` (vlm) and ``shared_attn`` (hybrid); ``final_norm`` and
``lm_head`` unless embeddings are tied. ``forward`` walks the stacked
layers with a Python loop where the reference scans, and writes a given
cache in place.

Tensor parallelism (``tp``, a ``parallel.tensor.MeshAxis``; every family):
the params are this rank's shards (``init_params(..., mesh=)``); attention
and the MLP are column- then row-parallel; ``embed/table`` is split by vocab
rows, so the lookup reads the rank's rows (zero for ids it does not hold)
and sums over the axis, and the logits (tied or ``lm_head``) are the rank's
vocab columns, which ``loss_fn`` reduces with a vocab-parallel cross
entropy. The MoE layers run the rank's experts on the replicated tokens
(``models.moe``); the Mamba2 layers gather their sharded weights and compute
whole, but decode on the rank's own heads from a cache cut over "model"
(``models.mamba2``); the hybrid's shared block is attention and MLP
under ``tp``, one set of shards for all its applications. Where the
divisibility guard leaves a leaf whole, it is computed whole on every rank
(the per-layer "model" dims come from ``parallel.sharding.model_dims``).
The all-to-all MoE (``moe_impl="a2a"``) with EP over "model" runs on the
rank's own expert stacks and the replicated tokens (``models.moe_a2a``).

FSDP (``fsdp``, the mesh's "data" axis): the params are also cut over
"data" where their specs say so, and each remat unit gathers its layer's
data-sharded leaves (``parallel.tensor.gather_layer``: all-gather forward,
reduce-scatter backward) before it computes, as do the vlm's cross layer,
the hybrid's shared block at each application and ``lm_head`` where they
are used; the layers then see whole leaves over "data" (the MoE's router
and expert stacks, Mamba2's projections, which gather over "model" after).
Under remat "full" the backward gathers again, so no rank holds every
layer's whole weights at once. Each rank runs the rows it is given; a
serving step (``launch.steps``) gives it its block of the batch's rows and
a cache cut as ``init_cache`` says (``seq``: the axes that cut its
sequence, over which attention combines its partial softmax).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.device import resolve_device
from repro_torch.dtypes import torch_dtype
from repro_torch.kernels.repack import PackedTernary
from repro_torch.models import mamba2 as mb
from repro_torch.models.attention import GLOBAL_WINDOW, attention, init_attn
from repro_torch.models.common import apply_norm, dense_init, embed_init, matmul
from repro_torch.models.elementwise import residual_add, tanh
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.moe import init_moe, moe, split_axis
from repro_torch.models.moe_a2a import moe_a2a
from repro_torch.parallel.collectives import current_mesh
from repro_torch.parallel.tensor import (
    copy_to_model, gather_from_data, gather_from_model, gather_layer, model_axis,
    reduce_from_model, sharded, vocab_parallel_ce,
)
from repro_torch.tree import path_str, tree_leaves, tree_map, tree_map_with_path

Pytree = Any
BIG_WINDOW = GLOBAL_WINDOW
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
_ATTN_FAMILIES = ("dense", "moe", "vlm", "audio")
TP_FAMILIES = FAMILIES


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's model configuration, field for field (see
    ``repro.models.transformer.ModelConfig``). ``remat`` recomputes each
    layer in the backward pass of a forward without a cache: ``"full"``
    keeps only the layer's inputs, ``"dots"`` also keeps its matmul
    outputs; both give the numbers of ``"none"``. ``moe_impl="a2a"`` with
    ``mesh_ep_axis`` set runs the MoE layers through ``models.moe_a2a``
    over the EP subgroup: the "model" axis a tensor-parallel forward is
    given where ``mesh_ep_axis`` is "model", else that axis of the mesh made
    current by ``parallel.collectives.set_mesh`` (each rank passing its own
    rows of the batch; the load loss is averaged over the forward's batch
    axes, or ``mesh_batch_axes``); with neither it runs on the one rank.
    The scatter dispatch ignores the mesh fields."""

    name: str
    family: str                      # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    vocab_size: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    norm: str = "rmsnorm"            # rmsnorm|layernorm|nonparam
    activation: str = "silu"
    gated_mlp: bool = True
    rope_theta: float = 10000.0
    use_rope: bool = True
    causal: bool = True              # False → encoder-only
    tie_embeddings: bool = False
    # sliding window (gemma3)
    sliding_window: int = 0          # 0 = all-global
    global_every: int = 0            # every Nth layer is global
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    # ssm / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_heads: int = 0
    conv_width: int = 4
    ssm_chunk: int = 128
    attn_every: int = 0              # hybrid: shared attn before every Nth layer
    # vlm
    cross_every: int = 0
    n_patches: int = 0
    # training
    aux_loss_coef: float = 0.01
    remat: str = "none"              # none|full|dots
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # distribution (the reference's mesh settings; one device ignores them)
    mesh_batch_axes: tuple = ()
    mesh_ep_axis: str = ""
    moe_impl: str = "gspmd"          # gspmd | a2a (expert parallel over mesh_ep_axis)
    moe_wire: str = "bf16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    @property
    def n_cross(self) -> int:
        return self.n_layers // self.cross_every if self.cross_every else 0

    @property
    def n_attn_apps(self) -> int:
        if not self.attn_every:
            return 0
        return (self.n_layers + self.attn_every - 1) // self.attn_every

    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


@functools.lru_cache(maxsize=16)
def _axis_dims(cfg: ModelConfig, size: int, axis: str = "model") -> dict:
    """The dim each leaf of ``init_params(cfg)`` is cut on by a mesh axis
    ``axis`` of ``size`` (None where whole), as
    ``parallel.sharding.axis_dims`` decides it, with the stacked layer dim
    of ``blocks`` and ``cross`` taken off (the dims of one layer)."""
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.parallel.sharding import axis_dims

    dims = axis_dims(cfg, MeshSpec((size,), (axis,)), axis)
    for key in ("blocks", "cross"):
        if key in dims:
            dims[key] = tree_map(lambda d: None if d is None else d - 1, dims[key])
    return dims


def _layer_dims(cfg: ModelConfig, size: int) -> dict:
    """The "model" dim of each leaf of one layer of ``blocks`` under a
    "model" axis of ``size``."""
    return _axis_dims(cfg, size)["blocks"]


def _vocab_tp(cfg: ModelConfig, tp):
    """``tp`` where the guard splits the vocabulary over it, else None."""
    return tp if tp is not None and cfg.vocab_size % tp.size == 0 else None


# --------------------------------------------------------------------------
# Per-layer static patterns.
# --------------------------------------------------------------------------


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer attention lookback window (BIG = global)."""
    w = np.full((cfg.n_layers,), BIG_WINDOW, np.int32)
    if cfg.sliding_window:
        w[:] = cfg.sliding_window
        if cfg.global_every:
            w[cfg.global_every - 1::cfg.global_every] = BIG_WINDOW
    return w


def cross_gates(cfg: ModelConfig) -> np.ndarray:
    """1 after the layers a cross-attention layer follows."""
    g = np.zeros((cfg.n_layers,), np.int32)
    if cfg.cross_every:
        g[cfg.cross_every - 1::cfg.cross_every] = 1
    return g


def attn_flags(cfg: ModelConfig) -> np.ndarray:
    """1 before the layers the hybrid's shared attention block precedes."""
    f = np.zeros((cfg.n_layers,), np.int32)
    if cfg.attn_every:
        f[0::cfg.attn_every] = 1
    return f


# --------------------------------------------------------------------------
# Shapes and init.
# --------------------------------------------------------------------------


def _attn_shapes(cfg: ModelConfig, lead: tuple) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {"wq": lead + (d, cfg.n_heads * hd), "wk": lead + (d, cfg.n_kv_heads * hd),
            "wv": lead + (d, cfg.n_kv_heads * hd), "wo": lead + (cfg.n_heads * hd, d)}


def _mlp_shapes(cfg: ModelConfig, lead: tuple) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    shapes = {"w_in": lead + (d, f), "w_out": lead + (f, d)}
    if cfg.gated_mlp:
        shapes["w_gate"] = lead + (d, f)
    return shapes


def _moe_shapes(cfg: ModelConfig, lead: tuple) -> dict:
    d, e, f, fs = cfg.d_model, cfg.n_experts, cfg.moe_d_ff, cfg.shared_d_ff
    shapes = {"router": lead + (d, e), "w_gate": lead + (e, d, f),
              "w_in": lead + (e, d, f), "w_out": lead + (e, f, d)}
    if cfg.n_shared_experts > 0:
        shapes["shared"] = {"w_gate": lead + (d, fs), "w_in": lead + (d, fs),
                            "w_out": lead + (fs, d)}
    return shapes


def _mamba_shapes(cfg: ModelConfig, lead: tuple) -> dict:
    d, n, h = cfg.d_model, cfg.ssm_state, cfg.ssm_heads
    d_in = mb.d_inner_of(d, cfg.ssm_expand)
    return {"in_proj": lead + (d, 2 * d_in + 2 * n + h),
            "conv_w": lead + (cfg.conv_width, d_in + 2 * n),
            "a_log": lead + (h,), "dt_bias": lead + (h,), "d_skip": lead + (h,),
            "gate_norm": lead + (d_in,), "out_proj": lead + (d_in, d)}


def _with_norms(cfg: ModelConfig, block: dict, lead: tuple, names) -> dict:
    if cfg.norm != "nonparam":
        for key in names:
            block[key] = lead + (cfg.d_model,)
    return block


def param_shapes(cfg: ModelConfig, mesh=None) -> dict:
    """The parameter tree's shapes, without allocating it; with a ``mesh``
    whose "model" or "data" axis has size > 1, the shapes of this rank's
    shards."""
    if sharded(mesh):
        from repro_torch.parallel.tensor import local_shape

        return tree_map_with_path(lambda p, shape: local_shape(path_str(p), shape, mesh),
                                  param_shapes(cfg), is_leaf=lambda x: isinstance(x, tuple))
    _check_family(cfg)
    l = (cfg.n_layers,)
    shapes: dict = {"embed": {"table": (cfg.vocab_size, cfg.d_model)}}
    if cfg.family in _ATTN_FAMILIES:
        block = {"attn": _attn_shapes(cfg, l)}
        if cfg.family == "moe":
            block["moe"] = _moe_shapes(cfg, l)
        else:
            block["mlp"] = _mlp_shapes(cfg, l)
        shapes["blocks"] = _with_norms(cfg, block, l, ("attn_norm", "mlp_norm"))
    else:
        shapes["blocks"] = _with_norms(cfg, {"mamba": _mamba_shapes(cfg, l)}, l, ("norm",))
    if cfg.family == "vlm":
        c = (cfg.n_cross,)
        shapes["cross"] = _with_norms(
            cfg, {"attn": _attn_shapes(cfg, c), "mlp": _mlp_shapes(cfg, c),
                  "gate_attn": c, "gate_mlp": c}, c, ("attn_norm", "mlp_norm"))
    if cfg.family == "hybrid":
        shapes["shared_attn"] = _with_norms(
            cfg, {"attn": _attn_shapes(cfg, ()), "mlp": _mlp_shapes(cfg, ())}, (),
            ("attn_norm", "mlp_norm"))
    if cfg.norm != "nonparam":
        shapes["final_norm"] = (cfg.d_model,)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.d_model, cfg.vocab_size)
    return shapes


def param_count(cfg: ModelConfig) -> int:
    shapes = tree_leaves(param_shapes(cfg), is_leaf=lambda x: isinstance(x, tuple))
    return sum(math.prod(s) for s in shapes)


def _zeros(shape, dtype, dev) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=dev)


def _add_norms(cfg: ModelConfig, block: dict, lead: tuple, names, dtype, dev) -> dict:
    if cfg.norm != "nonparam":
        for key in names:
            block[key] = _zeros(lead + (cfg.d_model,), dtype, dev)
    return block


def init_params(cfg: ModelConfig, seed: int = 0, device: str | torch.device = "cuda",
                mesh=None) -> Pytree:
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device``: embeddings N(0, 0.02²), matrices Lecun-normal,
    norm scales and cross-attention gates zero, the SSM's a_log and dt_bias
    zero and d_skip one (the reference's initializers, not its bits). With
    a ``mesh`` whose "model" or "data" axis has size > 1, this rank's shards
    of the same draws (``param_shapes(cfg, mesh)``)."""
    if sharded(mesh):
        from repro_torch.parallel.sharding import param_specs
        from repro_torch.parallel.tensor import shard_tree

        return shard_tree(init_params(cfg, seed, device), param_specs(cfg, mesh), mesh)
    dev = resolve_device(device)
    _check_family(cfg)
    dtype = cfg.pdtype()
    gen = torch.Generator(device=dev).manual_seed(seed)
    hd, d, nl = cfg.resolved_head_dim, cfg.d_model, cfg.n_layers
    params: dict = {"embed": {"table": embed_init(gen, (cfg.vocab_size, d), dtype)}}
    if cfg.family in _ATTN_FAMILIES:
        blocks = {"attn": init_attn(gen, d, cfg.n_heads, cfg.n_kv_heads, hd, dtype, nl)}
        if cfg.family == "moe":
            blocks["moe"] = init_moe(gen, d, cfg.moe_d_ff, cfg.n_experts,
                                     cfg.n_shared_experts, cfg.shared_d_ff, dtype, nl)
        else:
            blocks["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.gated_mlp, dtype, nl)
        params["blocks"] = _add_norms(cfg, blocks, (nl,), ("attn_norm", "mlp_norm"),
                                      dtype, dev)
    else:
        blocks = {"mamba": mb.init_mamba(gen, d, cfg.ssm_heads, cfg.ssm_state,
                                         cfg.ssm_expand, cfg.conv_width, dtype, nl)}
        params["blocks"] = _add_norms(cfg, blocks, (nl,), ("norm",), dtype, dev)
    if cfg.family == "vlm":
        nc = cfg.n_cross
        cross = {"attn": init_attn(gen, d, cfg.n_heads, cfg.n_kv_heads, hd, dtype, nc),
                 "mlp": init_mlp(gen, d, cfg.d_ff, cfg.gated_mlp, dtype, nc),
                 "gate_attn": _zeros((nc,), dtype, dev), "gate_mlp": _zeros((nc,), dtype, dev)}
        params["cross"] = _add_norms(cfg, cross, (nc,), ("attn_norm", "mlp_norm"), dtype, dev)
    if cfg.family == "hybrid":
        shared = {"attn": init_attn(gen, d, cfg.n_heads, cfg.n_kv_heads, hd, dtype),
                  "mlp": init_mlp(gen, d, cfg.d_ff, cfg.gated_mlp, dtype)}
        params["shared_attn"] = _add_norms(cfg, shared, (), ("attn_norm", "mlp_norm"),
                                           dtype, dev)
    if cfg.norm != "nonparam":
        params["final_norm"] = _zeros((d,), dtype, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab_size), dtype)
    return params


# --------------------------------------------------------------------------
# Cache.
# --------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device: str | torch.device = "cuda", mesh=None) -> Pytree:
    """Decode cache for a global batch of ``batch`` rows; its structure
    depends on the family: stacked (L, B, S_max, Hkv, hd) keys and values
    for attention layers, (L, B, W-1, C) conv windows and (L, B, H, P, N)
    float32 SSD states for Mamba layers, and (A, B, S_max, Hkv, hd) per
    shared-attention application. With a ``mesh``, this rank's part as
    ``parallel.sharding.cache_specs`` places it
    (``parallel.tensor.serve_layout``): B is the rank's rows where the batch
    divides over ("pod", "data"); Hkv its kv heads where they divide over
    "model"; S_max its slots where "model" (fewer kv heads than ranks) or
    "data" (a batch that does not divide) cuts the sequence; the conv
    window's d_in + 2N channels and the SSD state's heads their contiguous
    block, each where it divides over "model" (the reference's
    ``shard_shape``; ``models.mamba2`` decodes on them)."""
    from repro_torch.parallel.tensor import linear_rank, serve_layout

    dev = resolve_device(device)
    _check_family(cfg)
    lay = serve_layout(cfg, mesh, batch)
    rows = batch // lay.n_rows
    _, n_seq = linear_rank(lay.seq)
    if max_seq % n_seq:
        raise ValueError(f"a cache of {max_seq} slots does not divide over the "
                         f"{n_seq} ranks that cut its sequence")
    slots = max_seq // n_seq
    dtype = dtype or cfg.cdtype()
    hd, nl = cfg.resolved_head_dim, cfg.n_layers
    n_kv = cfg.n_kv_heads // mesh.size("model") if lay.heads else cfg.n_kv_heads
    cache: dict = {}
    if cfg.family in _ATTN_FAMILIES:
        shape = (nl, rows, slots, n_kv, hd)
        cache["k"] = _zeros(shape, dtype, dev)
        cache["v"] = _zeros(shape, dtype, dev)
    else:
        d_in = mb.d_inner_of(cfg.d_model, cfg.ssm_expand)
        p = d_in // cfg.ssm_heads
        tp = mesh.size("model") if mesh is not None else 1
        conv_ch = (d_in + 2 * cfg.ssm_state) // (tp if lay.conv else 1)
        cache["conv"] = _zeros((nl, rows, cfg.conv_width - 1, conv_ch), dtype, dev)
        cache["ssd"] = _zeros((nl, rows, cfg.ssm_heads // (tp if lay.ssd else 1), p,
                               cfg.ssm_state), torch.float32, dev)
    if cfg.family == "hybrid":
        shape = (cfg.n_attn_apps, rows, slots, n_kv, hd)
        cache["attn_k"] = _zeros(shape, dtype, dev)
        cache["attn_v"] = _zeros(shape, dtype, dev)
    return cache


# --------------------------------------------------------------------------
# Layer bodies.
# --------------------------------------------------------------------------


def _layer(stack: dict, i: int) -> dict:
    return tree_map(lambda t: t.layer(i) if isinstance(t, PackedTernary) else t[i],
                    stack, is_leaf=lambda x: isinstance(x, PackedTernary))


def _attn_kwargs(cfg: ModelConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                use_rope=cfg.use_rope, causal=cfg.causal)


def _mlp_tp(cfg: ModelConfig, tp):
    """``tp`` where the guard splits the MLP's hidden units over it."""
    return tp if tp is not None and cfg.d_ff % tp.size == 0 else None


def _moe_a2a(cfg: ModelConfig, p: dict, h, tp, dims, dp):
    """The all-to-all MoE over the EP axis ``cfg.mesh_ep_axis``: the
    "model" axis ``tp`` where that is it (the stacks then the rank's own
    experts), else that axis of the mesh made current by
    ``parallel.collectives.set_mesh`` (none: one rank). The load loss is
    averaged over ``dp``'s groups, else over ``cfg.mesh_batch_axes`` of the
    current mesh."""
    mesh = current_mesh()
    group = mesh.group if mesh is not None else (lambda _: None)
    ep = tp if tp is not None and cfg.mesh_ep_axis == "model" else None
    cut = ep is not None and dims["w_in"] is not None
    data = dp.groups if dp is not None else tuple(group(a) for a in cfg.mesh_batch_axes)
    return moe_a2a(p, h, top_k=cfg.top_k, n_experts=cfg.n_experts,
                   capacity_factor=cfg.capacity_factor, activation=cfg.activation,
                   ep_group=ep.group if ep is not None else group(cfg.mesh_ep_axis),
                   data_groups=data, wire_dtype=cfg.moe_wire,
                   expert_lo=ep.share(cfg.n_experts)[0] if cut else 0, tp=ep,
                   shared_tp=split_axis(tp, dims, "shared", "w_in"))


def _dense_layer(cfg: ModelConfig, bp: dict, x, window: int, kv, pos: int, tp=None,
                 dp=None, seq: tuple = ()):
    """One dense/moe/vlm/audio layer; kv = (k, v) cache slices or None.
    Returns (x, aux) with aux the MoE loss (0 for the other families)."""
    h = apply_norm(x, bp.get("attn_norm"), cfg.norm)
    attn_out, _ = attention(bp["attn"], h, window=window, cache=kv, pos=pos, tp=tp, seq=seq,
                            **_attn_kwargs(cfg))
    x = residual_add(x, attn_out)
    h = apply_norm(x, bp.get("mlp_norm"), cfg.norm)
    if cfg.family == "moe":
        dims = _layer_dims(cfg, tp.size)["moe"] if tp is not None else None
        if cfg.moe_impl == "a2a" and cfg.mesh_ep_axis:
            mo, aux = _moe_a2a(cfg, bp["moe"], h, tp, dims, dp)
        else:
            mo, aux = moe(bp["moe"], h, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                          activation=cfg.activation, tp=tp, dims=dims, dp=dp)
        return residual_add(x, mo), aux
    return residual_add(x, mlp(bp["mlp"], h, cfg.activation, _mlp_tp(cfg, tp))), None


def _cross_layer(cfg: ModelConfig, cp: dict, x, vision, tp=None):
    h = apply_norm(x, cp.get("attn_norm"), cfg.norm)
    co, _ = attention(cp["attn"], h, kv_source=vision, tp=tp, **_attn_kwargs(cfg))
    x = residual_add(x, tanh(cp["gate_attn"]) * co)
    h = apply_norm(x, cp.get("mlp_norm"), cfg.norm)
    return residual_add(x, tanh(cp["gate_mlp"]) * mlp(cp["mlp"], h, cfg.activation,
                                                       _mlp_tp(cfg, tp)))


def _shared_attn_layer(cfg: ModelConfig, sp: dict, x, kv, pos: int, tp=None,
                       seq: tuple = ()):
    h = apply_norm(x, sp.get("attn_norm"), cfg.norm)
    ao, _ = attention(sp["attn"], h, cache=kv, pos=pos, tp=tp, seq=seq, **_attn_kwargs(cfg))
    x = residual_add(x, ao)
    h = apply_norm(x, sp.get("mlp_norm"), cfg.norm)
    return residual_add(x, mlp(sp["mlp"], h, cfg.activation, _mlp_tp(cfg, tp)))


def _mamba_layer(cfg: ModelConfig, bp: dict, x, states, tp=None):
    h = apply_norm(x, bp.get("norm"), cfg.norm)
    dims = _layer_dims(cfg, tp.size)["mamba"] if tp is not None else None
    mo, new_states = mb.mamba_block(
        bp["mamba"], h, n_heads=cfg.ssm_heads, d_state=cfg.ssm_state,
        expand=cfg.ssm_expand, conv_width=cfg.conv_width, chunk=cfg.ssm_chunk,
        cache=states, tp=tp, dims=dims)
    return residual_add(x, mo), new_states


# --------------------------------------------------------------------------
# Rematerialization.
# --------------------------------------------------------------------------

_MATMUL_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    """The counterpart of ``jax.checkpoint_policies.checkpoint_dots``: keep
    every matmul's output, recompute everything else."""
    if op in _MATMUL_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts, _save_dots)


def _remat(cfg: ModelConfig, cache, fn, *args):
    """``fn(*args)``; in a forward without a cache that autograd records,
    recomputed in the backward as ``cfg.remat`` says (reference
    ``_maybe_remat``)."""
    if cache is not None or cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if cfg.remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=_DOTS_CONTEXT)
    raise ValueError(f"unknown remat {cfg.remat!r}")


# --------------------------------------------------------------------------
# Forward.
# --------------------------------------------------------------------------


def _embed(cfg: ModelConfig, table: torch.Tensor, tokens: torch.Tensor, tp) -> torch.Tensor:
    vtp = _vocab_tp(cfg, tp)
    if vtp is None:
        return table[tokens].to(cfg.cdtype())
    lo, hi = vtp.share(cfg.vocab_size)
    own = (tokens >= lo) & (tokens < hi)
    rows = table[torch.where(own, tokens - lo, 0)].to(cfg.cdtype())
    return reduce_from_model(torch.where(own[..., None], rows, 0), vtp)


def forward(cfg: ModelConfig, params: Pytree, tokens: torch.Tensor | None = None, *,
            embeds: torch.Tensor | None = None,
            vision_embeds: torch.Tensor | None = None,
            cache: Pytree | None = None, pos: int = 0, tp=None, dp=None, fsdp=None,
            seq: tuple = ()):
    """Returns (logits (B, S, V) in the compute dtype, cache or None, aux
    loss: the MoE layers' sum, a float32 scalar). With a cache, each layer's
    keys, values and SSM states are written into it in place. Under ``tp``
    (params and cache this rank's shards) the logits are this rank's vocab
    columns (B, S, V / size) where the guard splits the vocabulary. ``dp``
    (``parallel.tensor.BatchAxes``): the ranks whose rows make one batch
    with these, which the MoE layers route together. ``fsdp`` (the "data"
    ``MeshAxis``): the params are also cut over it, and each layer gathers
    its own (see the module docstring). ``seq``: the mesh axes that cut the
    cache's sequence (``parallel.tensor.ServeLayout``)."""
    _check_family(cfg)
    if (tp is not None or fsdp is not None) and any(isinstance(w, PackedTernary) for w in
                                                    tree_leaves(params, is_leaf=lambda x:
                                                                isinstance(x, PackedTernary))):
        raise NotImplementedError("packed ternary weights on a sharded mesh: the reference "
                                  "runs no kernel on a sharded operand")
    fd = _axis_dims(cfg, fsdp.size, "data") if fsdp is not None else {}
    cdt = cfg.cdtype()
    x = embeds.to(cdt) if embeds is not None else _embed(cfg, params["embed"]["table"],
                                                         tokens, tp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    blocks = params["blocks"]

    if cfg.family in _ATTN_FAMILIES:
        windows = layer_windows(cfg)
        gates = cross_gates(cfg)
        cross = params.get("cross")
        vis = vision_embeds.to(cdt) if vision_embeds is not None else None
        auxes, cross_idx = [], 0
        for i in range(cfg.n_layers):
            window = int(windows[i])
            cp = _layer(cross, cross_idx) if cross is not None and gates[i] else None
            kv = (cache["k"][i], cache["v"][i]) if cache is not None else None

            # one remat unit per layer: the layer and the cross layer after it
            def body(x, bp, cp, kv=kv, window=window):
                x, layer_aux = _dense_layer(cfg, gather_layer(bp, fsdp, fd.get("blocks")), x,
                                            window, kv, pos, tp, dp, seq)
                if cp is not None:
                    x = _cross_layer(cfg, gather_layer(cp, fsdp, fd.get("cross")), x, vis, tp)
                return x, layer_aux

            x, layer_aux = _remat(cfg, cache, body, x, _layer(blocks, i), cp)
            if layer_aux is not None:
                auxes.append(layer_aux)
            cross_idx += int(cp is not None)
        if auxes:
            aux = torch.stack(auxes).sum()
    else:
        flags = attn_flags(cfg)
        shared = params.get("shared_attn")
        app_idx = 0
        for i in range(cfg.n_layers):
            sp = shared if cfg.family == "hybrid" and flags[i] else None
            kv = states = None
            if cache is not None:
                if sp is not None:
                    kv = (cache["attn_k"][app_idx], cache["attn_v"][app_idx])
                states = {"conv": cache["conv"][i], "ssd": cache["ssd"][i]}

            # one remat unit per layer: the shared block before it, if any
            def body(x, bp, sp, kv=kv, states=states):
                if sp is not None:
                    x = _shared_attn_layer(cfg, gather_layer(sp, fsdp, fd.get("shared_attn")),
                                           x, kv, pos, tp, seq)
                return _mamba_layer(cfg, gather_layer(bp, fsdp, fd.get("blocks")), x, states, tp)

            x, new_states = _remat(cfg, cache, body, x, _layer(blocks, i), sp)
            app_idx += int(sp is not None)
            if cache is not None:
                cache["conv"][i] = new_states["conv"]
                cache["ssd"][i] = new_states["ssd"]

    x = apply_norm(x, params.get("final_norm"), cfg.norm)
    vtp = _vocab_tp(cfg, tp)
    if vtp is not None:
        x = copy_to_model(x, vtp)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].T.to(cdt)
    else:
        head = params["lm_head"]
        if fd.get("lm_head") is not None:
            head = gather_from_data(head, fsdp, fd["lm_head"])
        logits = matmul(x, head)
    return logits, cache, aux


def whole_logits(cfg: ModelConfig, logits: torch.Tensor, tp) -> torch.Tensor:
    """(..., V) logits from this rank's vocab columns under ``tp``
    (all-gathered), or ``logits`` themselves where the vocabulary is whole."""
    vtp = _vocab_tp(cfg, tp)
    return logits if vtp is None else gather_from_model(logits, vtp, -1)


def decode_step(cfg: ModelConfig, params: Pytree, tokens: torch.Tensor,
                cache: Pytree, pos: int, *, vision_embeds: torch.Tensor | None = None,
                tp=None, dp=None, fsdp=None, seq: tuple = ()):
    """One-token incremental decode. tokens: (B, 1); pos: cache fill;
    ``tp``, ``dp``, ``fsdp`` and ``seq`` as for ``forward``."""
    logits, cache, _ = forward(cfg, params, tokens, vision_embeds=vision_embeds,
                               cache=cache, pos=pos, tp=tp, dp=dp, fsdp=fsdp, seq=seq)
    return logits, cache


def loss_fn(cfg: ModelConfig, params: Pytree, batch: dict, tp=None, dp=None, fsdp=None):
    """Mean next-token (or per-frame) cross entropy, from an fp32 log-softmax
    of the logits, plus ``aux_loss_coef`` × the MoE aux loss. ``batch`` holds
    ``labels`` and ``tokens`` or ``embeds`` (audio), and ``vision_embeds``
    for the vlm. Under ``tp`` with the vocabulary split, the cross entropy
    is vocab-parallel (``parallel.tensor.vocab_parallel_ce``): no rank
    holds the whole (B, S, V) logits. ``dp`` and ``fsdp`` as for
    ``forward``. Returns (loss, {"ce", "aux"})."""
    logits, _, aux = forward(cfg, params, batch.get("tokens"), embeds=batch.get("embeds"),
                             vision_embeds=batch.get("vision_embeds"), tp=tp, dp=dp,
                             fsdp=fsdp)
    labels = batch["labels"].to(torch.int64)
    vtp = _vocab_tp(cfg, tp)
    if vtp is not None:
        ce = torch.mean(vocab_parallel_ce(logits.to(torch.float32), labels, vtp))
    else:
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        ll = torch.gather(logp, -1, labels[..., None])[..., 0]
        ce = -torch.mean(ll)
    return ce + cfg.aux_loss_coef * aux, {"ce": ce, "aux": aux}
