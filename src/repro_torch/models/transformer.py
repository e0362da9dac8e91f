"""Decoder-only LM, the dense family (port of ``repro.models.transformer``).

Parameters are nested dicts of tensors with the reference's keys and
layouts: ``embed/table`` (V, D); ``blocks`` holding stacked (L, ...) layer
weights — ``attn/{wq,wk,wv,wo}`` and ``mlp/{w_in,w_gate,w_out}`` in
(in, out) layout — and, for parametric norms, ``attn_norm``/``mlp_norm``
(L, D) and ``final_norm`` (D,); ``lm_head`` (D, V) unless embeddings are
tied. ``forward`` walks the stacked layers with a Python loop where the
reference scans; every layer attends globally (the sliding windows of
gemma3 arrive with that config). Other families (moe, ssm, hybrid, vlm,
audio) raise ``NotImplementedError`` until their slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.dtypes import torch_dtype
from repro_torch.kernels.repack import PackedTernary
from repro_torch.models.attention import attention, init_attn
from repro_torch.models.common import apply_norm, dense_init, embed_init, matmul
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.tree import tree_leaves, tree_map

Pytree = Any


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's model configuration, the fields the dense family
    reads (see ``repro.models.transformer.ModelConfig``)."""

    name: str
    family: str                      # only "dense" is ported
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
    causal: bool = True
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"model family {cfg.family!r} is not ported yet")


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes, without allocating it."""
    _check_family(cfg)
    l, d, f, hd = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    blocks = {
        "attn": {"wq": (l, d, cfg.n_heads * hd), "wk": (l, d, cfg.n_kv_heads * hd),
                 "wv": (l, d, cfg.n_kv_heads * hd), "wo": (l, cfg.n_heads * hd, d)},
        "mlp": {"w_in": (l, d, f), "w_out": (l, f, d)},
    }
    if cfg.gated_mlp:
        blocks["mlp"]["w_gate"] = (l, d, f)
    shapes = {"embed": {"table": (cfg.vocab_size, d)}, "blocks": blocks}
    if cfg.norm != "nonparam":
        blocks["attn_norm"] = blocks["mlp_norm"] = (l, d)
        shapes["final_norm"] = (d,)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


def param_count(cfg: ModelConfig) -> int:
    shapes = tree_leaves(param_shapes(cfg), is_leaf=lambda x: isinstance(x, tuple))
    return sum(math.prod(s) for s in shapes)


def init_params(cfg: ModelConfig, seed: int = 0, device: str | torch.device = "cuda") -> Pytree:
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device``: embeddings N(0, 0.02²), matrices Lecun-normal,
    norm scales zero (the reference's initializers, not its bits)."""
    dev = resolve_device(device)
    _check_family(cfg)
    dtype = cfg.pdtype()
    gen = torch.Generator(device=dev).manual_seed(seed)
    hd = cfg.resolved_head_dim
    params: dict = {"embed": {"table": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype)}}
    blocks = {
        "attn": init_attn(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, hd, dtype,
                          cfg.n_layers),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dtype, cfg.n_layers),
    }
    if cfg.norm != "nonparam":
        for key in ("attn_norm", "mlp_norm"):
            blocks[key] = torch.zeros((cfg.n_layers, cfg.d_model), dtype=dtype, device=dev)
        params["final_norm"] = torch.zeros((cfg.d_model,), dtype=dtype, device=dev)
    params["blocks"] = blocks
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype)
    return params


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device: str | torch.device = "cuda") -> Pytree:
    """Decode cache: stacked (L, B, S_max, Hkv, hd) keys and values."""
    dev = resolve_device(device)
    _check_family(cfg)
    dtype = dtype or cfg.cdtype()
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _layer(blocks: dict, i: int) -> dict:
    return tree_map(lambda t: t.layer(i) if isinstance(t, PackedTernary) else t[i],
                    blocks, is_leaf=lambda x: isinstance(x, PackedTernary))


def _dense_layer(cfg: ModelConfig, bp: dict, x, kv, pos: int):
    """One dense layer; kv = (k, v) cache slices or None."""
    h = apply_norm(x, bp.get("attn_norm"), cfg.norm)
    attn_out, _ = attention(
        bp["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        use_rope=cfg.use_rope, causal=cfg.causal, cache=kv, pos=pos,
    )
    x = x + attn_out
    h = apply_norm(x, bp.get("mlp_norm"), cfg.norm)
    return x + mlp(bp["mlp"], h, cfg.activation)


def forward(cfg: ModelConfig, params: Pytree, tokens: torch.Tensor, *,
            cache: Pytree | None = None, pos: int = 0):
    """Returns (logits (B, S, V) in the compute dtype, cache or None,
    aux loss 0). With a cache, each layer's keys and values are written
    into it in place."""
    _check_family(cfg)
    cdt = cfg.cdtype()
    x = params["embed"]["table"][tokens].to(cdt)
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        kv = (cache["k"][i], cache["v"][i]) if cache is not None else None
        x = _dense_layer(cfg, _layer(blocks, i), x, kv, pos)
    x = apply_norm(x, params.get("final_norm"), cfg.norm)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].T.to(cdt)
    else:
        logits = matmul(x, params["lm_head"])
    return logits, cache, torch.zeros((), dtype=torch.float32, device=x.device)


def decode_step(cfg: ModelConfig, params: Pytree, tokens: torch.Tensor,
                cache: Pytree, pos: int):
    """One-token incremental decode. tokens: (B, 1); pos: cache fill."""
    logits, cache, _ = forward(cfg, params, tokens, cache=cache, pos=pos)
    return logits, cache
