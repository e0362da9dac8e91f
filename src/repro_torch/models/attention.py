"""Attention with GQA/MQA, sliding window and a KV cache (port of
``repro.models.attention``).

The softmax materializes the (Sq × Sk) scores (``_attend_naive``), as the
reference does for short sequences. The reference switches to a blocked
online softmax when S_kv > 2048 and S_q > 1; that path is not ported and
raises ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import apply_rope, dense_init, matmul

NEG_INF = -1e30
FLASH_THRESHOLD = 2048


def init_attn(gen: torch.Generator, d_model: int, n_heads: int, n_kv_heads: int,
              head_dim: int, dtype, n_layers: int):
    """Stacked (n_layers, ...) attention projections."""
    return {
        "wq": dense_init(gen, (n_layers, d_model, n_heads * head_dim), dtype),
        "wk": dense_init(gen, (n_layers, d_model, n_kv_heads * head_dim), dtype),
        "wv": dense_init(gen, (n_layers, d_model, n_kv_heads * head_dim), dtype),
        "wo": dense_init(gen, (n_layers, n_heads * head_dim, d_model), dtype),
    }


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
               window: int) -> torch.Tensor:
    """(Sq, Sk) additive bias; window ≥ S disables the sliding constraint."""
    dq = q_pos[:, None]
    dk = k_pos[None, :]
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok = ok & (dk <= dq)
    ok = ok & (dq - dk < window)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _attend_naive(q, k, v, q_pos, k_pos, *, causal, window, k_len=None):
    """q: (B,Sq,Hkv,G,hd)  k,v: (B,Sk,Hkv,hd) → (B,Sq,Hkv,G,hd)."""
    # 1/sqrt(hd) rounded as the reference's f32 arithmetic rounds it, kept a
    # host scalar so no copy to the device (and no sync) happens per layer
    scale = float(np.float32(1.0) / np.sqrt(np.float32(q.shape[-1])))
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    bias = _mask_bias(q_pos, k_pos, causal=causal, window=window)
    if k_len is not None:  # decode: mask unwritten cache slots
        bias = bias + torch.where(k_pos[None, :] < k_len, 0.0, NEG_INF)
    probs = torch.softmax(logits + bias, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(torch.float32))
    return out.to(q.dtype)


def attention(params: dict, x: torch.Tensor, *, n_heads: int, n_kv_heads: int,
              head_dim: int, rope_theta: float = 10000.0, use_rope: bool = True,
              causal: bool = True, window: int | None = None,
              cache: tuple | None = None, pos: int = 0):
    """Self-attention block (no norm/residual — the caller owns those).

    cache: (k_cache, v_cache) each (B, S_max, Hkv, hd); pos = current fill.
    The new keys and values are written into the cache IN PLACE at
    [pos : pos + Sq] and attention runs over the cache. Returns
    (out, cache)."""
    b, sq, _ = x.shape
    g = n_heads // n_kv_heads
    q = matmul(x, params["wq"]).reshape(b, sq, n_kv_heads, g, head_dim)
    k = matmul(x, params["wk"]).reshape(b, sq, n_kv_heads, head_dim)
    v = matmul(x, params["wv"]).reshape(b, sq, n_kv_heads, head_dim)

    q_pos = pos + torch.arange(sq, device=x.device)
    k_pos = q_pos
    if use_rope:
        qr = apply_rope(q.reshape(b, sq, n_heads, head_dim), q_pos.expand(b, sq), rope_theta)
        q = qr.reshape(b, sq, n_kv_heads, g, head_dim)
        k = apply_rope(k, k_pos.expand(b, sq), rope_theta)

    k_len = None
    if cache is not None:
        k_cache, v_cache = cache
        if pos + sq > k_cache.shape[1]:
            raise ValueError(f"cache of {k_cache.shape[1]} slots cannot hold "
                             f"positions up to {pos + sq}")
        k_cache[:, pos:pos + sq] = k
        v_cache[:, pos:pos + sq] = v
        k, v = k_cache, v_cache
        k_pos = torch.arange(k.shape[1], device=x.device)
        k_len = pos + sq

    if window is None:
        window = 1 << 30
    if k.shape[1] > FLASH_THRESHOLD and sq > 1:
        raise NotImplementedError(
            "blocked (flash) attention for S_kv > 2048 with S_q > 1 is not ported yet")
    out = _attend_naive(q, k, v, q_pos, k_pos, causal=causal, window=window, k_len=k_len)
    out = out.reshape(b, sq, n_heads * head_dim)
    return matmul(out, params["wo"]), cache
