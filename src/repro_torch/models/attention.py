"""Attention with GQA/MQA, sliding window, cross-attention and a KV cache
(port of ``repro.models.attention``).

Two softmax paths, as in the reference:

- ``_attend_naive`` materializes the (Sq × Sk) scores; short sequences and
  decode (S_q == 1) take it.
- ``_attend_flash`` is an online softmax over blocks of ``FLASH_BLOCK``
  keys, O(Sq · block) live memory; it runs when S_kv > 2048 and S_q > 1.
  It keeps the reference's block loop and its m / l / acc arithmetic, but
  masks the keys that pad S_kv to a whole block by their index (≥ S_kv)
  rather than by a position sentinel: the reference gives them position
  −10⁹, which a global window does not mask, so its blocked path adds
  exp(0 − m) per padded key to the softmax denominator whenever S_kv is
  not a multiple of 1024. Here the blocked path equals ``_attend_naive``.

Under tensor parallelism (``tp``, a ``parallel.tensor.MeshAxis``) the heads
are local: ``wq`` is column-parallel over whole query heads, ``wo``
row-parallel and followed by ``reduce_from_model``. ``head_layout`` says
which kv heads a rank's query heads use and where it gets them: its own
columns of ``wk``/``wv`` where those hold whole kv heads; where the guard
split them mid-head (MQA at any tp > 1), gathered with
``gather_from_model`` so every rank attends with whole heads; or selected
from a ``wk``/``wv`` the guard left whole. A decode cache holds the local
kv heads.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.common import apply_rope, dense_init, matmul
from repro_torch.parallel.tensor import (
    combine_softmax, copy_to_model, gather_from_model, linear_rank, reduce_from_model,
)

NEG_INF = -1e30
FLASH_THRESHOLD = 2048
FLASH_BLOCK = 1024
GLOBAL_WINDOW = 1 << 30


def init_attn(gen: torch.Generator, d_model: int, n_heads: int, n_kv_heads: int,
              head_dim: int, dtype, n_layers: int | None = None):
    """Attention projections, stacked (n_layers, ...) unless ``n_layers``
    is None."""
    lead = () if n_layers is None else (n_layers,)
    return {
        "wq": dense_init(gen, lead + (d_model, n_heads * head_dim), dtype),
        "wk": dense_init(gen, lead + (d_model, n_kv_heads * head_dim), dtype),
        "wv": dense_init(gen, lead + (d_model, n_kv_heads * head_dim), dtype),
        "wo": dense_init(gen, lead + (n_heads * head_dim, d_model), dtype),
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


def _scale(hd: int) -> float:
    # 1/sqrt(hd) rounded as the reference's f32 arithmetic rounds it, kept a
    # host scalar so no copy to the device (and no sync) happens per layer
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _attend_naive(q, k, v, q_pos, k_pos, *, causal, window, k_len=None):
    """q: (B,Sq,Hkv,G,hd)  k,v: (B,Sk,Hkv,hd) → (B,Sq,Hkv,G,hd)."""
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32),
                          k.to(torch.float32)) * _scale(q.shape[-1])
    bias = _mask_bias(q_pos, k_pos, causal=causal, window=window)
    if k_len is not None:  # decode: mask unwritten cache slots
        bias = bias + torch.where(k_pos[None, :] < k_len, 0.0, NEG_INF)
    probs = torch.softmax(logits + bias, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(torch.float32))
    return out.to(q.dtype)


def _attend_flash(q, k, v, q_pos, k_pos, *, causal, window, k_len=None,
                  block: int = FLASH_BLOCK):
    """Online softmax over blocks of ``block`` keys; O(Sq · block) live
    memory. Keys past S_kv (the last block's padding) are masked by index."""
    b, sq, hkv, g, hd = q.shape
    sk = k.shape[1]
    n_blocks = (sk + block - 1) // block
    scale = _scale(hd)
    qf = q.to(torch.float32)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, hd), dtype=torch.float32, device=q.device)
    for i in range(n_blocks):
        lo, hi = i * block, min((i + 1) * block, sk)
        kc = k[:, lo:hi].to(torch.float32)
        vc = v[:, lo:hi].to(torch.float32)
        pc = k_pos[lo:hi]
        pad = block - (hi - lo)
        if pad:
            kc = torch.nn.functional.pad(kc, (0, 0, 0, 0, 0, pad))
            vc = torch.nn.functional.pad(vc, (0, 0, 0, 0, 0, pad))
            pc = torch.nn.functional.pad(pc, (0, pad))
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, kc) * scale
        bias = _mask_bias(q_pos, pc, causal=causal, window=window)
        if k_len is not None:
            bias = bias + torch.where(pc[None, :] < k_len, 0.0, NEG_INF)
        if pad:
            valid = torch.arange(block, device=q.device) < block - pad
            bias = bias + torch.where(valid[None, :], 0.0, NEG_INF)
        logits = logits + bias
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)  # (B,Sq,Hkv,G,hd)


def _partial(q, k, v, q_pos, k_pos, *, causal, window, k_len, block: int = FLASH_BLOCK):
    """The blocked softmax's partial over these keys: (m, l, acc) with m
    (B,Hkv,G,Sq) the row max of the valid scores (``NEG_INF`` where none
    is valid), l = Σ exp(score − m) and acc (B,Hkv,G,Sq,hd) = Σ exp(score −
    m)·v over the valid keys, in blocks of ``block`` keys; every key is
    masked by its position (``k_pos``, global), so an invalid key adds
    exactly nothing."""
    b, sq, hkv, g, hd = q.shape
    sk = k.shape[1]
    scale = _scale(hd)
    qf = q.to(torch.float32)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, hd), dtype=torch.float32, device=q.device)
    for lo in range(0, sk, block):
        hi = min(lo + block, sk)
        pc = k_pos[lo:hi]
        ok = _mask_bias(q_pos, pc, causal=causal, window=window) == 0
        ok = ok & (pc[None, :] < k_len)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k[:, lo:hi].to(torch.float32)) * scale
        scores = torch.where(ok, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.where(ok, torch.exp(scores - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                   v[:, lo:hi].to(torch.float32))
        m = m_new
    return m, l, acc


@dataclasses.dataclass(frozen=True)
class HeadLayout:
    """A rank's share of the heads: query heads [q_lo, q_hi) on kv heads
    [kv_lo, kv_hi); ``kv`` says where its keys and values come from:
    "local" (its own whole-head columns of wk/wv, or every head on one
    device), "gather" (wk/wv split mid-head: all-gathered) or "whole" (wk/wv
    left whole by the guard: its heads selected)."""

    q_lo: int
    q_hi: int
    kv_lo: int
    kv_hi: int
    kv: str
    sharded: bool

    @property
    def n_q(self) -> int:
        return self.q_hi - self.q_lo

    @property
    def n_kv(self) -> int:
        return self.kv_hi - self.kv_lo


def head_layout(n_heads: int, n_kv_heads: int, head_dim: int, tp=None) -> HeadLayout:
    """The heads this rank computes under ``tp``: all of them where the
    guard leaves ``wq`` whole (n_heads · head_dim not a multiple of the
    axis), else n_heads / size query heads and the kv heads they read."""
    if tp is None or (n_heads * head_dim) % tp.size:
        return HeadLayout(0, n_heads, 0, n_kv_heads, "local", False)
    if n_heads % tp.size:
        raise NotImplementedError(f"tensor parallelism over {tp.size} ranks would split "
                                  f"{n_heads} query heads mid-head")
    q_lo, q_hi = tp.share(n_heads)
    g = n_heads // n_kv_heads
    kv_lo, kv_hi = q_lo // g, (q_hi - 1) // g + 1
    n_q = q_hi - q_lo
    if n_q % g and g % n_q:
        raise NotImplementedError(f"{n_q} local query heads do not group evenly onto "
                                  f"{n_kv_heads} kv heads")
    if (n_kv_heads * head_dim) % tp.size:
        kv = "whole"
    else:
        kv = "local" if n_kv_heads % tp.size == 0 else "gather"
    return HeadLayout(q_lo, q_hi, kv_lo, kv_hi, kv, True)


def _project_kv(w, src, src_tp, lay: HeadLayout, tp, head_dim: int, n_kv_heads: int,
                every_head: bool = False):
    """This rank's kv heads of ``src @ w``, (B, S, n_kv, hd), or with
    ``every_head`` all n_kv_heads of them (the guard split ``wk``/``wv``
    mid-head or left them whole). ``src_tp`` is ``src`` entered into
    per-rank computation (``copy_to_model``)."""
    b, s = src.shape[:2]
    if lay.kv == "local":
        if every_head and lay.n_kv != n_kv_heads:
            raise NotImplementedError("a cache cut over 'model' by its sequence with the kv "
                                      "heads cut over 'model' as well")
        return matmul(src_tp if lay.sharded else src, w).reshape(b, s, lay.n_kv, head_dim)
    if lay.kv == "gather":
        whole = copy_to_model(gather_from_model(matmul(src_tp, w), tp), tp)
    else:
        whole = copy_to_model(matmul(src, w), tp)
    whole = whole.reshape(b, s, n_kv_heads, head_dim)
    return whole if every_head else whole[:, :, lay.kv_lo:lay.kv_hi]


def attention(params: dict, x: torch.Tensor, *, n_heads: int, n_kv_heads: int,
              head_dim: int, rope_theta: float = 10000.0, use_rope: bool = True,
              causal: bool = True, window: int | None = None,
              kv_source: torch.Tensor | None = None,
              cache: tuple | None = None, pos: int = 0, tp=None, seq: tuple = ()):
    """Attention block (no norm/residual — the caller owns those).

    cache: (k_cache, v_cache) each (B, S_max, Hkv, hd); pos = current fill.
    The new keys and values are written into the cache IN PLACE at
    [pos : pos + Sq] and attention runs over the cache.
    kv_source: cross-attention — keys and values from this tensor, no
    causal mask, no RoPE, no cache write.
    tp: the "model" axis the projections are sharded over (``head_layout``;
    a cache then holds the local kv heads).
    seq: the ``MeshAxis`` list (outer first) that cuts the cache's sequence
    (``parallel.tensor.ServeLayout.seq``; see the module docstring); the
    cache then holds this rank's S_max / p slots, and every kv head where
    "model" is among them.
    Returns (out, cache)."""
    b, sq, _ = x.shape
    lay = head_layout(n_heads, n_kv_heads, head_dim, tp)
    every_head = cache is not None and any(a.name == "model" for a in seq)
    src = kv_source if kv_source is not None else x
    s_src = src.shape[1]
    x_tp = copy_to_model(x, tp) if lay.sharded else x
    src_tp = x_tp if kv_source is None else (
        copy_to_model(src, tp) if lay.sharded else src)
    q = matmul(x_tp, params["wq"]).reshape(b, sq, lay.n_q, head_dim)
    k = _project_kv(params["wk"], src, src_tp, lay, tp, head_dim, n_kv_heads, every_head)
    v = _project_kv(params["wv"], src, src_tp, lay, tp, head_dim, n_kv_heads, every_head)
    n_kv = k.shape[2]

    q_pos = pos + torch.arange(sq, device=x.device)
    if kv_source is not None:
        k_pos = torch.arange(s_src, device=x.device)
        causal = False
        use_rope = False
    else:
        k_pos = q_pos
    if use_rope:
        q = apply_rope(q, q_pos.expand(b, sq), rope_theta)
        k = apply_rope(k, k_pos.expand(b, s_src), rope_theta)
    gathered = every_head and lay.sharded
    if gathered:  # every query head, for the partials over this rank's slots
        q = gather_from_model(q.reshape(b, sq, lay.n_q * head_dim), tp).reshape(
            b, sq, n_heads, head_dim)
    q = q.reshape(b, sq, n_kv, q.shape[2] // n_kv, head_dim)

    k_len = None
    if cache is not None:
        k_cache, v_cache = cache
        s_own = k_cache.shape[1]
        j, p = linear_rank(seq)
        if pos + sq > s_own * p:
            raise ValueError(f"cache of {s_own * p} slots cannot hold "
                             f"positions up to {pos + sq}")
        lo = j * s_own
        # the new positions this rank's slots [lo, lo + s_own) own
        w0, w1 = max(pos, lo), min(pos + sq, lo + s_own)
        if w0 < w1:
            k_cache[:, w0 - lo:w1 - lo] = k[:, w0 - pos:w1 - pos]
            v_cache[:, w0 - lo:w1 - lo] = v[:, w0 - pos:w1 - pos]
        k, v = k_cache, v_cache
        k_pos = lo + torch.arange(s_own, device=x.device)
        k_len = pos + sq

    if window is None:
        window = GLOBAL_WINDOW
    if seq and cache is not None:
        m, l, acc = _partial(q, k, v, q_pos, k_pos, causal=causal, window=window, k_len=k_len)
        out = combine_softmax(m, l, acc, seq).permute(0, 3, 1, 2, 4).to(q.dtype)
    else:
        attend = _attend_flash if k.shape[1] > FLASH_THRESHOLD and sq > 1 else _attend_naive
        out = attend(q, k, v, q_pos, k_pos, causal=causal, window=window, k_len=k_len)
    out = out.reshape(b, sq, -1)
    if gathered:  # this rank's query heads, for the row-parallel wo
        out = out[..., lay.q_lo * head_dim:lay.q_hi * head_dim]
    out = matmul(out, params["wo"])
    return (reduce_from_model(out, tp) if lay.sharded else out), cache
