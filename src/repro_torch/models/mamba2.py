"""Mamba2 block: the SSD (state-space duality) chunked scan and its O(1)
decode (port of ``repro.models.mamba2``).

The minimal SSD formulation of Dao & Gu (arXiv:2405.21060):

    h_t = exp(Δ_t A) h_{t-1} + Δ_t B_t x_t        y_t = C_t h_t + D x_t

Prefill uses the chunked algorithm (quadratic within a chunk of Q tokens,
linear across chunks through the inter-chunk state recurrence, here a loop
over chunks); decode is one state update. n_groups = 1 (B and C are shared
across heads). The SSD state is always float32.

Block layout (d_inner = expand·d_model, P = d_inner/n_heads, N = d_state):
    in_proj : D → [z(d_inner), x(d_inner), B(N), C(N), dt(H)]
    conv1d  : causal depthwise width-W over concat(x, B, C)
    SSD core, gated RMSNorm(y · silu(z)), out_proj : d_inner → D

Under tensor parallelism (``tp``, a ``parallel.tensor.MeshAxis``, with the
layer's "model" ``dims``) the sharding rules split ``in_proj``'s output
columns [z | x | B | C | dt] as one flat range, ``conv_w``'s channels
[x | B | C] likewise, and ``out_proj`` by rows; the serving cache
(``models.transformer.init_cache``) holds the rank's contiguous block of
the conv window's channels and of the SSD state's heads, each where it
divides over "model", as the reference's ``cache_specs`` places them. The
block computes two ways:

- Decode (every one-token call with a cache; on one device the same steps
  on the whole leaves): from the rank's shards and its cache part, with no
  weight all-gather where the cache is cut. ``in_proj`` is
  column-parallel on the rank's shard and its (B, 1, 2·d_in + 2N + H)
  output all-gathered (the cut falls inside x, not at a head boundary:
  zamba2-1.2b at two ranks, column 4,192 of 8,384); the depthwise conv
  runs on the rank's channel range with its ``conv_w`` shard and window,
  and its (B, 1, d_in + 2N) output is all-gathered (the conv cut, channel
  2,112 of 4,224 there, also falls inside x; B and C sit on the last
  rank); the SSD update runs on the rank's heads and state; y · silu(z)
  on those heads, whose gated RMSNorm over all of d_in all-reduces Σy²
  (a (B, 1) sum) and takes the replicated ``gate_norm``'s columns; and
  ``out_proj`` is row-parallel on whole heads, then one all-reduce of
  (B, 1, D). Per layer a rank moves two activation gathers, 33.5 KB and
  16.9 KB a row for zamba2-1.2b in fp32, where the weight path gathers
  51 MB. A stage whose cache leaf the guard left whole computes whole:
  a whole conv window takes the gathered ``conv_w``, whole heads the
  gathered ``out_proj`` (``in_proj`` stays column-parallel wherever it is
  cut). This path is not differentiated (serving runs without
  autograd): its gathers' backward is the conjugate functions' slice.
- Every other call (prefill, and training without a cache): the block
  gathers the WEIGHTS, not the activations: each sharded leaf is
  all-gathered (``gather_from_model``) and the block computes exactly
  what one device computes, on every rank, from the replicated input. At
  a prefill of 32k tokens or a training batch the gathered activations
  would outweigh the 51 MB of weights a zamba2-1.2b layer gathers. Each
  gathered weight is then used alike on every rank, so the gather's
  backward (this rank's slice of the gradient) is the shard's gradient,
  and the input's gradient needs no collective. The per-rank cost is the
  all-gather, which receives the other rank's 34 MB of in_proj and 17 MB
  of out_proj a layer for zamba2-1.2b in fp32 at two ranks, once more
  under remat; the gain is the params, gradients and Adam moments a rank
  holds: in_proj and out_proj are ~95% of a Mamba2 layer's parameters. A
  prefill reads the whole conv window (gathered from the ranks' parts)
  and writes only the rank's slices of the new window and final state. A
  leaf the divisibility guard left whole (for example in_proj's odd
  column count with a single SSM head) is used as it is.

Under FSDP ``in_proj`` and ``out_proj`` are also cut on D over "data";
``models.transformer`` gathers them over "data" before the block, which
then works over "model" as above.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, rms_norm
from repro_torch.models.elementwise import silu
from repro_torch.parallel.tensor import (
    copy_to_model, gather_from_model, reduce_from_model, scatter_to_model,
)


def d_inner_of(d_model: int, expand: int) -> int:
    return expand * d_model


def init_mamba(gen: torch.Generator, d_model: int, n_heads: int, d_state: int, expand: int,
               conv_width: int, dtype, n_layers: int | None = None):
    """One block's weights, stacked (n_layers, ...) unless ``n_layers`` is
    None. A = −exp(a_log) starts at −1, Δ's bias at 0, the skip D at 1."""
    lead = () if n_layers is None else (n_layers,)
    d_in = d_inner_of(d_model, expand)
    conv_ch = d_in + 2 * d_state
    dev = gen.device
    return {
        "in_proj": dense_init(gen, lead + (d_model, 2 * d_in + 2 * d_state + n_heads), dtype),
        "conv_w": dense_init(gen, lead + (conv_width, conv_ch), dtype),
        "a_log": torch.zeros(lead + (n_heads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(lead + (n_heads,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones(lead + (n_heads,), dtype=torch.float32, device=dev),
        "gate_norm": torch.zeros(lead + (d_in,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, lead + (d_in, d_model), dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state: torch.Tensor | None):
    """Depthwise causal conv. x: (B,L,C), w: (W,C), state: (B,W-1,C) or
    None. Returns (y (B,L,C), new_state (B,W-1,C)). The W taps add from 0
    in tap order, as the reference's Python ``sum`` does."""
    width = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)                      # (B, L+W-1, C)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(width))
    new_state = xp[:, -(width - 1):, :] if width > 1 else state
    return y, new_state


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) → (..., Q, Q) lower-triangular sums Σ_{i=s+1..q} a_i,
    −inf above the diagonal (so exp gives 0 there)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dt, a, b, c, chunk: int):
    """SSD scan. x:(B,L,H,P) dt:(B,L,H) a:(H,)<0 b,c:(B,L,N) → y:(B,L,H,P)
    float32 and the final state (B,H,P,N) float32. A length that is not a
    multiple of ``chunk`` is zero-padded."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    lp = l + pad
    nc = lp // chunk

    xf = x.to(torch.float32).reshape(bsz, nc, chunk, h, p)
    dtf = dt.to(torch.float32).reshape(bsz, nc, chunk, h)
    bf = b.to(torch.float32).reshape(bsz, nc, chunk, n)
    cf = c.to(torch.float32).reshape(bsz, nc, chunk, n)

    adt = dtf * a[None, None, None, :]                     # (B,nc,Q,H) ≤ 0
    adt_h = adt.permute(0, 3, 1, 2)                        # (B,H,nc,Q)
    acs = torch.cumsum(adt_h, dim=-1)                      # within-chunk cumsum
    xdt = xf * dtf[..., None]                              # Δ_t B_t x_t uses Δx

    # 1) intra-chunk (masked quadratic) term
    lmat = torch.exp(_segsum(adt_h))                       # (B,H,nc,Q,Q)
    scores = torch.einsum("bcqn,bcsn->bcqs", cf, bf)       # (B,nc,Q,Q)
    y_diag = torch.einsum("bcqs,bhcqs,bcshp->bcqhp", scores, lmat, xdt)

    # 2) chunk-final states
    decay_to_end = torch.exp(acs[..., -1:] - acs)          # (B,H,nc,Q)
    states = torch.einsum("bcsn,bhcs,bcshp->bchpn", bf, decay_to_end, xdt)

    # 3) inter-chunk recurrence, one chunk at a time
    chunk_decay = torch.exp(acs[..., -1])                  # (B,H,nc)
    h_state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    h_prevs = []
    for ci in range(nc):
        h_prevs.append(h_state)
        h_state = h_state * chunk_decay[:, :, ci, None, None] + states[:, ci]
    h_prev = torch.stack(h_prevs, dim=1)                   # (B,nc,H,P,N)

    # 4) contribution of the carried-in state to each chunk
    state_decay = torch.exp(acs)                           # (B,H,nc,Q)
    y_off = torch.einsum("bcqn,bchpn,bhcq->bcqhp", cf, h_prev, state_decay)

    y = (y_diag + y_off).reshape(bsz, lp, h, p)[:, :l]
    return y, h_state


def ssd_decode(x, dt, a, b, c, state):
    """One-token state update. x:(B,H,P) dt:(B,H) b,c:(B,N) state:(B,H,P,N)."""
    da = torch.exp(dt.to(torch.float32) * a[None, :])     # (B,H)
    xdt = x.to(torch.float32) * dt.to(torch.float32)[..., None]
    state = state * da[..., None, None] + torch.einsum(
        "bhp,bn->bhpn", xdt, b.to(torch.float32))
    y = torch.einsum("bhpn,bn->bhp", state, c.to(torch.float32))
    return y, state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + eˣ) as ``jax.nn.softplus`` computes it (``logaddexp(x, 0)``);
    ``F.softplus`` switches to the identity above 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _whole(params: dict, name: str, tp, dims: dict | None) -> torch.Tensor:
    """The leaf ``name`` whole: all-gathered over ``tp`` where ``dims``
    shards it, else as held."""
    d = dims.get(name) if tp is not None and dims is not None else None
    return params[name] if d is None else gather_from_model(params[name], tp, d)


def _rank_cols(params: dict, name: str, tp, dims: dict | None, lo: int, hi: int,
               dim: int) -> torch.Tensor:
    """This rank's [lo, hi) of leaf ``name`` along ``dim``: its shard where
    ``dims`` cuts it there, else that slice of the whole leaf."""
    if dims is not None and dims.get(name) is not None:
        return params[name]
    return params[name].narrow(dim, lo, hi - lo)


def _decode(params, x, cache, tp, dims, *, n_heads: int, d_state: int, d_in: int,
            conv_cut: bool, heads_cut: bool):
    """One token with a cache (the module docstring's decode path), from the
    rank's shards and cache part under ``tp``, else from the whole leaves.
    Returns (out (B, 1, D), new cache part)."""
    bsz, n = x.shape[0], d_state
    p, conv_ch = d_in // n_heads, d_in + 2 * d_state
    if tp is not None and dims is not None and dims.get("in_proj") is not None:
        zxbcdt = gather_from_model(copy_to_model(x, tp) @ params["in_proj"], tp, -1)
    else:
        zxbcdt = x @ params["in_proj"]
    z, conv_in, dt_raw = torch.split(zxbcdt, [d_in, conv_ch, n_heads], dim=-1)
    if conv_cut:
        lo, hi = tp.share(conv_ch)
        conv_out, new_conv = _causal_conv(conv_in[..., lo:hi],
                                          _rank_cols(params, "conv_w", tp, dims, lo, hi, 1),
                                          cache["conv"])
        conv_out = gather_from_model(silu(conv_out), tp, -1)
    else:
        conv_out, new_conv = _causal_conv(conv_in, _whole(params, "conv_w", tp, dims),
                                          cache["conv"])
        conv_out = silu(conv_out)
    xin, b, c = torch.split(conv_out, [d_in, n, n], dim=-1)

    h0, h1 = tp.share(n_heads) if heads_cut else (0, n_heads)
    a = -torch.exp(params["a_log"][h0:h1])                 # (H,) < 0
    dt = softplus(dt_raw[..., h0:h1].to(torch.float32) + params["dt_bias"][h0:h1])
    xh = xin.reshape(bsz, 1, n_heads, p)[:, :, h0:h1]
    y, new_ssd = ssd_decode(xh[:, 0], dt[:, 0], a, b[:, 0], c[:, 0],
                            cache["ssd"].to(torch.float32))
    y = y[:, None] + xh.to(torch.float32) * params["d_skip"][h0:h1][None, None, :, None]
    y = y.reshape(bsz, 1, (h1 - h0) * p).to(x.dtype)
    y = y * silu(z[..., h0 * p:h1 * p])
    if not heads_cut:
        out = rms_norm(y, params["gate_norm"]) @ _whole(params, "out_proj", tp, dims)
        return out, {"conv": new_conv, "ssd": new_ssd}

    def mean_sq(sq):                                       # over all of d_in
        return reduce_from_model(torch.sum(sq, dim=-1, keepdim=True), tp) / d_in

    y = rms_norm(y, params["gate_norm"][h0 * p:h1 * p], mean_sq=mean_sq)
    w_out = _rank_cols(params, "out_proj", tp, dims, h0 * p, h1 * p, 0)
    return reduce_from_model(y @ w_out, tp), {"conv": new_conv, "ssd": new_ssd}


def mamba_block(params, x, *, n_heads: int, d_state: int, expand: int,
                conv_width: int, chunk: int, cache: dict | None = None, tp=None,
                dims: dict | None = None):
    """x: (B, L, D). cache: {"conv": (B,W-1,C), "ssd": (B,H,P,N)} or None,
    or under ``tp`` the rank's part of it (C and H cut over "model" where
    they divide). A one-token call with a cache takes the decode update;
    any other call runs the chunked scan from a zero state (the conv still
    reads the cache's window). ``tp`` and ``dims`` (the layer's "model" dim
    per leaf, None where whole): the params are this rank's shards (see
    the module docstring for the two paths). Returns (out (B,L,D),
    new_cache), the cache in the given one's shapes."""
    bsz, l, d = x.shape
    d_in = d_inner_of(d, expand)
    p = d_in // n_heads
    n = d_state
    # a cache part cut over "model" (``init_cache`` with a mesh)
    conv_cut = tp is not None and cache is not None and cache["conv"].shape[-1] != d_in + 2 * n
    heads_cut = tp is not None and cache is not None and cache["ssd"].shape[1] != n_heads
    if cache is not None and l == 1:
        return _decode(params, x, cache, tp, dims, n_heads=n_heads, d_state=d_state,
                       d_in=d_in, conv_cut=conv_cut, heads_cut=heads_cut)

    zxbcdt = x @ _whole(params, "in_proj", tp, dims)
    z, xin, b, c, dt_raw = torch.split(zxbcdt, [d_in, d_in, n, n, n_heads], dim=-1)
    conv_in = torch.cat([xin, b, c], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    if conv_cut:
        conv_state = gather_from_model(conv_state, tp, -1)
    conv_out, new_conv = _causal_conv(conv_in, _whole(params, "conv_w", tp, dims),
                                      conv_state)
    conv_out = silu(conv_out)
    xin, b, c = torch.split(conv_out, [d_in, n, n], dim=-1)

    a = -torch.exp(params["a_log"])                        # (H,) < 0
    dt = softplus(dt_raw.to(torch.float32) + params["dt_bias"])

    xh = xin.reshape(bsz, l, n_heads, p)
    y, new_ssd = ssd_chunked(xh, dt, a, b, c, chunk)
    y = y + xh.to(torch.float32) * params["d_skip"][None, None, :, None]
    y = y.reshape(bsz, l, d_in).to(x.dtype)
    y = y * silu(z)
    y = rms_norm(y, params["gate_norm"])
    out = y @ _whole(params, "out_proj", tp, dims)
    if conv_cut:
        new_conv = scatter_to_model(new_conv, tp, -1)
    if heads_cut:
        new_ssd = scatter_to_model(new_ssd, tp, 1)
    return out, {"conv": new_conv, "ssd": new_ssd}
