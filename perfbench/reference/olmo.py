"""OLMo (arXiv:2402.00838) in plain PyTorch: the decoder-only transformer
with non-parametric LayerNorm, rotary embeddings on halves, full causal
multi-head attention, a SwiGLU MLP and an output head tied to the input
embedding; its next-token loss, and QAT training with FTTQ's
straight-through estimator (arXiv:2003.03564 Algorithm 1), global-norm
clipping and Adam.

Activations are float32 (TF32 off: ``float32_matmuls``), whatever dtype the
weights are stored in; ``act="fp8"`` rounds the inputs of every weight
matmul to float8 e4m3 with a per-tensor scale (the control of a bf16
configuration). Each layer is recomputed in the backward pass
(``torch.utils.checkpoint``), so a full-width step fits beside the state.

Departure noted: the LayerNorm epsilon is 1e-6, the repo's (both packages
use it for every non-parametric norm), not OLMo's published 1e-5. At
initialization the embedding's variance is 4e-4, so the two give first
layers ~1% apart: the reference computes the system's function, and the
published epsilon is an open question of the model, not of arithmetic.

The parameter tree is the benchmark's: ``embed/table`` (V, D) and
``blocks/{attn/{wq,wk,wv,wo}, mlp/{w_in,w_gate,w_out}}`` stacked (L, in, out).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference import fttq

LN_EPS = 1e-6
FP8_MAX = 448.0
LEAVES = ("blocks/attn/wq", "blocks/attn/wk", "blocks/attn/wv", "blocks/attn/wo",
          "blocks/mlp/w_in", "blocks/mlp/w_gate", "blocks/mlp/w_out")


@contextlib.contextmanager
def float32_matmuls():
    """TF32 off for matmuls and cuDNN inside the block."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


@contextlib.contextmanager
def tf32_matmuls():
    """TF32 on for matmuls and cuDNN inside the block: the control of a
    float32 configuration."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at a per-tensor scale, differentiable as
    the identity."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    q = (x.detach() * (FP8_MAX / amax)).to(torch.float8_e4m3fn).float() * (amax / FP8_MAX)
    return x + (q - x).detach()


def _mm(x, w, act):
    return fp8(x) @ fp8(w) if act == "fp8" else x @ w


def layer_norm(x):
    return F.layer_norm(x, (x.shape[-1],), eps=LN_EPS)


def rope(x, theta: float):
    """Rotate (B, H, S, hd) on halves: pairs dim i with i + hd/2."""
    s, hd = x.shape[-2], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd))
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _layer(m: dict, act: str, x, wq, wk, wv, wo, w_in, w_gate, w_out):
    b, s, d = x.shape
    h, hk = m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or d // h
    y = layer_norm(x)
    q = _mm(y, wq, act).view(b, s, h, hd).transpose(1, 2)
    k = _mm(y, wk, act).view(b, s, hk, hd).transpose(1, 2)
    v = _mm(y, wv, act).view(b, s, hk, hd).transpose(1, 2)
    theta = m.get("rope_theta", 10000.0)
    q, k = rope(q, theta), rope(k, theta)
    if hk != h:
        k = k.repeat_interleave(h // hk, dim=1)
        v = v.repeat_interleave(h // hk, dim=1)
    o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    x = x + _mm(o.transpose(1, 2).reshape(b, s, h * hd), wo, act)
    y = layer_norm(x)
    return x + _mm(F.silu(_mm(y, w_gate, act)) * _mm(y, w_in, act), w_out, act)


def logits(m: dict, weights: dict, tokens: torch.Tensor, act: str = "fp32",
           remat: bool = True) -> torch.Tensor:
    """(B, S, V) float32 logits; ``weights`` maps each leaf path to its
    float32 tensor (the quantized ones already w_q · I_t)."""
    table = weights["embed/table"]
    x = table[tokens]
    for i in range(m["n_layers"]):
        args = [weights[p][i] for p in LEAVES]
        if remat and torch.is_grad_enabled():
            x = checkpoint(_layer, m, act, x, *args, use_reentrant=False)
        else:
            x = _layer(m, act, x, *args)
    return _mm(layer_norm(x), table.t(), act)


def token_logprobs(m: dict, weights: dict, tokens: torch.Tensor, act: str = "fp32"):
    """log p(tokens[:, t+1] | tokens[:, :t+1]), (B, S-1) float32."""
    with torch.no_grad():
        lp = torch.log_softmax(logits(m, weights, tokens, act, remat=False), dim=-1)
        return lp[:, :-1].gather(-1, tokens[:, 1:, None])[..., 0]


def quantized_weights(m: dict, params: dict, factors: dict, t_k: float) -> tuple[dict, dict]:
    """({path: float32 weight}, {path: codes}) of the QAT forward: each
    quantized leaf's w_q · I_t per layer, the others as they are."""
    weights, all_codes = {}, {}
    for path, p in params.items():
        if path in factors:
            i_t = fttq.codes(fttq.rows_of(p, True), t_k).reshape(p.shape)
            all_codes[path] = i_t
            weights[path] = (i_t.float() * factors[path].float())
        else:
            weights[path] = p.detach().to(torch.float32, copy=True)
    return weights, all_codes


def train(m: dict, params: dict, batches: list, *, lr: float, microbatches: int,
          t_k: float, wq_lr: float = 0.05, clip: float = 1.0, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, act: str = "fp32",
          first_step_hook=None) -> dict:
    """QAT steps from ``params`` ({path: tensor} in the configured dtype),
    one a batch of ``batches`` ((tokens, labels), each (B, S)). Returns each
    step's loss, each leaf's clipped gradient norm at the first step (what
    Adam takes), each leaf's ‖params − params₀‖ after the last and the w_q
    factors after the last. ``first_step_hook(path, g, codes)`` sees each
    leaf's clipped first gradient and, for a quantized leaf, the codes of
    the first forward (``None`` for the others)."""
    dt = next(iter(params.values())).dtype
    p0 = params
    params = dict(params)
    factors = {path: fttq.init_factor(p, t_k) for path, p in params.items()
               if fttq.quantized(path, p.shape)}
    mom = {path: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for path, p in params.items()}
    vel = {path: torch.zeros_like(x) for path, x in mom.items()}
    losses, first_norms = [], {}
    for t, (tokens, labels) in enumerate(batches, start=1):
        weights, all_codes = quantized_weights(m, params, factors, t_k)
        for w in weights.values():
            w.requires_grad_(True)
        loss_sum = 0.0
        for tk, lb in zip(tokens.chunk(microbatches), labels.chunk(microbatches)):
            with torch.enable_grad():
                lo = logits(m, weights, tk, act)
                loss = F.cross_entropy(lo.reshape(-1, lo.shape[-1]), lb.reshape(-1))
                (loss / microbatches).backward()
            loss_sum += float(loss.detach()) / microbatches
            del lo, loss
        losses.append(loss_sum)
        grads, g_factor = {}, {}
        for path, w in weights.items():
            g = w.grad
            if path in factors:
                i_t = all_codes[path]
                n = factors[path].numel()
                g_factor[path] = (g.reshape(n, -1) * i_t.reshape(n, -1).float()).sum(dim=1)
                f = factors[path].float().reshape((n,) + (1,) * (g.ndim - 1))
                g = torch.where(i_t != 0, g * f, g)
            grads[path] = g
        del weights
        gnorm = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
        scale = min(1.0, clip / (gnorm + 1e-9))
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        for path in list(params):
            g = grads.pop(path) * scale
            if t == 1:
                first_norms[path] = float(g.double().norm())
                if first_step_hook is not None:
                    first_step_hook(path, g, all_codes.get(path))
            mom[path].mul_(b1).add_(g, alpha=1 - b1)
            vel[path].mul_(b2).add_(g.square(), alpha=1 - b2)
            u = -lr * (mom[path] / bc1) / ((vel[path] / bc2).sqrt() + eps)
            params[path] = (params[path].float() + u).to(dt)
            del g, u
        for path, f in factors.items():
            step = wq_lr * g_factor[path] / float(params[path].numel())
            factors[path] = (f.float() - step.reshape(f.shape)).to(f.dtype)
    change = {path: float((params[path].float() - p0[path].float()).double().norm())
              for path in params}
    return {"losses": losses, "first_grad_norms": first_norms, "change_norms": change,
            "factors": factors}
