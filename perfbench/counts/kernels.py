"""Operations and bytes of the port's hand-written kernels at the shapes a
cell drives, and their least time on the card: the larger of operations
over the peak and bytes over HBM's bandwidth. Each input byte is read once
and each output byte written once.

- Row 8, ``qat_backward`` (fp32 entry): per weight it reads the cotangent
  g and the code I_t and writes g_θ and g·I_t, 4 bytes each, and does two
  multiplies (g·w_q and g·I_t); w_q and its cut are one scalar a row.
- Row 8b, ``qat_backward_bf16``: the same at 2 bytes a value.
- Row 2d, ``ternary_matmul_bf16`` at prefill: y (M, N) = x (M, K) @
  (w_q · W): 2·M·K·N operations on the tensor cores; bytes x (2 a value),
  the 2-bit codes (K·N/4), w_q (4) and y (2 a value).
"""

from __future__ import annotations

from perfbench.counts import peaks


def bound_s(ops: float, nbytes: float, peak_ops: float) -> float:
    return max(ops / peak_ops, nbytes / peaks.HBM_BYTES)


def qat_backward_bound_s(weights: int) -> float:
    return bound_s(2 * weights, 16 * weights, peaks.FP32_FLOPS)


def qat_backward_bf16_bound_s(weights: int) -> float:
    return bound_s(2 * weights, 8 * weights, peaks.BF16_FLOPS)


def ternary_matmul_bf16_bytes(m: int, k: int, n: int) -> int:
    return 2 * m * k + k * n // 4 + 4 + 2 * m * n


def ternary_matmul_bf16_bound_s(m: int, k: int, n: int) -> float:
    return bound_s(2 * m * k * n, ternary_matmul_bf16_bytes(m, k, n), peaks.BF16_FLOPS)


def lm_ternary_matmuls(model: dict, rows: int) -> list:
    """(M, K, N) of every packed weight matmul of one LM forward over
    ``rows`` token rows: per layer wq, wk, wv, wo, then w_in, w_gate (when
    gated) and w_out. The head (a tied embedding) is dense."""
    d, hd = model["d_model"], model.get("head_dim") or model["d_model"] // model["n_heads"]
    h, hk, f = model["n_heads"] * hd, model["n_kv_heads"] * hd, model["d_ff"]
    layer = [(rows, d, h), (rows, d, hk), (rows, d, hk), (rows, h, d), (rows, d, f)]
    if model.get("gated_mlp", True):
        layer.append((rows, d, f))
    layer.append((rows, f, d))
    return layer * model["n_layers"]


def lm_quantized_leaf_weights(model: dict) -> list:
    """Weights of each quantized leaf of the LM (stacked over layers, one
    QAT backward launch a leaf): wq, wk, wv, wo, w_in, w_gate, w_out."""
    one_layer = lm_ternary_matmuls({**model, "n_layers": 1}, 0)
    return [model["n_layers"] * k * n for _, k, n in one_layer]
