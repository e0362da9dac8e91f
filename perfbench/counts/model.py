"""Model FLOPs from the shapes of a configuration, with no recomputation:
what ``mfu`` divides by the window and the peak.

- Transformer LM (``lm_*``): the matmul parameters of one token's forward
  (every layer's projections and MLP, and the output head: a tied table
  counts once, as the head; the input lookup is no matmul) at 2 FLOPs a
  parameter, plus attention's two products, 2·S·(H·hd) FLOPs each per token
  and layer, counted over all S keys (PaLM's convention, arXiv:2204.02311
  app. B: training is 6·N + 12·L·(H·hd)·S per token).
- ResNet18* (``resnet_*``): every conv's and the head's multiply-adds at 2
  FLOPs each; training one sample is 3 forwards.
"""

from __future__ import annotations


def lm_head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def lm_layer_params(m: dict) -> int:
    """Matmul parameters of one dense layer."""
    d, hd = m["d_model"], lm_head_dim(m)
    attn = d * m["n_heads"] * hd * 2 + d * m["n_kv_heads"] * hd * 2
    mlp = d * m["d_ff"] * (3 if m.get("gated_mlp", True) else 2)
    return attn + mlp


def lm_matmul_params(m: dict) -> int:
    """Matmul parameters of one token's forward, the head included."""
    return m["n_layers"] * lm_layer_params(m) + m["vocab_size"] * m["d_model"]


def lm_params(m: dict) -> int:
    """Every parameter (norm scales included where the norm has them)."""
    n = lm_matmul_params(m) + (0 if m.get("tie_embeddings") else m["vocab_size"] * m["d_model"])
    if m.get("norm", "rmsnorm") != "nonparam":
        n += m["d_model"] * (2 * m["n_layers"] + 1)
    return n


def lm_attention_flops_per_token(m: dict, seq: int) -> int:
    """Forward FLOPs of QKᵀ and PV for one query token over ``seq`` keys."""
    return 4 * m["n_layers"] * m["n_heads"] * lm_head_dim(m) * seq


def lm_forward_flops(m: dict, batch: int, seq: int) -> int:
    tokens = batch * seq
    return tokens * (2 * lm_matmul_params(m) + lm_attention_flops_per_token(m, seq))


def lm_train_flops(m: dict, batch: int, seq: int) -> int:
    """One training step: forward and backward (3 forwards), no remat."""
    return 3 * lm_forward_flops(m, batch, seq)


def resnet_convs(m: dict) -> list:
    """(out_h, out_w, k, c_in, c_out) of every conv of ResNet18*: the stem,
    then 8 basic blocks at ``width`` channels, the first conv of blocks 2,
    4 and 6 at stride 2 ("SAME": the output is ⌈size / 2⌉)."""
    h, w = m["image_hw"][0], m["image_hw"][1]
    width, k = m["width"], 3
    convs = [(h, w, k, m["image_hw"][2], width)]
    for b in range(m["blocks"]):
        if b in m["downsample_blocks"]:
            h, w = -(-h // 2), -(-w // 2)
        convs += [(h, w, k, width, width), (h, w, k, width, width)]
    return convs


def resnet_forward_flops(m: dict) -> int:
    """One sample's forward: the convs and the dense head."""
    conv = sum(2 * oh * ow * k * k * ci * co for oh, ow, k, ci, co in resnet_convs(m))
    return conv + 2 * m["width"] * m["n_classes"]


def resnet_train_flops(m: dict) -> int:
    return 3 * resnet_forward_flops(m)


def resnet_quantized_weights(m: dict) -> int:
    """Weights the FTTQ quantizer ternarizes: every conv and the head's
    matrix (norms and biases stay full precision)."""
    return sum(k * k * ci * co for _, _, k, ci, co in resnet_convs(m)) + m["width"] * m["n_classes"]


def resnet_params(m: dict) -> int:
    """Every parameter: the quantized weights, GroupNorm scale and bias
    after the stem and each conv of a block, the head's bias."""
    norms = (1 + 2 * m["blocks"]) * 2 * m["width"]
    return resnet_quantized_weights(m) + norms + m["n_classes"]
