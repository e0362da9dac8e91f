"""The closed-form FLOP and byte counts behind ``mfu`` and the rooflines,
held to hand counts at small shapes, to PyTorch's FLOP counter over the
plain references, and to the published parameter counts."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import common
from perfbench.counts import kernels, model, peaks
from perfbench.reference import olmo, resnet

ROOT = Path(__file__).resolve().parents[2]
SMALL_LM = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 2, "d_ff": 16,
            "vocab_size": 32, "norm": "nonparam", "gated_mlp": True, "tie_embeddings": True}
SMALL_RESNET = {"width": 8, "blocks": 8, "downsample_blocks": [2, 4, 6], "n_classes": 10,
                "image_hw": [8, 8, 3]}


def _config(name: str) -> dict:
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())["model"]


def test_lm_counts_by_hand():
    # per layer: q, k, v, o 4·8·8 = 256, gated MLP 3·8·16 = 384; head 32·8
    assert model.lm_layer_params(SMALL_LM) == 640
    assert model.lm_matmul_params(SMALL_LM) == 2 * 640 + 256
    # tokens 3·5 = 15: 2·1536 a token, attention 4·2·(2·4)·5 = 320 a token
    assert model.lm_forward_flops(SMALL_LM, 3, 5) == 15 * (3072 + 320)
    assert model.lm_train_flops(SMALL_LM, 3, 5) == 3 * 15 * (3072 + 320)


def _explicit_attention(q, k, v, is_causal=False):
    """Attention as two full matmuls (what the count counts: every key)."""
    s = q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5
    if is_causal:
        s = s.masked_fill(torch.ones_like(s, dtype=torch.bool).triu(1), float("-inf"))
    return torch.softmax(s, dim=-1) @ v


def test_lm_forward_flops_match_the_counter(monkeypatch):
    w = {p: t.float() for p, t in common.draw_lm(SMALL_LM, 1, torch.float32, "cpu").items()}
    tokens = torch.randint(0, 32, (3, 5))
    want = olmo.logits(SMALL_LM, w, tokens, remat=False)
    monkeypatch.setattr(olmo.F, "scaled_dot_product_attention", _explicit_attention)
    with FlopCounterMode(display=False) as fc:
        got = olmo.logits(SMALL_LM, w, tokens, remat=False)
    torch.testing.assert_close(got, want)
    assert fc.get_total_flops() == model.lm_forward_flops(SMALL_LM, 3, 5)


def test_olmo_1b_parameter_count():
    m = _config("olmo-1b")
    # 16 layers of 4·2048² + 3·2048·8192, and the tied 50,304 × 2,048 table
    assert model.lm_params(m) == 16 * (4 * 2048 ** 2 + 3 * 2048 * 8192) + 50304 * 2048
    assert sum(kernels.lm_quantized_leaf_weights(m)) == 2 ** 30
    assert model.lm_train_flops(m, 8, 4096) == pytest.approx(2.84e14, rel=0.01)


def test_resnet_counts_by_hand():
    # stem 8·8·9·3·8 MACs, blocks 0-1 at 8×8, 2-3 at 4×4, 4-5 at 2×2, 6-7 at 1×1
    macs = 8 * 8 * 9 * 3 * 8 + 9 * 8 * 8 * 4 * (64 + 16 + 4 + 1) + 8 * 10
    assert model.resnet_forward_flops(SMALL_RESNET) == 2 * macs
    assert model.resnet_train_flops(SMALL_RESNET) == 6 * macs


def test_resnet_forward_flops_match_the_counter():
    p = resnet.init_params(SMALL_RESNET, 1, "cpu")
    with FlopCounterMode(display=False) as fc:
        resnet.forward(SMALL_RESNET, p, torch.randn(2, 8, 8, 3))
    assert fc.get_total_flops() == 2 * model.resnet_forward_flops(SMALL_RESNET)


def test_resnet18_is_the_papers_594378_parameters():
    m = _config("resnet18-cifar10")
    assert model.resnet_params(m) == 594378
    flat = resnet.flatten(resnet.init_params(m, 0, "cpu"))
    assert sum(t.numel() for t in flat.values()) == 594378
    assert sum(t.numel() for p, t in flat.items() if p.endswith("/w")) == \
        model.resnet_quantized_weights(m)


def test_kernel_bounds_by_hand():
    # row 8: 16 bytes a weight over HBM; row 8b: 8
    assert kernels.qat_backward_bound_s(10 ** 6) == pytest.approx(16e6 / peaks.HBM_BYTES)
    assert kernels.qat_backward_bf16_bound_s(10 ** 6) == pytest.approx(8e6 / peaks.HBM_BYTES)
    # row 2d at a prefill shape is bound by its operations, at M = 4 by its bytes
    m, k, n = 8192, 2048, 8192
    assert kernels.ternary_matmul_bf16_bound_s(m, k, n) == pytest.approx(
        2 * m * k * n / peaks.BF16_FLOPS)
    assert kernels.ternary_matmul_bf16_bytes(4, 8, 16) == 2 * 4 * 8 + 8 * 16 // 4 + 4 + 2 * 4 * 16
    assert kernels.ternary_matmul_bf16_bound_s(4, 2048, 2048) == pytest.approx(
        kernels.ternary_matmul_bf16_bytes(4, 2048, 2048) / peaks.HBM_BYTES)


def test_lm_matmul_shapes_of_one_forward():
    shapes = kernels.lm_ternary_matmuls(SMALL_LM, 6)
    assert len(shapes) == 2 * 7
    assert shapes[:7] == [(6, 8, 8), (6, 8, 8), (6, 8, 8), (6, 8, 8), (6, 8, 16), (6, 8, 16),
                          (6, 16, 8)]
    assert sum(k * n for _, k, n in shapes) == SMALL_LM["n_layers"] * model.lm_layer_params(
        SMALL_LM)
