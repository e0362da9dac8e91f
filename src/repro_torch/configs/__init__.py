"""Architecture registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``
plus the input-shape suite (port of ``repro.configs``; see ``shapes.py``).

Ten architectures: four dense (granite-20b, gemma3-4b, olmo-1b, yi-9b), a
hybrid (zamba2-1.2b), an SSM (mamba2-370m), a vision-language model
(llama-3.2-vision-11b), two MoE (qwen3-moe-30b-a3b, deepseek-moe-16b) and
an audio encoder (hubert-xlarge)."""

from __future__ import annotations

from repro_torch.configs import (
    deepseek_moe_16b,
    gemma3_4b,
    granite_20b,
    hubert_xlarge,
    llama32_vision_11b,
    mamba2_370m,
    olmo_1b,
    qwen3_moe_30b,
    yi_9b,
    zamba2_1p2b,
)
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable, input_specs

_MODULES = {
    granite_20b.ARCH_ID: granite_20b,
    gemma3_4b.ARCH_ID: gemma3_4b,
    olmo_1b.ARCH_ID: olmo_1b,
    yi_9b.ARCH_ID: yi_9b,
    zamba2_1p2b.ARCH_ID: zamba2_1p2b,
    mamba2_370m.ARCH_ID: mamba2_370m,
    llama32_vision_11b.ARCH_ID: llama32_vision_11b,
    qwen3_moe_30b.ARCH_ID: qwen3_moe_30b,
    deepseek_moe_16b.ARCH_ID: deepseek_moe_16b,
    hubert_xlarge.ARCH_ID: hubert_xlarge,
}

ARCH_IDS = list(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return _MODULES[arch_id]


def get_config(arch_id: str, **overrides):
    return _module(arch_id).config(**overrides)


def get_reduced(arch_id: str, **overrides):
    return _module(arch_id).reduced(**overrides)


__all__ = [
    "ARCH_IDS", "get_config", "get_reduced",
    "SHAPES", "ShapeSpec", "applicable", "input_specs",
]
