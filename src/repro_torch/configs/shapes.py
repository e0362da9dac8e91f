"""The input-shape suite and (arch × shape) applicability rules (port of
``repro.configs.shapes``).

LM shapes are seq_len × global_batch. ``decode_*`` / ``long_*`` cells run
one new token against a KV cache of seq_len. Skips: long_500k needs
sub-quadratic attention (SSM, hybrid or sliding-window archs only), and an
encoder-only arch (hubert) has no decode step.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.transformer import ModelConfig, init_cache


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """(runnable?, reason-if-skipped) for an (arch × shape) cell."""
    spec = SHAPES[shape_name]
    if spec.kind == "decode" and not cfg.causal:
        return False, "encoder-only arch has no decode step"
    if spec.kind == "prefill" and not cfg.causal:
        return True, ""  # encoder forward
    if shape_name == "long_500k":
        sub_quadratic = cfg.family in ("ssm", "hybrid") or cfg.sliding_window > 0
        if not sub_quadratic:
            return False, "pure full-attention arch: 500k context needs sub-quadratic attention"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Stand-ins for every model input of this cell: tensors on the
    ``meta`` device, so nothing is allocated. Tokens are int32; embedding
    stand-ins and the cache use ``cfg.compute_dtype``."""
    spec = SHAPES[shape_name]
    b, s = spec.global_batch, spec.seq_len
    cdt = cfg.cdtype()
    specs: dict = {}
    if spec.kind == "decode":
        specs["tokens"] = _meta((b, 1), torch.int32)
        specs["cache"] = init_cache(cfg, b, s, cdt, device="meta")
        specs["pos"] = _meta((), torch.int32)
    else:
        if cfg.family == "audio":
            specs["embeds"] = _meta((b, s, cfg.d_model), cdt)
        else:
            specs["tokens"] = _meta((b, s), torch.int32)
        if spec.kind == "train":
            specs["labels"] = _meta((b, s), torch.int32)
    if cfg.family == "vlm":
        specs["vision_embeds"] = _meta((b, cfg.n_patches, cfg.d_model), cdt)
    return specs
