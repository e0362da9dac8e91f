"""llama-3.2-vision-11b — [vlm] 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attn image layers every 5th layer; vision frontend is a
STUB (input_specs provides patch embeddings)
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].
Port of ``repro.configs.llama32_vision_11b``."""

from repro_torch.models.transformer import ModelConfig

ARCH_ID = "llama-3.2-vision-11b"


def config(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH_ID,
        family="vlm",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        cross_every=5,              # 8 cross-attention layers
        n_patches=1600,
        gated_mlp=True,
        activation="silu",
        rope_theta=500_000.0,
    )
    base.update(overrides)
    return ModelConfig(**base)


def reduced(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH_ID + "-smoke",
        family="vlm",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        cross_every=2,
        n_patches=8,
        gated_mlp=True,
    )
    base.update(overrides)
    return ModelConfig(**base)
