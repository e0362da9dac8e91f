"""qwen3-moe-30b-a3b — [moe] 48L d_model=2048 32H (GQA kv=4) expert d_ff=768
vocab=151936 — 128 experts, top-8 routing [hf:Qwen/Qwen3-30B-A3B; hf].
Port of ``repro.configs.qwen3_moe_30b``."""

from repro_torch.models.transformer import ModelConfig

ARCH_ID = "qwen3-moe-30b-a3b"


def config(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH_ID,
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        moe_d_ff=768,
        n_experts=128,
        top_k=8,
        vocab_size=151936,
        gated_mlp=True,
        activation="silu",
        rope_theta=1_000_000.0,
    )
    base.update(overrides)
    return ModelConfig(**base)


def reduced(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH_ID + "-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        moe_d_ff=32,
        n_experts=8,
        top_k=2,
        vocab_size=128,
        gated_mlp=True,
    )
    base.update(overrides)
    return ModelConfig(**base)
