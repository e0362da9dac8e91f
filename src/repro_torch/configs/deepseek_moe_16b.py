"""deepseek-moe-16b — [moe] 28L d_model=2048 16H (MHA) expert d_ff=1408
vocab=102400 — 2 shared + 64 routed experts, top-6, fine-grained
[arXiv:2401.06066; hf]. Port of ``repro.configs.deepseek_moe_16b``."""

from repro_torch.models.transformer import ModelConfig

ARCH_ID = "deepseek-moe-16b"


def config(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH_ID,
        family="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        moe_d_ff=1408,
        n_experts=64,
        top_k=6,
        n_shared_experts=2,
        shared_d_ff=2816,           # 2 shared experts fused: 2 × 1408
        vocab_size=102400,
        gated_mlp=True,
        activation="silu",
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
        n_kv_heads=4,
        head_dim=16,
        moe_d_ff=32,
        n_experts=8,
        top_k=2,
        n_shared_experts=2,
        shared_d_ff=64,
        vocab_size=128,
        gated_mlp=True,
    )
    base.update(overrides)
    return ModelConfig(**base)
