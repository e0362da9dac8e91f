"""zamba2-1.2b — [hybrid] 38L d_model=2048 32H (MHA) d_ff=8192 vocab=32000
ssm_state=64 — Mamba2 backbone + SHARED attention block applied every 6
layers [arXiv:2411.15242; hf]. Port of ``repro.configs.zamba2_1p2b``."""

from repro_torch.models.transformer import ModelConfig

ARCH_ID = "zamba2-1.2b"


def config(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH_ID,
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=32000,
        ssm_state=64,
        ssm_expand=2,
        ssm_heads=64,               # d_inner 4096 / head 64
        attn_every=6,               # 7 shared-attn applications over 38 layers
        gated_mlp=True,
        activation="silu",
    )
    base.update(overrides)
    return ModelConfig(**base)


def reduced(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH_ID + "-smoke",
        family="hybrid",
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        ssm_state=8,
        ssm_expand=2,
        ssm_heads=8,
        ssm_chunk=4,
        attn_every=2,
        gated_mlp=True,
    )
    base.update(overrides)
    return ModelConfig(**base)
