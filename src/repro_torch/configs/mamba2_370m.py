"""mamba2-370m — [ssm] 48L d_model=1024 (attn-free) vocab=50280
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060; unverified].
Port of ``repro.configs.mamba2_370m``."""

from repro_torch.models.transformer import ModelConfig

ARCH_ID = "mamba2-370m"


def config(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH_ID,
        family="ssm",
        n_layers=48,
        d_model=1024,
        vocab_size=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_heads=32,               # d_inner 2048 / head 64
        ssm_chunk=256,
        tie_embeddings=True,
    )
    base.update(overrides)
    return ModelConfig(**base)


def reduced(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH_ID + "-smoke",
        family="ssm",
        n_layers=3,
        d_model=64,
        vocab_size=128,
        ssm_state=8,
        ssm_expand=2,
        ssm_heads=4,
        ssm_chunk=4,
        tie_embeddings=True,
    )
    base.update(overrides)
    return ModelConfig(**base)
