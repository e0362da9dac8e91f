"""yi-9b — [dense] 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 —
llama-arch GQA [arXiv:2403.04652; hf]. Port of ``repro.configs.yi_9b``."""

from repro_torch.models.transformer import ModelConfig

ARCH_ID = "yi-9b"


def config(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH_ID,
        family="dense",
        n_layers=48,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        vocab_size=64000,
        gated_mlp=True,
        activation="silu",
    )
    base.update(overrides)
    return ModelConfig(**base)


def reduced(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=160,
        vocab_size=128,
        gated_mlp=True,
    )
    base.update(overrides)
    return ModelConfig(**base)
