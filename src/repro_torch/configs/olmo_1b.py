"""olmo-1b — [dense] 16L d_model=2048 16H (MHA) d_ff=8192 vocab=50304 —
non-parametric LN [arXiv:2402.00838; hf]. Port of ``repro.configs.olmo_1b``."""

from repro_torch.models.transformer import ModelConfig

ARCH_ID = "olmo-1b"


def config(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH_ID,
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab_size=50304,
        norm="nonparam",            # OLMo's non-parametric LayerNorm
        gated_mlp=True,
        activation="silu",
        tie_embeddings=True,
    )
    base.update(overrides)
    return ModelConfig(**base)


def reduced(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=128,
        norm="nonparam",
        gated_mlp=True,
        tie_embeddings=True,
    )
    base.update(overrides)
    return ModelConfig(**base)
