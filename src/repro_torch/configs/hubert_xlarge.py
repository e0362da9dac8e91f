"""hubert-xlarge — [audio] 48L d_model=1280 16H (MHA) d_ff=5120 vocab=504 —
encoder-only (w2v2 arch); the conv waveform frontend is a STUB — inputs are
precomputed frame embeddings [arXiv:2106.07447; unverified].
Port of ``repro.configs.hubert_xlarge``."""

from repro_torch.models.transformer import ModelConfig

ARCH_ID = "hubert-xlarge"


def config(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH_ID,
        family="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,
        causal=False,               # encoder-only
        use_rope=False,
        norm="layernorm",
        gated_mlp=False,
        activation="gelu",
    )
    base.update(overrides)
    return ModelConfig(**base)


def reduced(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH_ID + "-smoke",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=37,
        causal=False,
        use_rope=False,
        norm="layernorm",
        gated_mlp=False,
        activation="gelu",
    )
    base.update(overrides)
    return ModelConfig(**base)
