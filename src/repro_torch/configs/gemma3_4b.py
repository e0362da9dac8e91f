"""gemma3-4b — [dense] 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144 — 5:1 local:global sliding window, 128k context
[hf:google/gemma-3-1b-pt; unverified]. Port of ``repro.configs.gemma3_4b``."""

from repro_torch.models.transformer import ModelConfig

ARCH_ID = "gemma3-4b"


def config(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH_ID,
        family="dense",
        n_layers=34,
        d_model=2560,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=10240,
        vocab_size=262144,
        gated_mlp=True,
        activation="gelu",          # GeGLU
        sliding_window=1024,
        global_every=6,             # 5 local : 1 global
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )
    base.update(overrides)
    return ModelConfig(**base)


def reduced(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=6,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        gated_mlp=True,
        activation="gelu",
        sliding_window=8,
        global_every=6,
        tie_embeddings=True,
    )
    base.update(overrides)
    return ModelConfig(**base)
