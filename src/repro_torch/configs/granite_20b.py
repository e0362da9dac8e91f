"""granite-20b — [dense] 52L d_model=6144 48H (GQA kv=1 ⇒ MQA) d_ff=24576
vocab=49152 — llama-arch, code [arXiv:2405.04324; hf].
Port of ``repro.configs.granite_20b``."""

from repro_torch.models.transformer import ModelConfig

ARCH_ID = "granite-20b"


def config(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH_ID,
        family="dense",
        n_layers=52,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        head_dim=128,
        d_ff=24576,
        vocab_size=49152,
        gated_mlp=False,
        activation="gelu",
        norm="layernorm",
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
        n_kv_heads=1,
        head_dim=16,
        d_ff=256,
        vocab_size=128,
        gated_mlp=False,
        activation="gelu",
        norm="layernorm",
    )
    base.update(overrides)
    return ModelConfig(**base)
