"""Architecture registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``
(port of ``repro.configs``). Only olmo-1b is ported; the reference's other
architecture ids raise ``NotImplementedError`` until their slice."""

from __future__ import annotations

from repro_torch.configs import olmo_1b

_MODULES = {olmo_1b.ARCH_ID: olmo_1b}
_NOT_PORTED = ("granite-20b", "gemma3-4b", "yi-9b", "zamba2-1.2b", "mamba2-370m",
               "llama-3.2-vision-11b", "qwen3-moe-30b-a3b", "deepseek-moe-16b",
               "hubert-xlarge")

ARCH_IDS = list(_MODULES)


def _module(arch_id: str):
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(f"arch {arch_id!r} is not ported yet")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return _MODULES[arch_id]


def get_config(arch_id: str, **overrides):
    return _module(arch_id).config(**overrides)


def get_reduced(arch_id: str, **overrides):
    return _module(arch_id).reduced(**overrides)


__all__ = ["ARCH_IDS", "get_config", "get_reduced"]
