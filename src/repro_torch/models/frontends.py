"""Modality frontend stubs (port of ``repro.models.frontends``): the audio
and vision entries specify the transformer backbone only, so the backbone
consumes precomputed frame or patch embeddings. These helpers give their
shapes (``meta`` tensors, nothing allocated) and synthetic embeddings from a
seeded ``torch.Generator``; no conv feature extractor or ViT runs."""

from __future__ import annotations

import torch


def audio_frame_embeds_spec(batch: int, frames: int, d_model: int, dtype):
    """HuBERT-style: 20 ms frames already projected to d_model."""
    return torch.empty((batch, frames, d_model), dtype=dtype, device="meta")


def vision_patch_embeds_spec(batch: int, n_patches: int, d_model: int, dtype):
    """Llama-3.2-Vision-style: patch embeddings from the (stubbed) ViT."""
    return torch.empty((batch, n_patches, d_model), dtype=dtype, device="meta")


def _synth(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return x.mul_(0.02).to(dtype)


def synth_audio_frames(gen: torch.Generator, batch: int, frames: int, d_model: int,
                       dtype=torch.float32) -> torch.Tensor:
    """N(0, 0.02²) frame embeddings on the generator's device."""
    return _synth(gen, (batch, frames, d_model), dtype)


def synth_vision_patches(gen: torch.Generator, batch: int, n_patches: int, d_model: int,
                         dtype=torch.float32) -> torch.Tensor:
    """N(0, 0.02²) patch embeddings on the generator's device."""
    return _synth(gen, (batch, n_patches, d_model), dtype)
