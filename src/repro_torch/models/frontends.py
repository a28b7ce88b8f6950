"""Modality frontend stubs (port of ``repro/models/frontends.py``).

The audio path (mel spectrogram and conv codec) and the vision path (ViT
encoder and projector) are not implemented, as in the JAX package: the
models take precomputed frame or patch embeddings of these shapes, and
these helpers draw deterministic fake ones for smoke runs, each from an
explicit ``torch.Generator`` (its numbers are not ``jax.random``'s: a
test that compares the two feeds both the same arrays).
"""
from __future__ import annotations

import torch

from .config import ModelConfig


def audio_frames_shape(cfg: ModelConfig, batch: int):
    """Whisper: post-conv frame embeddings (B, enc_seq, d_model)."""
    return (batch, cfg.enc_seq, cfg.d_model)


def vision_patches_shape(cfg: ModelConfig, batch: int):
    """VLM: projected patch embeddings (B, vision_seq, d_model)."""
    return (batch, cfg.vision_seq, cfg.d_model)


def fake_audio_frames(cfg: ModelConfig, batch: int, gen: torch.Generator,
                      dtype=torch.float32):
    """N(0, 0.02^2) frames of ``audio_frames_shape``, drawn from ``gen``
    on its device."""
    return _normal(audio_frames_shape(cfg, batch), gen, dtype)


def fake_vision_patches(cfg: ModelConfig, batch: int, gen: torch.Generator,
                        dtype=torch.float32):
    """N(0, 0.02^2) patches of ``vision_patches_shape``, drawn from
    ``gen`` on its device."""
    return _normal(vision_patches_shape(cfg, batch), gen, dtype)


def _normal(shape, gen: torch.Generator, dtype):
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * 0.02).to(dtype)
