"""Model zoo: build a ported architecture from its ModelConfig."""
from __future__ import annotations

from .config import MLAConfig, ModelConfig, MoEConfig, SSMConfig, smoke_variant
from .transformer import TransformerLM


def build_model(cfg: ModelConfig, device=None) -> TransformerLM:
    """Model for ``cfg`` on ``device`` (default ``cuda``; raises when no
    GPU is present and no device was named).  Dense, MoE (without MLA)
    and hybrid Mamba+attention families; the others raise
    NotImplementedError naming their ROADMAP item."""
    return TransformerLM(cfg, device=device)


__all__ = ["ModelConfig", "MLAConfig", "MoEConfig", "SSMConfig",
           "smoke_variant", "build_model", "TransformerLM"]
