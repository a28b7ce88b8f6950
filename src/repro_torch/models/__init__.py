"""Model zoo: build a ported architecture from its ModelConfig."""
from __future__ import annotations

from .config import MLAConfig, ModelConfig, MoEConfig, SSMConfig, smoke_variant
from .transformer import TransformerLM


def build_model(cfg: ModelConfig, device=None,
                mla_absorb: bool = False) -> TransformerLM:
    """Model for ``cfg`` on ``device`` (default ``cuda``; raises when no
    GPU is present and no device was named).  Dense, MoE (GQA or MLA),
    hybrid Mamba+attention and xLSTM families; encoder-decoder and the
    VLM raise NotImplementedError naming their ROADMAP item.
    ``mla_absorb``: MLA decode in the latent space."""
    return TransformerLM(cfg, device=device, mla_absorb=mla_absorb)


__all__ = ["ModelConfig", "MLAConfig", "MoEConfig", "SSMConfig",
           "smoke_variant", "build_model", "TransformerLM"]
