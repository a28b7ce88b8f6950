"""Model zoo: build any assigned architecture from its ModelConfig."""
from __future__ import annotations

from .config import MLAConfig, ModelConfig, MoEConfig, SSMConfig, smoke_variant
from .encdec import EncDecLM
from .transformer import TransformerLM


def build_model(cfg: ModelConfig, device=None, mla_absorb: bool = False):
    """Model for ``cfg`` on ``device`` (default ``cuda``; raises when no
    GPU is present and no device was named): an ``EncDecLM`` for the
    encoder-decoder (``family`` "encdec"/"audio", or encoder layers),
    else a ``TransformerLM`` (dense, MoE with GQA or MLA, hybrid
    Mamba+attention, xLSTM, and the vision-language family).
    ``mla_absorb``: MLA decode in the latent space."""
    if cfg.family in ("encdec", "audio") or cfg.n_enc_layers:
        return EncDecLM(cfg, device=device)
    return TransformerLM(cfg, device=device, mla_absorb=mla_absorb)


__all__ = ["ModelConfig", "MLAConfig", "MoEConfig", "SSMConfig",
           "smoke_variant", "build_model", "TransformerLM", "EncDecLM"]
