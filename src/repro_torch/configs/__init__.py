"""Config registry: ``get_config("glm4-9b")`` / ``--arch glm4-9b``."""
from __future__ import annotations

import importlib
from typing import Dict

from ..models.config import ModelConfig, smoke_variant
from .shapes import SHAPES, InputShape

_MODULES = {
    "whisper-tiny": "whisper_tiny",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "nemotron-4-340b": "nemotron_4_340b",
    "glm4-9b": "glm4_9b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "dbrx-132b": "dbrx_132b",
    "xlstm-350m": "xlstm_350m",
    "qwen2.5-32b": "qwen2_5_32b",
    "smollm-360m": "smollm_360m",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    cfg = mod.CONFIG
    return smoke_variant(cfg) if smoke else cfg


def all_configs(smoke: bool = False) -> Dict[str, ModelConfig]:
    return {a: get_config(a, smoke=smoke) for a in ARCH_IDS}


__all__ = ["get_config", "all_configs", "ARCH_IDS", "SHAPES", "InputShape"]
