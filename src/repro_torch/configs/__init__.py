"""Model configurations: the port's own copy of ``repro.configs``.

The dense architectures and the Mamba2 (ssm) one are registered.
"""
from __future__ import annotations

from typing import Dict

from . import gemma_2b, mamba2_780m, qwen3_8b
from .base import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    "gemma-2b": gemma_2b.CONFIG,
    "qwen3-8b": qwen3_8b.CONFIG,
    "mamba2-780m": mamba2_780m.CONFIG,
}

SMOKE_ARCHS: Dict[str, ModelConfig] = {
    "gemma-2b": gemma_2b.SMOKE,
    "qwen3-8b": qwen3_8b.SMOKE,
    "mamba2-780m": mamba2_780m.SMOKE,
}

__all__ = ["ARCHS", "SMOKE_ARCHS", "ModelConfig"]
