"""Model configurations: the port's own copy of ``repro.configs``.

Only the dense architectures of the first slice are registered.
"""
from __future__ import annotations

from typing import Dict

from . import gemma_2b, qwen3_8b
from .base import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    "gemma-2b": gemma_2b.CONFIG,
    "qwen3-8b": qwen3_8b.CONFIG,
}

SMOKE_ARCHS: Dict[str, ModelConfig] = {
    "gemma-2b": gemma_2b.SMOKE,
    "qwen3-8b": qwen3_8b.SMOKE,
}

__all__ = ["ARCHS", "SMOKE_ARCHS", "ModelConfig"]
