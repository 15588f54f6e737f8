"""Model configurations: the port's own copy of ``repro.configs``.

The dense architectures and the Mamba2 (ssm) one are registered; the
serving geometry (``ServeShape``, ``SERVE_SHAPES``, ``kv_geometry``) and the
assigned input shapes come from ``shapes``.
"""
from __future__ import annotations

from typing import Dict

from . import deepseek_7b, gemma_2b, mamba2_780m, qwen3_8b
from .base import ModelConfig
from .shapes import (SERVE_SHAPES, SHAPES, ServeShape, ShapeConfig,
                     applicable, kv_geometry, skip_reason)

ARCHS: Dict[str, ModelConfig] = {
    "gemma-2b": gemma_2b.CONFIG,
    "deepseek-7b": deepseek_7b.CONFIG,
    "qwen3-8b": qwen3_8b.CONFIG,
    "mamba2-780m": mamba2_780m.CONFIG,
}

SMOKE_ARCHS: Dict[str, ModelConfig] = {
    "gemma-2b": gemma_2b.SMOKE,
    "deepseek-7b": deepseek_7b.SMOKE,
    "qwen3-8b": qwen3_8b.SMOKE,
    "mamba2-780m": mamba2_780m.SMOKE,
}

__all__ = ["ARCHS", "SMOKE_ARCHS", "ModelConfig", "SHAPES", "ShapeConfig",
           "SERVE_SHAPES", "ServeShape", "kv_geometry", "applicable",
           "skip_reason"]
