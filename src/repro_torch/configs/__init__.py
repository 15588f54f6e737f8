"""Model configurations: the port's own copy of ``repro.configs``.

The dense, MoE, Mamba2 (ssm) and hybrid architectures are registered
(whisper and llava, the audio and vlm families, are not); the serving
geometry (``ServeShape``, ``SERVE_SHAPES``, ``kv_geometry``) and the
assigned input shapes come from ``shapes``.
"""
from __future__ import annotations

from typing import Dict

from . import (deepseek_7b, gemma_2b, grok_1_314b, jamba_v01_52b,
               llama3_405b, mamba2_780m, qwen2_moe_a2_7b, qwen3_8b)
from .base import ModelConfig
from .shapes import (SERVE_SHAPES, SHAPES, ServeShape, ShapeConfig,
                     applicable, kv_geometry, skip_reason)

ARCHS: Dict[str, ModelConfig] = {
    "jamba-v0.1-52b": jamba_v01_52b.CONFIG,
    "grok-1-314b": grok_1_314b.CONFIG,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b.CONFIG,
    "gemma-2b": gemma_2b.CONFIG,
    "deepseek-7b": deepseek_7b.CONFIG,
    "llama3-405b": llama3_405b.CONFIG,
    "qwen3-8b": qwen3_8b.CONFIG,
    "mamba2-780m": mamba2_780m.CONFIG,
}

SMOKE_ARCHS: Dict[str, ModelConfig] = {
    "jamba-v0.1-52b": jamba_v01_52b.SMOKE,
    "grok-1-314b": grok_1_314b.SMOKE,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b.SMOKE,
    "gemma-2b": gemma_2b.SMOKE,
    "deepseek-7b": deepseek_7b.SMOKE,
    "llama3-405b": llama3_405b.SMOKE,
    "qwen3-8b": qwen3_8b.SMOKE,
    "mamba2-780m": mamba2_780m.SMOKE,
}

__all__ = ["ARCHS", "SMOKE_ARCHS", "ModelConfig", "SHAPES", "ShapeConfig",
           "SERVE_SHAPES", "ServeShape", "kv_geometry", "applicable",
           "skip_reason"]
