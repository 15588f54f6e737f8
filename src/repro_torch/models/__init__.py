"""Model zoo of the port: the decoder-only transformer (dense and MoE),
Mamba2, the Jamba-style hybrid, the Whisper-style encoder-decoder (audio)
and the LLaVA-style VLM: every family of the reference."""
from __future__ import annotations

from typing import Any, Optional, Union

import torch

from ..configs.base import ModelConfig
from . import encdec, hybrid, ssm, transformer
from .encdec import EncDecLM
from .hybrid import HybridLM
from .ssm import MambaLM
from .transformer import TransformerLM
from .vlm import VlmLM

__all__ = ["get_model", "param_specs", "TransformerLM", "MambaLM",
           "HybridLM", "EncDecLM", "VlmLM"]

Model = Union[TransformerLM, MambaLM, HybridLM, EncDecLM, VlmLM]

_FAMILIES = {"dense": (TransformerLM, transformer.param_specs),
             "moe": (TransformerLM, transformer.param_specs),
             "ssm": (MambaLM, ssm.param_specs),
             "hybrid": (HybridLM, hybrid.param_specs),
             "audio": (EncDecLM, encdec.param_specs),
             "vlm": (VlmLM, transformer.param_specs)}


def _family(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}")
    return _FAMILIES[cfg.family]


def get_model(cfg: ModelConfig, impl: str = "cuda",
              device: Optional[Union[str, torch.device]] = None) -> Model:
    """The model for ``cfg``'s family."""
    return _family(cfg)[0](cfg, impl, device)


def param_specs(cfg: ModelConfig) -> Any:
    """The param tree spec of ``cfg``'s family."""
    return _family(cfg)[1](cfg)
