"""Model zoo of the port: the decoder-only transformer (dense and MoE),
Mamba2, and the Jamba-style hybrid."""
from __future__ import annotations

from typing import Any, Optional, Union

import torch

from ..configs.base import ModelConfig
from . import hybrid, ssm, transformer
from .hybrid import HybridLM
from .ssm import MambaLM
from .transformer import TransformerLM

__all__ = ["get_model", "param_specs", "TransformerLM", "MambaLM",
           "HybridLM"]

_FAMILIES = {"dense": (TransformerLM, transformer.param_specs),
             "moe": (TransformerLM, transformer.param_specs),
             "ssm": (MambaLM, ssm.param_specs),
             "hybrid": (HybridLM, hybrid.param_specs)}


def _family(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to PyTorch yet")
    return _FAMILIES[cfg.family]


def get_model(cfg: ModelConfig, impl: str = "cuda",
              device: Optional[Union[str, torch.device]] = None
              ) -> Union[TransformerLM, MambaLM, HybridLM]:
    """The model for ``cfg``; audio and vlm are not ported."""
    return _family(cfg)[0](cfg, impl, device)


def param_specs(cfg: ModelConfig) -> Any:
    """The param tree spec of ``cfg``'s family."""
    return _family(cfg)[1](cfg)
