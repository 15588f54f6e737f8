"""Model zoo of the port: the dense decoder-only transformer and Mamba2."""
from __future__ import annotations

from typing import Any, Optional, Union

import torch

from ..configs.base import ModelConfig
from . import ssm, transformer
from .ssm import MambaLM
from .transformer import TransformerLM

__all__ = ["get_model", "param_specs", "TransformerLM", "MambaLM"]

_FAMILIES = {"dense": (TransformerLM, transformer.param_specs),
             "ssm": (MambaLM, ssm.param_specs)}


def _family(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to PyTorch yet")
    return _FAMILIES[cfg.family]


def get_model(cfg: ModelConfig, impl: str = "cuda",
              device: Optional[Union[str, torch.device]] = None
              ) -> Union[TransformerLM, MambaLM]:
    """The model for ``cfg``; moe, hybrid, audio and vlm are not ported."""
    return _family(cfg)[0](cfg, impl, device)


def param_specs(cfg: ModelConfig) -> Any:
    """The param spec tree of ``cfg``'s family."""
    return _family(cfg)[1](cfg)
