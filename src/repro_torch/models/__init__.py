"""Model zoo of the port: the dense decoder-only transformer."""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..configs.base import ModelConfig
from .transformer import TransformerLM

__all__ = ["get_model", "TransformerLM"]


def get_model(cfg: ModelConfig, impl: str = "cuda",
              device: Optional[Union[str, torch.device]] = None
              ) -> TransformerLM:
    """The model for ``cfg``; only the dense family is ported so far."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to PyTorch yet")
    return TransformerLM(cfg, impl, device)
