"""Carry the JAX reference's parameters over to the port.

``params_from_jax`` takes the reference's param pytree
(``repro.models.transformer.TransformerLM.init_params``, per-layer leaves
stacked on a leading L axis) as numpy arrays — bf16 leaves as ``ml_dtypes``
arrays or as float32 — and returns the port's param tree on ``device``.  The
structure and every leaf's shape are checked against the port's own
:func:`~repro_torch.models.transformer.param_specs` for the config.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from .configs.base import ModelConfig
from .device import resolve_device
from .models.layers import Params, dtype_of
from .models.transformer import map_params, param_specs

__all__ = ["params_from_jax"]


def params_from_jax(np_tree: Any, cfg: ModelConfig,
                    device: Optional[Union[str, torch.device]] = None,
                    dtype: Optional[torch.dtype] = None) -> Params:
    """Numpy param tree -> torch param tree of ``dtype`` (default: cfg's)."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg) if dtype is None else dtype

    def convert(spec, leaf):
        shape, _ = spec
        a = np.asarray(leaf)
        if a.shape != shape:
            raise ValueError(f"param shape {a.shape} != expected {shape}")
        # bf16 (ml_dtypes) widens to float32 exactly; torch casts back
        return torch.from_numpy(a.astype(np.float32)).to(device=dev,
                                                          dtype=dtype)

    return map_params(convert, param_specs(cfg), np_tree)
