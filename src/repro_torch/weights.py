"""Carry the JAX reference's parameters over to the port.

``params_from_jax`` takes the reference's param pytree (``init_params`` of
``repro.models.transformer.TransformerLM`` or ``repro.models.ssm.MambaLM``,
per-layer leaves stacked on a leading L axis) as numpy arrays — bf16 leaves
as ``ml_dtypes`` arrays or as float32 — and returns the port's param tree on
``device``.  The structure and every leaf's shape are checked against the
port's own :func:`~repro_torch.models.param_specs` for the config's family,
and every leaf takes its spec's type.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from .configs.base import ModelConfig
from .device import resolve_device
from .models import param_specs
from .models.layers import Params, Spec, dtype_of, map_params

__all__ = ["params_from_jax"]


def params_from_jax(np_tree: Any, cfg: ModelConfig,
                    device: Optional[Union[str, torch.device]] = None,
                    dtype: Optional[torch.dtype] = None) -> Params:
    """Numpy param tree -> torch param tree.

    A leaf whose spec fixes a type (Mamba's fp32 ``A_log``, ``D`` and
    ``dt_bias``) keeps it; every other leaf takes ``dtype`` (default: the
    config's).
    """
    dev = resolve_device(device)
    dtype = dtype_of(cfg) if dtype is None else dtype

    def convert(spec: Spec, leaf: Any) -> torch.Tensor:
        a = np.asarray(leaf)
        if a.shape != spec.shape:
            raise ValueError(f"param shape {a.shape} != expected {spec.shape}")
        # bf16 (ml_dtypes) widens to float32 exactly; torch casts back
        return torch.from_numpy(a.astype(np.float32)).to(
            device=dev, dtype=spec.dtype or dtype)

    return map_params(convert, param_specs(cfg), np_tree)
