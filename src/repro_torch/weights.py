"""Carry the JAX reference's parameters over to the port.

``params_from_jax`` takes the reference's param pytree (``init_params`` of
``repro.models.transformer.TransformerLM`` or ``repro.models.ssm.MambaLM``,
per-layer leaves stacked on a leading L axis, or of
``repro.distributed.pp_decode.PPDecoder``, per-layer leaves stacked as
[n_stages, layers_per_stage, ...] beside a bool ``valid`` leaf) as numpy
arrays — bf16 leaves as ``ml_dtypes`` arrays or as float32 — and returns the
port's param tree on ``device``.  The structure and every leaf's shape are
checked against the port's own :func:`~repro_torch.models.param_specs` for
the config's family (or :func:`~repro_torch.distributed.pp_decode.
pp_param_specs` for a PP tree), and every leaf takes its spec's type.

``opt_state_from_jax`` and ``ef_state_from_jax`` carry over the
reference's optimizer state (``repro.optim.adamw.AdamWState``: step, fp32
master weights and moments) and error-feedback residuals
(``repro.optim.compression.ErrorFeedbackState``), so a port trainer can
start from a reference trainer's mid-run state.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from .configs.base import ModelConfig
from .device import resolve_device
from .models import param_specs
from .models.layers import Params, Spec, dtype_of, map_params
from .optim.adamw import AdamWState
from .optim.compression import ErrorFeedbackState

__all__ = ["params_from_jax", "opt_state_from_jax", "ef_state_from_jax"]


def params_from_jax(np_tree: Any, cfg: ModelConfig,
                    device: Optional[Union[str, torch.device]] = None,
                    dtype: Optional[torch.dtype] = None) -> Params:
    """Numpy param tree -> torch param tree.

    A leaf whose spec fixes a type (Mamba's fp32 ``A_log``, ``D`` and
    ``dt_bias``; a PP tree's bool ``valid``) keeps it; every other leaf
    takes ``dtype`` (default: the config's).
    """
    dev = resolve_device(device)
    dtype = dtype_of(cfg) if dtype is None else dtype
    if isinstance(np_tree, dict) and "valid" in np_tree:
        from .distributed.pp_decode import pp_param_specs
        specs = pp_param_specs(cfg, *np.asarray(np_tree["valid"]).shape)
    else:
        specs = param_specs(cfg)

    def convert(spec: Spec, leaf: Any) -> torch.Tensor:
        a = np.asarray(leaf)
        if a.shape != spec.shape:
            raise ValueError(f"param shape {a.shape} != expected {spec.shape}")
        # bf16 (ml_dtypes) widens to float32 exactly; torch casts back
        return torch.from_numpy(a.astype(np.float32)).to(
            device=dev, dtype=spec.dtype or dtype)

    return map_params(convert, specs, np_tree)


def opt_state_from_jax(step: Any, master: Any, m: Any, v: Any,
                       cfg: ModelConfig,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> AdamWState:
    """The reference's AdamW state (its four fields as numpy) -> the port's:
    the step an int32 0-d tensor, the three trees fp32."""
    dev = resolve_device(device)
    f32 = torch.float32
    return AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=dev),
        master=params_from_jax(master, cfg, dev, f32),
        m=params_from_jax(m, cfg, dev, f32),
        v=params_from_jax(v, cfg, dev, f32))


def ef_state_from_jax(residual: Any, cfg: ModelConfig,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> ErrorFeedbackState:
    """The reference's error-feedback residuals (numpy) -> the port's."""
    return ErrorFeedbackState(params_from_jax(residual, cfg, device,
                                              torch.float32))
