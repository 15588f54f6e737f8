"""Shared model layers: norms, rotary embeddings, MLPs, embeddings.

Plain functions on tensors; parameters are nested dicts of tensors with the
reference's structure (``repro.models.layers``).  Every norm goes through the
RMSNorm kernel's wrapper.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.rms_norm.ops import rms_norm as rms_norm_kernel

__all__ = ["Params", "rms_norm", "rotary", "apply_rope", "mlp", "embed",
           "unembed", "dtype_of"]

Params = Dict[str, Any]


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """fp32 mean of squares, ``(1 + scale)`` gain, cast back to x's type."""
    return rms_norm_kernel(x.contiguous(), p["scale"], eps)


# --------------------------------------------------------------------------
# rotary position embedding (NeoX half-split convention)
# --------------------------------------------------------------------------
def rotary(positions: torch.Tensor, head_dim: int, theta: float = 10000.0
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) of shape [..., head_dim/2] for integer positions, fp32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """x: [..., S, H, hd]; sin/cos: [..., S, hd/2]; fp32 math, x's type out."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin_b = sin[..., None, :]
    cos_b = cos[..., None, :]
    out = torch.cat([x1 * cos_b - x2 * sin_b, x2 * cos_b + x1 * sin_b], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# --------------------------------------------------------------------------
def mlp(p: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    # jax.nn.gelu defaults to the tanh approximation
    g = F.gelu(g, approximate="tanh") if act == "gelu" else F.silu(g)
    return (g * u) @ p["w_down"]


# --------------------------------------------------------------------------
# embeddings / unembedding
# --------------------------------------------------------------------------
def embed(p: Params, tokens: torch.Tensor, scale: bool = False
          ) -> torch.Tensor:
    x = p["embed"][tokens]
    if scale:
        # sqrt(d) rounded to the activation type, as the reference does
        x = x * torch.tensor(x.shape[-1] ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    if "unembed" in p:
        return x @ p["unembed"]
    return x @ p["embed"].T
