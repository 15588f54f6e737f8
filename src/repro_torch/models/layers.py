"""Shared model layers: norms, rotary embeddings, MLPs, embeddings.

Plain functions on tensors; parameters are nested dicts of tensors with the
reference's structure (``repro.models.layers``).  Every norm goes through the
RMSNorm kernel's wrapper.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.rms_norm.ops import rms_norm as rms_norm_kernel

__all__ = ["Params", "Spec", "map_params", "layer_params", "init_from_specs",
           "embedding_specs", "rms_norm", "rotary", "apply_rope", "mlp",
           "embed", "unembed", "dtype_of", "silu", "softplus"]

Params = Dict[str, Any]


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# --------------------------------------------------------------------------
# parameter trees
# --------------------------------------------------------------------------
class Spec(NamedTuple):
    """One parameter leaf: its shape, its init std (0: every element is
    ``fill``) and its type (None: the model's ``param_dtype``)."""
    shape: Tuple[int, ...]
    std: float
    fill: float = 0.0
    dtype: Optional[torch.dtype] = None


def map_params(fn: Callable[..., Any], tree: Any, *others: Any) -> Any:
    """Apply ``fn`` leafwise over nested dicts of the same structure."""
    if isinstance(tree, dict):
        for o in others:
            if not isinstance(o, dict) or set(o) != set(tree):
                raise ValueError(f"param tree keys differ: {sorted(tree)} "
                                 f"vs {sorted(o) if isinstance(o, dict) else o}")
        return {k: map_params(fn, tree[k], *(o[k] for o in others))
                for k in tree}
    return fn(tree, *others)


def layer_params(layers: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the stacked [L, ...] tensors."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def init_from_specs(specs: Any, dtype: torch.dtype,
                    device: Union[str, torch.device], seed: int) -> Params:
    """Seeded random weights for a spec tree, drawn on ``device``.

    The numbers differ from the reference's ``init_params`` (another
    generator); the shapes, scales, fills and types are the same.
    """
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(spec: Spec) -> torch.Tensor:
        dt = spec.dtype or dtype
        if spec.std == 0.0:
            return torch.full(spec.shape, spec.fill, dtype=dt, device=device)
        x = torch.randn(spec.shape, generator=gen, device=device,
                        dtype=torch.float32)
        return x.mul_(spec.std).to(dt)

    return map_params(draw, specs)


def embedding_specs(cfg: ModelConfig) -> Params:
    """``repro.models.layers.init_embedding``: tied or untied."""
    V, d = cfg.vocab_padded, cfg.d_model
    emb = {"embed": Spec((V, d), d ** -0.5)}
    if not cfg.tie_embeddings:
        emb["unembed"] = Spec((d, V), d ** -0.5)
    return emb


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """fp32 mean of squares, ``(1 + scale)`` gain, cast back to x's type."""
    return rms_norm_kernel(x.contiguous(), p["scale"], eps)


# --------------------------------------------------------------------------
# activations, as the reference computes them
# --------------------------------------------------------------------------
def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s formula, ``x * (1 / (1 + exp(-x)))``, rounded to x's
    type at each step as XLA does, so bf16 results equal the reference's
    (``F.silu`` rounds once and differs in about a third of bf16 values)."""
    return x * (1 / (1 + torch.exp(-x)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


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
@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` on the host, as a Python float."""
    return torch.tensor(value, dtype=dtype).item()


def embed(p: Params, tokens: torch.Tensor, scale: bool = False
          ) -> torch.Tensor:
    x = p["embed"][tokens]
    if scale:
        # sqrt(d) rounded to the activation type, as the reference does; a
        # Python scalar, so no host->device copy (a CUDA graph can capture it)
        x = x * _rounded(x.shape[-1] ** 0.5, x.dtype)
    return x


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    if "unembed" in p:
        return x @ p["unembed"]
    return x @ p["embed"].T
