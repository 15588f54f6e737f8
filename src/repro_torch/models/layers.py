"""Shared model layers: norms, rotary embeddings, MLPs, embeddings, the
chunked cross-entropy loss.

Plain functions on tensors; parameters are nested dicts of tensors with the
reference's structure (``repro.models.layers``).  Outside the train path a
model's norm is :func:`norm_of` its route: the RMSNorm kernel's wrapper on
the kernel route, :func:`plain_rms_norm` on the plain one.  The train path,
which differentiates through its norms, takes :func:`plain_rms_norm` (the
kernels have no backward, and the reference trains on its plain route).
"""
from __future__ import annotations

import functools
import math
from typing import (Any, Callable, Dict, List, NamedTuple, Optional, Tuple,
                    Union)

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.rms_norm.ops import rms_norm as rms_norm_kernel
from ..kernels.rms_norm.ref import rms_norm_ref

__all__ = ["Params", "Spec", "map_params", "layer_params", "unbind_layers",
           "init_from_specs", "embedding_specs", "rms_norm", "plain_rms_norm",
           "norm_of",
           "Norm", "rotary", "apply_rope", "sinusoidal_positions", "mlp",
           "embed", "unembed", "cross_entropy_loss", "greedy", "dtype_of",
           "silu", "softplus", "promoted"]

Params = Dict[str, Any]


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def promoted(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``ts`` in their common type, as ``jnp`` promotes the operands of a
    product: bf16 weights meet fp32 activations (whisper's fp32 frames in
    training) in fp32.  Torch's products raise on mixed types instead.
    Tensors already of that type are returned as they are (no op runs)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t if t.dtype == dt else t.to(dt) for t in ts)


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


def unbind_layers(layers: Params) -> List[Params]:
    """Every layer's parameters, one ``torch.unbind`` per stacked leaf.

    Under autograd the backward of one ``unbind`` is one ``stack`` of the
    layers' gradients: each stacked leaf gets its gradient in a single
    write, where ``L`` selects (:func:`layer_params`) would each add into a
    full ``[L, ...]`` zero gradient."""
    views = map_params(lambda t: torch.unbind(t, 0), layers)
    leaf = views
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return [map_params(lambda v: v[i], views) for i in range(len(leaf))]


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
    """fp32 mean of squares, ``(1 + scale)`` gain, cast back to x's type.

    The kernel takes one type: a bf16 scale meets fp32 activations cast up
    (exactly, as the reference's fp32 gain is)."""
    scale = p["scale"]
    if scale.dtype != x.dtype and x.dtype == torch.float32:
        scale = scale.to(x.dtype)
    return rms_norm_kernel(x.contiguous(), scale, eps)


def plain_rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6
                   ) -> torch.Tensor:
    """:func:`rms_norm` in plain torch ops on every device: the train
    path's norm, which autograd differentiates."""
    return rms_norm_ref(x, p["scale"], eps)


#: a norm function: :func:`rms_norm` (serving) or :func:`plain_rms_norm`
Norm = Callable[[Params, torch.Tensor], torch.Tensor]


def norm_of(impl: str) -> Norm:
    """A model's norm outside the train path: the RMSNorm kernel on the
    kernel route (``impl="cuda"``), plain torch ops on the plain route."""
    return rms_norm if impl == "cuda" else plain_rms_norm


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


def sinusoidal_positions(n: int, d: int,
                         device: Optional[Union[str, torch.device]] = None
                         ) -> torch.Tensor:
    """Whisper-style sinusoidal table [n, d] (fp32): sines of the first
    half, cosines of the second, frequencies ``10000^(-i / (half - 1))``."""
    half = d // 2
    f32 = torch.float32
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=f32, device=device)
                      / (half - 1))
    ang = torch.arange(n, dtype=f32, device=device)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# --------------------------------------------------------------------------
def mlp(p: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    x, wg, wu, wd = promoted(x, p["w_gate"], p["w_up"], p["w_down"])
    g = x @ wg
    u = x @ wu
    # jax.nn.gelu defaults to the tanh approximation
    g = F.gelu(g, approximate="tanh") if act == "gelu" else F.silu(g)
    return (g * u) @ wd


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
    x, w = promoted(x, p["unembed"] if "unembed" in p else p["embed"].T)
    return x @ w


# --------------------------------------------------------------------------
# chunked cross-entropy loss (never materializes [B, S, V] at once)
# --------------------------------------------------------------------------
def cross_entropy_loss(emb_params: Params, x: torch.Tensor,
                       labels: torch.Tensor, chunk: int = 512,
                       vocab_valid: Optional[int] = None) -> torch.Tensor:
    """Mean CE over [B, S] labels given final hidden states x: [B, S, D].

    ``repro.models.layers.cross_entropy_loss``: a loop over sequence chunks
    of ``chunk`` positions and a remainder chunk, so the fp32 logits of one
    chunk, [B, chunk, V], are the largest live buffer; padded vocab columns
    (>= ``vocab_valid``) are masked with the fp32 minimum.
    """
    B, S, _ = x.shape
    chunk = min(chunk, S)
    n_chunks = S // chunk
    bounds = [(i * chunk, (i + 1) * chunk) for i in range(n_chunks)]
    if S > n_chunks * chunk:
        bounds.append((n_chunks * chunk, S))
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for a, b in bounds:
        logits = unembed(emb_params, x[:, a:b]).float()
        V = logits.shape[-1]
        if vocab_valid is not None and vocab_valid < V:
            mask = torch.arange(V, device=x.device) >= vocab_valid
            logits = logits.masked_fill(mask, torch.finfo(torch.float32).min)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, a:b, None].long())[..., 0]
        total = total + torch.sum(lse - gold)
    return total / (B * S)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """[B, S, V] logits -> [B, 1] int32 argmax of the last position."""
    return torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
