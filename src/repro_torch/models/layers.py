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
from typing import (Any, Callable, Dict, Iterable, Iterator, List,
                    NamedTuple, Optional, Sequence, Tuple, Union)

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.stream import mark, restamp, set_multiplier, weighted_stacks
from ..kernels.rms_norm.ops import rms_norm as rms_norm_kernel
from ..kernels.rms_norm.ref import rms_norm_ref

__all__ = ["Params", "Spec", "map_params", "layer_params", "unbind_layers",
           "layer_loop", "weighted_layers",
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


# --------------------------------------------------------------------------
# layer stacks: every layer, or weighted bodies (the dry-run)
# --------------------------------------------------------------------------
def _layout(t: Any) -> Any:
    """What decides the program a layer runs on its input: the DTensor
    placements and the shape (a plain tensor: its shape)."""
    return (tuple(getattr(t, "placements", ())), tuple(t.shape))


class layer_loop:
    """The indices of a loop over a stack of ``n`` layers whose carry
    ``carry()`` reads (a closure over the loop's variable):

        layers = layer_loop(n, lambda: x)
        for i in layers:
            x = block(layer_params(params, i), x)

    It yields every index, except while the dry-run records weighted stacks
    (``core.stream.weighted_stacks``).  Then it stops at the first layer
    whose output is laid out as its input was (the same DTensor placements
    and shape): every later layer would run the same program, so that
    layer's entries are stamped with the number of layers left, as the
    reference's scan body counts at its trip count.  DTensor places each
    result by its own cost model, so the first layer or two (on the
    embedding's output) can run programs of their own; those are recorded
    once each.  ``weights`` lists, for each index yielded, the layers it
    stands for, and :meth:`per_layer` repeats a per-layer value by them."""

    def __init__(self, n: int, carry: Callable[[], Any]) -> None:
        self.n = n
        self.carry = carry
        self.weights: List[int] = []

    def __iter__(self) -> Iterator[int]:
        if not weighted_stacks.active():
            self.weights = [1] * self.n
            yield from range(self.n)
            return
        for i in range(self.n):
            before, at = _layout(self.carry()), mark()
            self.weights.append(1)
            yield i
            if i + 1 < self.n and _layout(self.carry()) == before:
                self.weights[-1] = self.n - i
                restamp(at, self.n - i)
                return

    def per_layer(self, values: List[Any]) -> List[Any]:
        """``values`` (one a yielded index), each repeated by the layers
        its index stands for: one a layer of the stack."""
        return [v for v, m in zip(values, self.weights) for _ in range(m)]


class _LayerViews(torch.autograd.Function):
    """Every layer of one stacked leaf, as views (the loop uses those it
    runs).  The backward assembles the leaf's gradient as ``unbind``'s
    does, one ``stack`` of the ``n`` layers' gradients: a layer that did
    not run takes the gradient of the body that stands for it
    (``plan``: the (index, layers) of each body, filled as the forward
    runs)."""

    @staticmethod
    def forward(ctx: Any, t: torch.Tensor, plan: List[Tuple[int, int]]
                ) -> Tuple[torch.Tensor, ...]:
        ctx.plan = plan
        ctx.set_materialize_grads(False)     # no zeros for the layers not run
        return tuple(torch.unbind(t, 0))

    @staticmethod
    def backward(ctx: Any, *grads: torch.Tensor) -> Any:
        parts = [grads[i] for i, m in ctx.plan for _ in range(m)]
        return torch.stack(parts), None


class _BodyEnter(torch.autograd.Function):
    """The identity on a body's inputs: its input activations, the inputs
    every layer shares and its layer's params.  Its backward runs once the
    body's backward has run.  There autograd would add the ``m`` layers'
    gradients of each shared input into one, ``m - 1`` additions where the
    body gives one gradient: they are recorded here, one addition at weight
    ``m - 1``, as the engine makes it (out of place on a tensor subclass).
    Then it sets the recorder's multiplier back to what it was outside.
    ``box`` holds the body's layers (``m``), known once the body has run,
    and that multiplier (``outer``), which :class:`_BodyExit`'s backward
    replaced."""

    @staticmethod
    def forward(ctx: Any, box: Dict[str, int], n_shared: int,
                *ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        ctx.box, ctx.n_shared = box, n_shared
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx: Any, *grads: torch.Tensor) -> Any:
        m = ctx.box["m"]
        if m > 1:
            set_multiplier(m - 1)
            for g in grads[:ctx.n_shared]:
                if g is not None:
                    g + g
        set_multiplier(ctx.box["outer"])
        return (None, None) + grads


class _BodyExit(torch.autograd.Function):
    """The identity on a body's output, and its aux loss (if any) given
    once for each of the ``m`` layers the body stands for.  The backward,
    which runs before the body's, stamps ``m`` on what the body's backward
    records (a recompute under activation checkpointing included), and
    keeps the multiplier it replaces in ``box`` for :class:`_BodyEnter`."""

    @staticmethod
    def forward(ctx: Any, box: Dict[str, int], m: int, x: torch.Tensor,
                aux: Optional[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        ctx.box, ctx.m = box, m
        ctx.has_aux = aux is not None
        extra = (tuple(aux.view_as(aux) for _ in range(m))
                 if ctx.has_aux else ())
        return (x.view_as(x),) + extra

    @staticmethod
    def backward(ctx: Any, gx: torch.Tensor, *gaux: torch.Tensor) -> Any:
        ctx.box["outer"] = set_multiplier(ctx.m)
        return None, None, gx, (gaux[0] if ctx.has_aux else None)


def weighted_layers(layers: Params, x: torch.Tensor,
                    run: Callable[..., Tuple[torch.Tensor,
                                             Optional[torch.Tensor]]],
                    shared: Sequence[torch.Tensor] = ()
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The train path's loop over a stack under weighted recording:
    ``run(layer_params, x, *shared) -> (x, aux)`` layer by layer until a
    layer's output is laid out as its input was (:class:`layer_loop`);
    that body's forward and backward are stamped with the layers left, and
    every stacked leaf's gradient is assembled from ``n`` layer gradients.
    Returns x and one aux loss a layer (none where ``aux`` is None)."""
    paths: List[Tuple[str, ...]] = []
    leaves: List[torch.Tensor] = []

    def flat(t: Any, path: Tuple[str, ...]) -> None:
        if isinstance(t, dict):
            for k, v in t.items():
                flat(v, path + (k,))
        else:
            paths.append(path)
            leaves.append(t)

    flat(layers, ())
    n = leaves[0].shape[0]
    plan: List[Tuple[int, int]] = []
    views = [_LayerViews.apply(t, plan) for t in leaves]
    auxs: List[torch.Tensor] = []
    for i in range(n):
        # the input's need for a gradient decides the backward's program
        grad_x = x.requires_grad
        before, at = (_layout(x), grad_x), mark()
        box = {"outer": 1, "m": 1}
        outs = list(_BodyEnter.apply(box, len(shared), *shared,
                                     *([x] if grad_x else []),
                                     *[v[i] for v in views]))
        sh, outs = outs[:len(shared)], outs[len(shared):]
        if grad_x:
            x = outs.pop(0)
        lp: Params = {}
        for path, t in zip(paths, outs):
            node = lp
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t
        x, aux = run(lp, x, *sh)
        m = (n - i if i + 1 < n and (_layout(x), x.requires_grad) == before
             else 1)
        restamp(at, m)
        box["m"] = m
        plan.append((i, m))
        got = _BodyExit.apply(box, m, x, aux)
        x = got[0]
        auxs.extend(got[1:])
        if m > 1:
            break
    return x, auxs


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
