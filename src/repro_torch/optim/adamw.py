"""AdamW with bf16 params and fp32 master weights and moments, the port's
copy of ``repro.optim.adamw``.

The state mirrors the parameter tree.  :func:`adamw_update_` updates the
state and the params in place, every quantity on the device: the global
norm and its clip factor, the bias corrections from the device step
counter, and the learning rate (a 0-d tensor), so that a CUDA Graph can
capture a whole train step.  :func:`adamw_update` is the reference's
functional form, on copies.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple, Union

import torch

from ..models.layers import map_params

__all__ = ["AdamWState", "adamw_init", "adamw_update", "adamw_update_",
           "clip_by_global_norm", "global_norm", "tree_leaves",
           "tree_unflatten"]

Params = Any


class AdamWState(NamedTuple):
    """``step`` is a 0-d int32 tensor; ``master``, ``m`` and ``v`` are fp32
    trees shaped like the params.  A tuple, so that a doorbell's payload
    (``core.doorbell.payload_bytes``) counts every leaf, as the reference's
    pytree does."""

    step: torch.Tensor
    master: Params
    m: Params
    v: Params


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves of nested dicts, tuples and lists, dict keys sorted as
    ``jax.tree_util`` orders them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree: Any, leaves: List[Any]) -> Any:
    """``leaves`` (in :func:`tree_leaves`' order) in ``tree``'s structure."""
    it = iter(leaves)

    def build(t: Any) -> Any:
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            vals = [build(v) for v in t]
            return type(t)(*vals) if hasattr(t, "_fields") else type(t)(vals)
        return next(it)

    return build(tree)


def adamw_init(params: Params) -> AdamWState:
    first = tree_leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        master=map_params(lambda p: p.detach().float().clone(), params),
        m=map_params(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
        v=map_params(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params))


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares, on the device."""
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g in grads:
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    """The reference's form: clipped copies (each in its leaf's type) and
    the global norm."""
    gn = global_norm(tree_leaves(grads))
    scale = _clip_scale(gn, max_norm)
    return map_params(lambda g: (g.float() * scale).to(g.dtype), grads), gn


@torch.no_grad()
def adamw_update_(grads: Params, state: AdamWState, params: Params,
                  lr: Union[float, torch.Tensor], b1: float = 0.9,
                  b2: float = 0.95, eps: float = 1e-8,
                  weight_decay: float = 0.1, max_grad_norm: float = 1.0
                  ) -> Dict[str, torch.Tensor]:
    """One AdamW step in place on ``state`` and ``params``; returns the
    metrics ``{"grad_norm", "lr"}``.

    The reference's formula (``repro.optim.adamw.adamw_update``): grads
    clipped by their global norm (each cast back to its type), fp32 moments,
    bias corrections ``1 - b**step`` at the incremented step, decoupled
    weight decay on the master weights, the params cast from the master.
    One leaf at a time, so the fp32 temporaries are one leaf's.
    """
    gs, ms, vs = (tree_leaves(grads), tree_leaves(state.m),
                  tree_leaves(state.v))
    masters, ps = tree_leaves(state.master), tree_leaves(params)
    gn = global_norm(gs)
    scale = _clip_scale(gn, max_grad_norm)
    state.step.add_(1)
    stepf = state.step.float()
    c1 = 1.0 - torch.pow(b1, stepf)
    c2 = 1.0 - torch.pow(b2, stepf)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=stepf.device)
    for g, m, v, master, p in zip(gs, ms, vs, masters, ps):
        g = (g.float() * scale).to(g.dtype).float()
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (m / c1).div_(torch.sqrt(v / c2).add_(eps))
        master.sub_(upd.add_(master, alpha=weight_decay).mul_(lr))
        p.copy_(master)
    return {"grad_norm": gn, "lr": lr}


def adamw_update(grads: Params, state: AdamWState, params: Params,
                 lr: Union[float, torch.Tensor], **kw: Any
                 ) -> Tuple[Params, AdamWState, Dict[str, torch.Tensor]]:
    """The reference's functional form: new params and state (copies), and
    the metrics; the inputs are left as they were."""
    new_params = map_params(lambda p: p.detach().clone(), params)
    new_state = AdamWState(*(map_params(torch.clone, s) for s in state))
    metrics = adamw_update_(grads, new_state, new_params, lr, **kw)
    return new_params, new_state, metrics
