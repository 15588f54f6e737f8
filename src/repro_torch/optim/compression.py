"""int8 gradient compression with error feedback, the port's copy of
``repro.optim.compression``.

Block quantization: each leaf flattened, zero-padded to a multiple of
``BLOCK`` values, one fp32 scale a block (its max |x| / 127, at least
1e-12), values rounded half to even (``torch.round``, as ``jnp.round``)
and clipped to ±127.  :func:`ef_compress_update_` carries the
quantization error to the next step in place, for a captured train step.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..models.layers import map_params
from .adamw import tree_leaves, tree_unflatten

__all__ = ["BLOCK", "compress_int8", "decompress_int8", "ErrorFeedbackState",
           "ef_init", "ef_compress_update", "ef_compress_update_"]

Params = Any
BLOCK = 256


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-quantize to (int8 [N/B, B], fp32 scales [N/B])."""
    flat = x.float().reshape(-1)
    blocks = F.pad(flat, (0, (-flat.numel()) % BLOCK)).reshape(-1, BLOCK)
    scale = torch.clamp(blocks.abs().amax(dim=-1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(tuple(shape)).to(dtype)


class ErrorFeedbackState(NamedTuple):
    residual: Params


def ef_init(params: Params) -> ErrorFeedbackState:
    return ErrorFeedbackState(residual=map_params(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _one(g: torch.Tensor, r: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    target = g.float() + r
    q, s = compress_int8(target)
    restored = decompress_int8(q, s, g.shape, torch.float32)
    return restored.to(g.dtype), target - restored


@torch.no_grad()
def ef_compress_update_(grads: Params, ef: ErrorFeedbackState) -> Params:
    """Each grad leaf through an int8 round trip with error feedback: the
    restored grads (new tensors, each in its grad's type) are returned and
    ``ef``'s residuals updated in place."""
    restored = []
    for g, r in zip(tree_leaves(grads), tree_leaves(ef.residual)):
        new, err = _one(g, r)
        r.copy_(err)
        restored.append(new)
    return tree_unflatten(grads, restored)


def ef_compress_update(grads: Params, ef: ErrorFeedbackState
                       ) -> Tuple[Params, ErrorFeedbackState]:
    """The reference's functional form: restored grads and a new state."""
    new = ErrorFeedbackState(map_params(lambda r: r.clone(), ef.residual))
    return ef_compress_update_(grads, new), new
