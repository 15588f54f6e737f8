"""Family-agnostic train / prefill / decode step builders and input specs,
the port of ``repro.runtime.steps``.

The reference's train step is a pure function that ``jax.jit`` compiles;
the port's updates the params, the optimizer state and the error-feedback
residuals in place, every quantity on the device, so that a CUDA Graph
captures it whole (``runtime.trainer``).  Gradients come from
``torch.autograd.grad`` over detached aliases of the params, so the params
themselves never require grad.

``make_prefill_step`` dispatches on the family, as the reference's does:
audio takes ``frames`` and ``tokens``, vlm ``tokens`` and
``patch_embeds``, the others ``tokens``.  This is the entry point of the
audio family's prefill and of the vlm family's image prompts; ``Server``
serves token prompts only.  ``make_input_specs`` gives the batch of one
(arch, shape) cell as tensors on the ``meta`` device: shapes and types
without memory.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..configs.shapes import ShapeConfig
from ..core.session import ambient_span
from ..models.layers import map_params
from ..optim.adamw import (AdamWState, adamw_init, adamw_update_,
                           tree_leaves, tree_unflatten)
from ..optim.compression import ErrorFeedbackState, ef_compress_update_
from ..optim.schedule import cosine_schedule

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "make_input_specs", "grads_of", "init_all"]

Params = Any
Batch = Dict[str, torch.Tensor]


def grads_of(model: Any, params: Params, batch: Batch
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Params]:
    """(loss, metrics, grads) of ``model.loss`` at ``params``; the grads
    are a tree like ``params``, each leaf in its param's type."""
    work = map_params(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = model.loss(work, batch)
        grads = torch.autograd.grad(loss, tree_leaves(work))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, list(grads)))


def make_train_step(model: Any, cfg: ModelConfig, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10000,
                    grad_compression: Optional[str] = None) -> Callable:
    """``train_step(params, opt_state, batch, ef_state=None)``: one step in
    place, returning ``(params, opt_state, metrics)`` (and ``ef_state``
    when given), the same objects it was given.

    ``cfg.microbatch`` M > 1 splits the batch into M sequential
    microbatches whose grads accumulate in fp32 (the reference's scan);
    ``grad_compression="int8"`` sends the grads through the int8 round trip
    with error feedback, only when ``ef_state`` is given.
    """
    def train_step(params: Params, opt_state: AdamWState, batch: Batch,
                   ef_state: Optional[ErrorFeedbackState] = None) -> Tuple:
        M = max(1, cfg.microbatch)
        if M > 1:
            n = next(iter(batch.values())).shape[0] // M
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in tree_leaves(params)]
            losses, metricses = [], []
            for i in range(M):
                loss, metrics, g = grads_of(
                    model, params, {k: v[i * n:(i + 1) * n]
                                    for k, v in batch.items()})
                for a, gi in zip(acc, tree_leaves(g)):
                    a.add_(gi.float())
                losses.append(loss)
                metricses.append(metrics)
            grads = tree_unflatten(params, [a / M for a in acc])
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                       for k in metricses[0]}
        else:
            loss, metrics, grads = grads_of(model, params, batch)
        if grad_compression == "int8" and ef_state is not None:
            grads = ef_compress_update_(grads, ef_state)
        lr = cosine_schedule(opt_state.step, warmup, total_steps, peak_lr)
        om = adamw_update_(grads, opt_state, params, lr)
        out_metrics = {"loss": loss, **metrics, **om}
        if ef_state is not None:
            return params, opt_state, out_metrics, ef_state
        return params, opt_state, out_metrics

    return train_step


def make_prefill_step(model: Any, cfg: ModelConfig, max_seq: int
                      ) -> Callable:
    """``prefill_step(params, batch, state=None) -> (state, logits)``: the
    family's prefill on the batch's inputs.  A given ``state`` (the model's
    ``init_decode_state``) is filled in place, so that a CUDA Graph can
    capture the step."""
    if cfg.family == "audio":
        def prefill_step(params: Params, batch: Batch, state=None) -> Tuple:
            return model.prefill(params, batch["frames"], batch["tokens"],
                                 max_seq, state=state)
    elif cfg.family == "vlm":
        def prefill_step(params: Params, batch: Batch, state=None) -> Tuple:
            return model.prefill(params, batch["tokens"], max_seq,
                                 patch_embeds=batch["patch_embeds"],
                                 state=state)
    else:
        def prefill_step(params: Params, batch: Batch, state=None) -> Tuple:
            return model.prefill(params, batch["tokens"], max_seq,
                                 state=state)
    return prefill_step


def make_decode_step(model: Any, cfg: ModelConfig) -> Callable:
    """``decode_step(params, state, tokens) -> (state, logits)``: one token
    for every sequence, the state updated in place."""
    def decode_step(params: Params, state: Dict[str, torch.Tensor],
                    tokens: torch.Tensor) -> Tuple:
        return model.decode_step(params, state, tokens)
    return decode_step


def make_input_specs(cfg: ModelConfig, shape: ShapeConfig
                     ) -> Dict[str, torch.Tensor]:
    """The batch of one (arch, shape) cell as ``meta`` tensors, with the
    reference's shapes and types: frames and patch embeddings in
    ``param_dtype``, tokens and labels int32."""
    B, S = shape.global_batch, shape.seq_len
    emb = getattr(torch, cfg.param_dtype)

    def spec(dims: Tuple[int, ...], dtype: torch.dtype = torch.int32
             ) -> torch.Tensor:
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": spec((B, 1))}
    if cfg.family == "audio":
        S_dec = max(S // cfg.enc_seq_ratio, 1)
        return {"frames": spec((B, S, cfg.d_model), emb),
                "tokens": spec((B, S_dec)), "labels": spec((B, S_dec))}
    if cfg.family == "vlm":
        S_text = S - cfg.n_patches
        out = {"tokens": spec((B, S_text)),
               "patch_embeds": spec((B, cfg.n_patches, cfg.d_model), emb)}
        if shape.kind == "train":
            out["labels"] = spec((B, S_text))
        return out
    out = {"tokens": spec((B, S))}
    if shape.kind == "train":
        out["labels"] = spec((B, S))
    return out


def init_all(model: Any, cfg: ModelConfig, seed: int = 0,
             params: Optional[Params] = None) -> Tuple[Params, AdamWState]:
    """(params, opt_state): the model's seeded init, or a copy of the given
    ``params`` on the model's device in its types (the reference's, carried
    over by ``weights.params_from_jax``)."""
    with ambient_span("steps.init_all"):
        if params is None:
            params = model.init_params(seed)
        else:
            params = map_params(lambda p: p.detach().to(model.device).clone(),
                              params)
        return params, adamw_init(params)
