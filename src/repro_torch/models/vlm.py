"""LLaVA-style VLM backbone, the port of ``repro.models.vlm``.

The vision tower is a stub, as in the reference: the input is precomputed
anyres patch embeddings [B, n_patches, d_model] (what the CLIP tower and
projector would emit).  The backbone is the dense decoder-only
:class:`~.transformer.TransformerLM`; patch embeddings are prepended to the
text embeddings, and the loss covers the text positions only.  Without
patches every serving entry point (``prefill``, ``prefill_extend``,
``decode_step``, the continuous engine's slots) is the text model's, so
``Server`` and ``ContinuousBatchingServer`` serve it text-only, as the
reference's do.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .layers import (Params, cross_entropy_loss, embed, layer_loop,
                     layer_params, plain_rms_norm)
from .transformer import (TransformerLM, _train_route, block_forward,
                          train_layers)

__all__ = ["VlmLM"]

State = Dict[str, torch.Tensor]


class VlmLM(TransformerLM):
    """TransformerLM with injected patch embeddings."""

    FAMILIES = ("vlm",)

    def _inject(self, params: Params, tokens: torch.Tensor,
                patches: torch.Tensor) -> torch.Tensor:
        """[patches cast to the text's type, text embeddings] on the
        sequence axis: [B, n_patches + S_text, D]."""
        text = embed(params["emb"], tokens, self.cfg.embed_scale)
        return torch.cat([patches.to(text.dtype), text], dim=1)

    def _forward_embeds(self, params: Params, x: torch.Tensor, mode: str
                        ) -> torch.Tensor:
        """The layers over embeddings [B, S, D] and the final norm;
        ``mode="train"`` is the train path (plain norms, ``impl="ref"``,
        per-layer checkpoint when ``cfg.remat``)."""
        cfg = self.cfg
        x = self.constraint(x)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        if mode == "train":
            _train_route(self)

            def block(lp: Params, y: torch.Tensor):
                return self.constraint(block_forward(
                    lp, cfg, y, positions, self.impl, plain_rms_norm)[0]), None

            x, _ = train_layers(params["layers"], x, cfg.remat, block)
            return plain_rms_norm(params["final_norm"], x)
        for i in layer_loop(cfg.n_layers, lambda: x):
            x = self.constraint(block_forward(
                layer_params(params["layers"], i), cfg, x, positions,
                self.impl, self.norm)[0])
        return self.norm(params["final_norm"], x)

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token cross entropy over the text positions of
        ``batch`` (``tokens``, ``labels`` [B, S_text], ``patch_embeds`` [B,
        n_patches, D])."""
        cfg = self.cfg
        x = self._inject(params, batch["tokens"], batch["patch_embeds"])
        x = self._forward_embeds(params, x, mode="train")
        n_p = batch["patch_embeds"].shape[1]
        ce = cross_entropy_loss(params["emb"], x[:, n_p:], batch["labels"],
                                cfg.loss_chunk, vocab_valid=cfg.vocab_size)
        return ce, {"ce": ce}

    def prefill(self, params: Params, tokens: torch.Tensor, max_seq: int,
                patch_embeds: Optional[torch.Tensor] = None,
                state: Optional[State] = None) -> Tuple[State, torch.Tensor]:
        """Without patches the text model's prefill; with them the prompt is
        the ``n_patches + S_text`` injected positions, and the KV cache
        holds them all."""
        if patch_embeds is None:
            return super().prefill(params, tokens, max_seq, state=state)
        x = self._inject(params, tokens, patch_embeds)
        return self.prefill_embeds(params, x, max_seq, state)
