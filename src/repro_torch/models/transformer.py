"""Decoder-only transformer LM, dense path.

Parameters are a nested dict with the reference's structure
(``repro.models.transformer.TransformerLM.init_params``): per-layer tensors
are stacked on a leading L axis, and the reference's scan over layers becomes
a loop over that axis.  Families and features this slice lacks (MoE,
non-RoPE positions) raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .attention import IMPLS, attention, decode_attention, init_kv_cache
from .layers import (Params, Spec, dtype_of, embed, embedding_specs,
                     init_from_specs, layer_params, mlp, rms_norm, unembed)

__all__ = ["TransformerLM", "param_specs"]


def param_specs(cfg: ModelConfig) -> Any:
    """The param tree for ``cfg``, one :class:`Spec` a leaf.

    The structure, shapes and scales are the reference's; a std of 0 marks
    a zero-initialised norm scale (``(1 + scale)`` gain).
    """
    L, d, h, hk, hd, ff = (cfg.n_layers, cfg.d_model, cfg.n_heads_padded,
                           cfg.n_kv_heads, cfg.hd, cfg.d_ff)
    attn = {"wq": Spec((L, d, h, hd), d ** -0.5),
            "wk": Spec((L, d, hk, hd), d ** -0.5),
            "wv": Spec((L, d, hk, hd), d ** -0.5),
            "wo": Spec((L, h, hd, d), (h * hd) ** -0.5)}
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": Spec((L, hd), 0.0)}
        attn["k_norm"] = {"scale": Spec((L, hd), 0.0)}
    return {
        "emb": embedding_specs(cfg),
        "layers": {"ln1": {"scale": Spec((L, d), 0.0)}, "attn": attn,
                   "ln2": {"scale": Spec((L, d), 0.0)},
                   "mlp": {"w_gate": Spec((L, d, ff), d ** -0.5),
                           "w_up": Spec((L, d, ff), d ** -0.5),
                           "w_down": Spec((L, ff, d), ff ** -0.5)}},
        "final_norm": {"scale": Spec((d,), 0.0)},
    }


def block_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, impl: str
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One block; returns (x, k, v) with the block's cache entries."""
    a, k, v = attention(p["attn"], cfg, rms_norm(p["ln1"], x), positions,
                        impl=impl)
    x = x + a
    return x + mlp(p["mlp"], rms_norm(p["ln2"], x), cfg.act), k, v


def block_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 k_cache: torch.Tensor, v_cache: torch.Tensor,
                 length: torch.Tensor) -> torch.Tensor:
    x = x + decode_attention(p["attn"], cfg, rms_norm(p["ln1"], x),
                             k_cache, v_cache, length)
    return x + mlp(p["mlp"], rms_norm(p["ln2"], x), cfg.act)


class TransformerLM:
    """Dense decoder-only LM on one device.

    ``impl`` selects the prefill attention route (``"cuda"``: the flash
    kernel; ``"ref"``: dense softmax).  ``device`` defaults to ``cuda`` and
    raises without CUDA unless ``"cpu"`` is passed.
    """

    def __init__(self, cfg: ModelConfig, impl: str = "cuda",
                 device: Optional[Union[str, torch.device]] = None) -> None:
        if cfg.family != "dense" or cfg.n_experts:
            raise NotImplementedError(
                f"{cfg.name}: only the dense family is ported")
        if cfg.pos_embed != "rope":
            raise NotImplementedError(
                f"{cfg.name}: pos_embed={cfg.pos_embed!r} is not ported")
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
        self.cfg = cfg
        self.impl = impl
        self.device = resolve_device(device)

    # ---- params ----------------------------------------------------------
    def init_params(self, seed: int = 0) -> Params:
        """Seeded random weights, drawn on the model's device in its type."""
        return init_from_specs(param_specs(self.cfg), dtype_of(self.cfg),
                               self.device, seed)

    # ---- forward ---------------------------------------------------------
    def hidden_states(self, params: Params, tokens: torch.Tensor
                      ) -> torch.Tensor:
        """Final-normed hidden states [B, S, D] of the whole sequence."""
        cfg = self.cfg
        x = embed(params["emb"], tokens, cfg.embed_scale)
        positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
        for i in range(cfg.n_layers):
            x, _, _ = block_forward(layer_params(params["layers"], i), cfg, x,
                                    positions, self.impl)
        return rms_norm(params["final_norm"], x)

    # ---- serving ---------------------------------------------------------
    def init_decode_state(self, batch: int, max_seq: int
                          ) -> Dict[str, torch.Tensor]:
        return init_kv_cache(self.cfg, batch, max_seq, dtype_of(self.cfg),
                             self.device)

    def prefill(self, params: Params, tokens: torch.Tensor, max_seq: int,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Run the prompt, building the KV cache; returns (state, last logits).

        ``state`` (from :meth:`init_decode_state`) is filled in place and
        returned; without it a fresh one is allocated.
        """
        x = embed(params["emb"], tokens, self.cfg.embed_scale)
        return self.prefill_embeds(params, x, max_seq, state)

    def prefill_embeds(self, params: Params, x: torch.Tensor, max_seq: int,
                       state: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Prefill from embeddings [B, S, D]; the cache holds positions < S.

        A given ``state`` is zeroed and filled in place, so its addresses stay
        fixed (a CUDA graph can capture the call): the cache starts from
        zeros, as the reference's fresh cache does.
        """
        cfg = self.cfg
        B, S = x.shape[:2]
        if S > max_seq:
            raise ValueError(f"prompt length {S} exceeds max_seq={max_seq}")
        positions = torch.arange(S, device=x.device)[None, :]
        if state is None:
            state = self.init_decode_state(B, max_seq)
        else:
            want = (cfg.n_layers, B, max_seq, cfg.n_kv_heads, cfg.hd)
            if tuple(state["k"].shape) != want:
                raise ValueError(f"decode state {tuple(state['k'].shape)} does "
                                 f"not fit batch {B} and max_seq {max_seq}")
            state["k"].zero_()
            state["v"].zero_()
        for i in range(cfg.n_layers):
            x, k, v = block_forward(layer_params(params["layers"], i), cfg, x,
                                    positions, self.impl)
            state["k"][i, :, :S] = k
            state["v"][i, :, :S] = v
        x = rms_norm(params["final_norm"], x)
        logits = unembed(params["emb"], x[:, -1:, :])
        state["length"].fill_(S)
        return state, logits

    def decode_step(self, params: Params, state: Dict[str, torch.Tensor],
                    tokens: torch.Tensor
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One token for every sequence. tokens: [B, 1].

        ``state`` is updated in place (the caches at ``length``, then
        ``length + 1``) and returned.
        """
        cfg = self.cfg
        x = embed(params["emb"], tokens, cfg.embed_scale)
        length = state["length"]
        for i in range(cfg.n_layers):
            x = block_decode(layer_params(params["layers"], i), cfg, x,
                             state["k"][i], state["v"][i], length)
        x = rms_norm(params["final_norm"], x)
        logits = unembed(params["emb"], x)
        length.add_(1)
        return state, logits
