"""Decoder-only transformer LM, dense path.

Parameters are a nested dict with the reference's structure
(``repro.models.transformer.TransformerLM.init_params``): per-layer tensors
are stacked on a leading L axis, and the reference's scan over layers becomes
a loop over that axis.  Families and features this slice lacks (MoE,
non-RoPE positions) raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .attention import IMPLS, attention, decode_attention, init_kv_cache
from .layers import Params, dtype_of, embed, mlp, rms_norm, unembed

__all__ = ["TransformerLM", "layer_params", "param_specs", "map_params"]


def param_specs(cfg: ModelConfig) -> Any:
    """The param tree for ``cfg``: each leaf is ``(shape, init std)``.

    The structure, shapes and scales are the reference's; a std of 0 marks
    a zero-initialised norm scale (``(1 + scale)`` gain).
    """
    L, d, h, hk, hd, ff, V = (cfg.n_layers, cfg.d_model, cfg.n_heads_padded,
                              cfg.n_kv_heads, cfg.hd, cfg.d_ff,
                              cfg.vocab_padded)
    attn = {"wq": ((L, d, h, hd), d ** -0.5), "wk": ((L, d, hk, hd), d ** -0.5),
            "wv": ((L, d, hk, hd), d ** -0.5),
            "wo": ((L, h, hd, d), (h * hd) ** -0.5)}
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": ((L, hd), 0.0)}
        attn["k_norm"] = {"scale": ((L, hd), 0.0)}
    emb = {"embed": ((V, d), d ** -0.5)}
    if not cfg.tie_embeddings:
        emb["unembed"] = ((d, V), d ** -0.5)
    return {
        "emb": emb,
        "layers": {"ln1": {"scale": ((L, d), 0.0)}, "attn": attn,
                   "ln2": {"scale": ((L, d), 0.0)},
                   "mlp": {"w_gate": ((L, d, ff), d ** -0.5),
                           "w_up": ((L, d, ff), d ** -0.5),
                           "w_down": ((L, ff, d), ff ** -0.5)}},
        "final_norm": {"scale": ((d,), 0.0)},
    }


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
        """Seeded random weights, drawn on the model's device in its type.

        The numbers differ from the reference's ``init_params`` (another
        generator); the shapes and scales are the same.
        """
        dtype = dtype_of(self.cfg)
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def draw(spec):
            shape, std = spec
            if std == 0.0:
                return torch.zeros(shape, dtype=dtype, device=self.device)
            x = torch.randn(shape, generator=gen, device=self.device,
                            dtype=torch.float32)
            return x.mul_(std).to(dtype)

        return map_params(draw, param_specs(self.cfg))

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

    def prefill(self, params: Params, tokens: torch.Tensor, max_seq: int
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Run the prompt, building the KV cache; returns (state, last logits)."""
        x = embed(params["emb"], tokens, self.cfg.embed_scale)
        return self.prefill_embeds(params, x, max_seq)

    def prefill_embeds(self, params: Params, x: torch.Tensor, max_seq: int
                       ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Prefill from embeddings [B, S, D]; the cache holds positions < S."""
        cfg = self.cfg
        B, S = x.shape[:2]
        if S > max_seq:
            raise ValueError(f"prompt length {S} exceeds max_seq={max_seq}")
        positions = torch.arange(S, device=x.device)[None, :]
        state = self.init_decode_state(B, max_seq)
        for i in range(cfg.n_layers):
            x, k, v = block_forward(layer_params(params["layers"], i), cfg, x,
                                    positions, self.impl)
            state["k"][i, :, :S] = k
            state["v"][i, :, :S] = v
        x = rms_norm(params["final_norm"], x)
        logits = unembed(params["emb"], x[:, -1:, :])
        state["length"] = torch.tensor(S, dtype=torch.int32, device=x.device)
        return state, logits

    def decode_step(self, params: Params, state: Dict[str, torch.Tensor],
                    tokens: torch.Tensor
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One token for every sequence. tokens: [B, 1].

        The caches in ``state`` are updated in place; the returned state
        shares them and carries ``length + 1``.
        """
        cfg = self.cfg
        x = embed(params["emb"], tokens, cfg.embed_scale)
        length = state["length"]
        for i in range(cfg.n_layers):
            x = block_decode(layer_params(params["layers"], i), cfg, x,
                             state["k"][i], state["v"][i], length)
        x = rms_norm(params["final_norm"], x)
        logits = unembed(params["emb"], x)
        return {"k": state["k"], "v": state["v"], "length": length + 1}, logits
