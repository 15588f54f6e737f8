"""Whisper-style encoder-decoder backbone, the port of
``repro.models.encdec``.

The conv audio frontend is a stub, as in the reference: the input is
precomputed frame embeddings [B, S_enc, d_model] (what the two conv layers
would emit).  Encoder: non-causal self-attention, sinusoidal positions.
Decoder: causal self-attention, then cross-attention whose K/V are the
encoder's output through the layer's ``xattn`` projections
(``attention(kv_override=...)``: on the kernel route the flash kernel with
K/V of the encoder's length), learned positions.

Decode serves one token against a self-attention KV cache of ``max_seq``
and a fixed-length cross-attention KV (``CROSS_LEN`` = 1500, Whisper's 30 s
encoder output).  As in the reference, :meth:`EncDecLM.prefill` fills
neither cache (``repro/models/encdec.py:148-151``): the decode attends over
zero keys, and its cross-attention adds exactly zero.  This is kept on
purpose, so that the port computes the reference's function.

Mixed types: the train batch's frames are fp32 (``data/pipeline.py``), so
the reference's encoder runs in fp32 on bf16 weights (``jnp`` promotes the
products), and the first cross-attention lifts the decoder's residual
stream to fp32.  The shared layers promote their operands the same way
(``layers.promoted``).  Serving batches carry frames in the weights' type.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .attention import (IMPLS, attention, decode_attention, decode_positions,
                        init_kv_cache)
from .layers import (Norm, Params, Spec, cross_entropy_loss, dtype_of, embed,
                     embedding_specs, init_from_specs, layer_loop,
                     layer_params, mlp,
                     norm_of, plain_rms_norm, promoted, sinusoidal_positions,
                     unembed)
from .transformer import (_train_route, attention_specs, mlp_specs,
                          train_layers)

__all__ = ["EncDecLM", "CROSS_LEN", "param_specs"]

CROSS_LEN = 1500  # whisper encoder output length (30 s of audio)

State = Dict[str, torch.Tensor]


def _norm_spec(L: int, d: int) -> Params:
    return {"scale": Spec((L, d), 0.0)}


def param_specs(cfg: ModelConfig) -> Any:
    """The reference's ``EncDecLM.init_params`` tree: the embedding, the
    decoder's learned positions [max_position, D], the encoder's blocks
    stacked on [n_enc_layers] and the decoder's (with ``ln_x`` and the
    cross-attention ``xattn``) on [n_layers], and two final norms."""
    Le, L, d = cfg.n_enc_layers, cfg.n_layers, cfg.d_model
    return {
        "emb": embedding_specs(cfg),
        "pos_dec": Spec((cfg.max_position, d), 0.01),
        "encoder": {"ln1": _norm_spec(Le, d), "attn": attention_specs(cfg, Le),
                    "ln2": _norm_spec(Le, d), "mlp": mlp_specs(cfg, Le)},
        "decoder": {"ln1": _norm_spec(L, d), "attn": attention_specs(cfg, L),
                    "ln_x": _norm_spec(L, d), "xattn": attention_specs(cfg, L),
                    "ln2": _norm_spec(L, d), "mlp": mlp_specs(cfg, L)},
        "enc_norm": {"scale": Spec((d,), 0.0)},
        "final_norm": {"scale": Spec((d,), 0.0)},
    }


class EncDecLM:
    """Whisper-style encoder-decoder on one device.

    ``impl`` selects the attention route of the full-sequence passes and
    the norms outside the train path (``"cuda"``: the flash and RMSNorm
    kernels; ``"ref"``: dense softmax and plain norms); ``device`` defaults
    to ``cuda``.
    """

    def __init__(self, cfg: ModelConfig, impl: str = "cuda",
                 device: Optional[Union[str, torch.device]] = None) -> None:
        if not cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name}: EncDecLM needs an encoder-decoder "
                             f"config")
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
        self.cfg = cfg
        self.impl = impl
        self.norm = norm_of(impl)
        self.device = resolve_device(device)
        # the residual stream's sharding constraint, applied where the
        # reference applies it (entering the layer stack and after each
        # layer); the identity unless a launcher sets it (the dry-run's
        # sequence parallelism)
        self.constraint: Callable[[torch.Tensor], torch.Tensor] = (
            lambda x: x)

    def init_params(self, seed: int = 0) -> Params:
        """Seeded random weights, drawn on the model's device in its type."""
        return init_from_specs(param_specs(self.cfg), dtype_of(self.cfg),
                               self.device, seed)

    # ---- blocks ----------------------------------------------------------
    def _enc_block(self, lp: Params, x: torch.Tensor, norm: Norm
                   ) -> torch.Tensor:
        cfg = self.cfg
        h, _, _ = attention(lp["attn"], cfg, norm(lp["ln1"], x), causal=False,
                            impl=self.impl, norm=norm)
        y = x + h
        return y + mlp(lp["mlp"], norm(lp["ln2"], y), cfg.act)

    def _dec_block(self, lp: Params, x: torch.Tensor, enc_out: torch.Tensor,
                   norm: Norm) -> torch.Tensor:
        cfg = self.cfg
        y = x + attention(lp["attn"], cfg, norm(lp["ln1"], x), impl=self.impl,
                          norm=norm)[0]
        # cross-attention: K/V from the encoder's output
        xa = lp["xattn"]
        kx = torch.einsum("bsd,dhk->bshk", *promoted(enc_out, xa["wk"]))
        vx = torch.einsum("bsd,dhk->bshk", *promoted(enc_out, xa["wv"]))
        y = y + attention(xa, cfg, norm(lp["ln_x"], y), causal=False,
                          impl=self.impl, norm=norm, kv_override=(kx, vx))[0]
        return y + mlp(lp["mlp"], norm(lp["ln2"], y), cfg.act)

    def _stack(self, layers: Params, x: torch.Tensor, n: int, mode: str,
               block, shared: Tuple[torch.Tensor, ...] = ()
               ) -> Tuple[torch.Tensor, Norm]:
        """``block(lp, x, norm, *shared)`` over ``n`` stacked layers, the
        constraint on each layer's output: the train path (plain norms,
        per-layer checkpoint when ``cfg.remat``) in ``mode="train"``, the
        model's norm otherwise."""
        hook = self.constraint
        if mode == "train":
            _train_route(self)
            x, _ = train_layers(
                layers, x, self.cfg.remat,
                lambda lp, y, *sh: (hook(block(lp, y, plain_rms_norm, *sh)),
                                    None), shared)
            return x, plain_rms_norm
        for i in layer_loop(n, lambda: x):
            x = hook(block(layer_params(layers, i), x, self.norm, *shared))
        return x, self.norm

    # ---- encoder ---------------------------------------------------------
    def encode(self, params: Params, frames: torch.Tensor,
               mode: str = "serve") -> torch.Tensor:
        """frames: [B, S_enc, D] stub frontend embeddings -> the normed
        encoder output [B, S_enc, D] (in the frames' type, or fp32 where
        fp32 frames meet bf16 weights)."""
        cfg = self.cfg
        pos = sinusoidal_positions(frames.shape[1], cfg.d_model,
                                   frames.device).to(frames.dtype)
        x, norm = self._stack(params["encoder"], frames + pos[None],
                              cfg.n_enc_layers, mode, self._enc_block)
        return norm(params["enc_norm"], x)

    # ---- decoder ---------------------------------------------------------
    def decode_train(self, params: Params, tokens: torch.Tensor,
                     enc_out: torch.Tensor, mode: str = "serve"
                     ) -> torch.Tensor:
        """Teacher-forced decoder over tokens [B, S] against ``enc_out``:
        the final-normed hidden states [B, S, D]."""
        cfg = self.cfg
        S = tokens.shape[1]
        x = embed(params["emb"], tokens) + params["pos_dec"][None, :S]
        # the reference constrains the decoder's input, not the encoder's
        x, norm = self._stack(
            params["decoder"], self.constraint(x), cfg.n_layers, mode,
            lambda lp, y, nm, enc: self._dec_block(lp, y, enc, nm),
            (enc_out,))
        return norm(params["final_norm"], x)

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token cross entropy of ``batch`` (``frames`` [B, S,
        D], ``tokens`` and ``labels`` [B, S_dec]), the reference's
        ``EncDecLM.loss``; the train path needs ``impl="ref"``."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["frames"], mode="train")
        x = self.decode_train(params, batch["tokens"], enc_out, mode="train")
        ce = cross_entropy_loss(params["emb"], x, batch["labels"],
                                cfg.loss_chunk, vocab_valid=cfg.vocab_size)
        return ce, {"ce": ce}

    # ---- serving ---------------------------------------------------------
    def init_decode_state(self, batch: int, max_seq: int) -> State:
        """Self-attention KV [L, B, max_seq, Hkv, hd], cross-attention KV
        ``xk``/``xv`` [L, B, CROSS_LEN, Hkv, hd], zeros, and ``length``."""
        cfg, dtype = self.cfg, dtype_of(self.cfg)
        self_kv = init_kv_cache(cfg, batch, max_seq, dtype, self.device)
        cross_kv = init_kv_cache(cfg, batch, CROSS_LEN, dtype, self.device)
        return {"k": self_kv["k"], "v": self_kv["v"],
                "xk": cross_kv["k"], "xv": cross_kv["v"],
                "length": self_kv["length"]}

    def prefill(self, params: Params, frames: torch.Tensor,
                tokens: torch.Tensor, max_seq: int,
                state: Optional[State] = None
                ) -> Tuple[State, torch.Tensor]:
        """Encode ``frames``, run the decoder over ``tokens`` [B, S]; returns
        (state, logits of the last position).

        The state's caches are zeros and its length S, as the reference's
        fresh state.  A given ``state`` (from :meth:`init_decode_state`) is
        zeroed and set in place, so its addresses stay fixed and a CUDA
        graph can capture the call."""
        cfg = self.cfg
        B, S = tokens.shape
        enc_out = self.encode(params, frames, mode="prefill")
        x = self.decode_train(params, tokens, enc_out, mode="prefill")
        logits = unembed(params["emb"], x[:, -1:, :])
        if state is None:
            state = self.init_decode_state(B, max_seq)
        else:
            want = (cfg.n_layers, B, max_seq, cfg.n_kv_heads, cfg.hd)
            if tuple(state["k"].shape) != want:
                raise ValueError(f"decode state {tuple(state['k'].shape)} does "
                                 f"not fit batch {B} and max_seq {max_seq}")
            for key in ("k", "v", "xk", "xv"):
                state[key].zero_()
        state["length"].fill_(S)
        return state, logits

    def decode_step(self, params: Params, state: State, tokens: torch.Tensor
                    ) -> Tuple[State, torch.Tensor]:
        """One token for every sequence. tokens: [B, 1].

        ``state`` is updated in place (the self-attention caches at
        ``length``, then ``length + 1``) and returned; the cross KV is read
        only.  The position is read on the device (no host sync), so a CUDA
        graph can capture the step."""
        cfg = self.cfg
        B = tokens.shape[0]
        h, hk, hd = cfg.n_heads_padded, cfg.n_kv_heads, cfg.hd
        n_rep = h // hk
        length = state["length"]
        pos_row = params["pos_dec"].index_select(0, length.reshape(-1).long())
        x = embed(params["emb"], tokens) + pos_row[:, None]
        pos = decode_positions(cfg, length, B, state["k"].shape[2])
        for i in layer_loop(cfg.n_layers, lambda: x):
            lp = layer_params(params["decoder"], i)
            y = x + decode_attention(lp["attn"], cfg, self.norm(lp["ln1"], x),
                                     state["k"][i], state["v"][i], pos,
                                     self.norm)
            # cross-attention against the static cross KV, grouped by KV head
            xk, xv = state["xk"][i], state["xv"][i]
            q = torch.einsum("bsd,dhk->bshk", self.norm(lp["ln_x"], y),
                             lp["xattn"]["wq"])
            q_ = q.reshape(B, hk, n_rep, hd)
            s = torch.einsum("bgrd,bsgd->bgrs", q_, xk).float() * hd ** -0.5
            pr = torch.softmax(s, dim=-1)
            o = torch.einsum("bgrs,bsgd->bgrd", pr.to(xv.dtype), xv)
            y = y + torch.einsum("bshk,hkd->bsd", o.reshape(B, 1, h, hd),
                                 lp["xattn"]["wo"])
            x = y + mlp(lp["mlp"], self.norm(lp["ln2"], y), cfg.act)
        x = self.norm(params["final_norm"], x)
        logits = unembed(params["emb"], x)
        length.add_(1)
        return state, logits
