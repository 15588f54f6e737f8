"""Decoder-only transformer LM, dense and MoE.

Parameters are a nested dict with the reference's structure
(``repro.models.transformer.TransformerLM.init_params``): per-layer tensors
are stacked on a leading L axis, and the reference's scan over layers becomes
a loop over that axis.  A config with ``n_experts`` puts an MoE block
(``models/moe.py``) in place of every layer's MLP, as the reference does.
Positions other than RoPE raise ``NotImplementedError``.

:meth:`TransformerLM.loss` is the train path (``hidden_states`` in
``mode="train"``): the reference's plain route (``impl="ref"``) under
autograd, each layer's views taken with one ``unbind`` per stacked leaf,
each layer under activation checkpointing when ``cfg.remat``, and plain
norms (the kernels have no backward).  With MoE it adds
``MOE_AUX_COEF`` times the layers' mean load-balancing loss.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import torch
import torch.utils.checkpoint

from ..configs.base import ModelConfig
from ..core.stream import weighted_stacks
from ..device import resolve_device
from .attention import (IMPLS, DecodePositions, ExtendPositions, attention,
                        decode_attention, decode_positions, extend_attention,
                        extend_positions, init_kv_cache)
from .layers import (Norm, Params, Spec, cross_entropy_loss, dtype_of, embed,
                     embedding_specs, init_from_specs, layer_loop,
                     layer_params, mlp, norm_of, plain_rms_norm, rms_norm,
                     unbind_layers, unembed, weighted_layers)
from .moe import moe_block, moe_specs

__all__ = ["TransformerLM", "param_specs", "attention_specs", "mlp_specs",
           "train_layers", "MOE_AUX_COEF"]

MOE_AUX_COEF = 0.01


def attention_specs(cfg: ModelConfig, n_layers: int) -> Params:
    """``repro.models.attention.init_attention`` stacked over
    ``n_layers``."""
    L, d, h, hk, hd = (n_layers, cfg.d_model, cfg.n_heads_padded,
                       cfg.n_kv_heads, cfg.hd)
    attn = {"wq": Spec((L, d, h, hd), d ** -0.5),
            "wk": Spec((L, d, hk, hd), d ** -0.5),
            "wv": Spec((L, d, hk, hd), d ** -0.5),
            "wo": Spec((L, h, hd, d), (h * hd) ** -0.5)}
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": Spec((L, hd), 0.0)}
        attn["k_norm"] = {"scale": Spec((L, hd), 0.0)}
    return attn


def mlp_specs(cfg: ModelConfig, n_layers: int) -> Params:
    """``repro.models.layers.init_mlp`` stacked over ``n_layers``."""
    L, d, ff = n_layers, cfg.d_model, cfg.d_ff
    return {"w_gate": Spec((L, d, ff), d ** -0.5),
            "w_up": Spec((L, d, ff), d ** -0.5),
            "w_down": Spec((L, ff, d), ff ** -0.5)}


def param_specs(cfg: ModelConfig) -> Any:
    """The param tree for ``cfg``, one :class:`Spec` a leaf.

    The structure, shapes and scales are the reference's; a std of 0 marks
    a zero-initialised norm scale (``(1 + scale)`` gain).  With
    ``n_experts`` every layer holds ``"moe"`` in place of ``"mlp"``.
    """
    L, d = cfg.n_layers, cfg.d_model
    layers = {"ln1": {"scale": Spec((L, d), 0.0)},
              "attn": attention_specs(cfg, L),
              "ln2": {"scale": Spec((L, d), 0.0)}}
    if cfg.n_experts:
        layers["moe"] = moe_specs(cfg, L)
    else:
        layers["mlp"] = mlp_specs(cfg, L)
    return {"emb": embedding_specs(cfg), "layers": layers,
            "final_norm": {"scale": Spec((d,), 0.0)}}


def ffn(p: Params, cfg: ModelConfig, h: torch.Tensor
        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A block's feed-forward half on the normed ``h``: the MoE block where
    ``p`` holds one (with its aux loss), else the MLP (aux None)."""
    if "moe" in p:
        return moe_block(p["moe"], cfg, h)
    return mlp(p["mlp"], h, cfg.act), None


def block_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, impl: str, norm: Norm = rms_norm
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             Optional[torch.Tensor]]:
    """One block; returns (x, k, v, aux) with the block's cache entries and
    its MoE aux loss (None without MoE)."""
    a, k, v = attention(p["attn"], cfg, norm(p["ln1"], x), positions,
                        impl=impl, norm=norm)
    x = x + a
    m, aux = ffn(p, cfg, norm(p["ln2"], x))
    return x + m, k, v, aux


def train_layers(layers: Params, x: torch.Tensor, remat: bool,
                 block: Callable[..., Tuple[torch.Tensor,
                                            Optional[torch.Tensor]]],
                 shared: Sequence[torch.Tensor] = ()
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``block(layer_params, x, *shared) -> (x, aux)`` over the stacked
    layers for the train path: per-layer views by
    :func:`~.layers.unbind_layers`, each layer recomputed in the backward
    when ``remat`` (the reference's ``jax.checkpoint`` of its scan body).
    ``shared`` are inputs every layer reads (the encoder's output).
    Returns x and the layers' aux losses (those that are not None).  The
    RNG state is not saved: no step draws random numbers, and reading it
    is illegal in a CUDA Graph capture.  Under the dry-run's weighted
    recording the loop is :func:`~.layers.weighted_layers`."""
    def run(lp: Params, y: torch.Tensor, *sh: torch.Tensor
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if remat:
            return torch.utils.checkpoint.checkpoint(
                block, lp, y, *sh, use_reentrant=False,
                preserve_rng_state=False)
        return block(lp, y, *sh)

    if weighted_stacks.active():
        return weighted_layers(layers, x, run, shared)
    auxs: List[torch.Tensor] = []
    for lp in unbind_layers(layers):
        x, aux = run(lp, x, *shared)
        if aux is not None:
            auxs.append(aux)
    return x, auxs


def block_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 k_cache: torch.Tensor, v_cache: torch.Tensor,
                 pos: DecodePositions, norm: Norm = rms_norm) -> torch.Tensor:
    x = x + decode_attention(p["attn"], cfg, norm(p["ln1"], x),
                             k_cache, v_cache, pos, norm=norm)
    return x + ffn(p, cfg, norm(p["ln2"], x))[0]


def block_extend(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 k_cache: torch.Tensor, v_cache: torch.Tensor,
                 pos: ExtendPositions, norm: Norm = rms_norm) -> torch.Tensor:
    x = x + extend_attention(p["attn"], cfg, norm(p["ln1"], x),
                             k_cache, v_cache, pos, norm=norm)
    return x + ffn(p, cfg, norm(p["ln2"], x))[0]


def mean_aux(auxs: List[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The mean of the layers' aux losses; 0 without MoE, as the
    reference's mean over zeros."""
    if not auxs:
        return torch.zeros((), dtype=torch.float32, device=device)
    return torch.stack(auxs).mean()


def _train_route(model: Any) -> None:
    if model.impl != "ref":
        raise ValueError(f"{model.cfg.name}: the train path runs the plain "
                         f"route (impl='ref'); the {model.impl!r} kernels "
                         f"have no backward")


class TransformerLM:
    """Dense or MoE decoder-only LM on one device.

    ``impl`` selects the prefill attention route and the norms outside the
    train path (``"cuda"``: the flash and RMSNorm kernels; ``"ref"``: dense
    softmax and plain norms).  ``device`` defaults to ``cuda`` and
    raises without CUDA unless ``"cpu"`` is passed.
    """

    #: the config families this class builds (``VlmLM``: ``vlm``)
    FAMILIES: Tuple[str, ...] = ("dense", "moe")

    def __init__(self, cfg: ModelConfig, impl: str = "cuda",
                 device: Optional[Union[str, torch.device]] = None) -> None:
        if cfg.family not in self.FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: {type(self).__name__} serves the "
                f"{' and '.join(self.FAMILIES)} families, not {cfg.family!r}")
        if cfg.pos_embed != "rope":
            raise NotImplementedError(
                f"{cfg.name}: pos_embed={cfg.pos_embed!r} is not ported")
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

    # ---- params ----------------------------------------------------------
    def init_params(self, seed: int = 0) -> Params:
        """Seeded random weights, drawn on the model's device in its type."""
        return init_from_specs(param_specs(self.cfg), dtype_of(self.cfg),
                               self.device, seed)

    # ---- forward ---------------------------------------------------------
    def hidden_states_and_aux(self, params: Params, tokens: torch.Tensor,
                              mode: str = "serve"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Final-normed hidden states [B, S, D] of the whole sequence and
        the layers' mean MoE aux loss (0 without MoE): the reference's
        ``hidden_states``.

        ``mode="train"`` is the train path (see the module's docstring);
        it needs the plain route, ``impl="ref"``."""
        cfg = self.cfg
        x = self.constraint(embed(params["emb"], tokens, cfg.embed_scale))
        positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
        if mode == "train":
            _train_route(self)

            def block(lp: Params, y: torch.Tensor
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
                y, _, _, aux = block_forward(lp, cfg, y, positions,
                                             self.impl, plain_rms_norm)
                return self.constraint(y), aux

            x, auxs = train_layers(params["layers"], x, cfg.remat, block)
            return (plain_rms_norm(params["final_norm"], x),
                    mean_aux(auxs, x.device))
        auxs = []
        layers = layer_loop(cfg.n_layers, lambda: x)
        for i in layers:
            x, _, _, aux = block_forward(layer_params(params["layers"], i),
                                         cfg, x, positions, self.impl,
                                         self.norm)
            x = self.constraint(x)
            if aux is not None:
                auxs.append(aux)
        return self.norm(params["final_norm"], x), mean_aux(
            layers.per_layer(auxs), x.device)

    def hidden_states(self, params: Params, tokens: torch.Tensor,
                      mode: str = "serve") -> torch.Tensor:
        """The hidden states of :meth:`hidden_states_and_aux`."""
        return self.hidden_states_and_aux(params, tokens, mode)[0]

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token cross entropy of ``batch`` (``tokens`` and
        ``labels``, [B, S]) plus, with MoE, ``MOE_AUX_COEF`` times the
        mean aux loss, and its metrics, as the reference's
        ``TransformerLM.loss``."""
        cfg = self.cfg
        x, aux = self.hidden_states_and_aux(params, batch["tokens"],
                                            mode="train")
        ce = cross_entropy_loss(params["emb"], x, batch["labels"],
                                cfg.loss_chunk, vocab_valid=cfg.vocab_size)
        total = ce + MOE_AUX_COEF * aux if cfg.n_experts else ce
        return total, {"ce": ce, "aux": aux}

    # ---- serving ---------------------------------------------------------
    def init_decode_state(self, batch: int, max_seq: int
                          ) -> Dict[str, torch.Tensor]:
        return init_kv_cache(self.cfg, batch, max_seq, dtype_of(self.cfg),
                             self.device)

    def init_slot_state(self, batch: int, max_seq: int
                        ) -> Dict[str, torch.Tensor]:
        """The continuous engine's state: ``batch`` slots, each with its own
        cache length (``length`` of shape ``[batch]``)."""
        return init_kv_cache(self.cfg, batch, max_seq, dtype_of(self.cfg),
                             self.device, per_slot=True)

    def install_slot(self, slots: Dict[str, torch.Tensor],
                     one: Dict[str, torch.Tensor], index: torch.Tensor
                     ) -> None:
        """Copy a batch-1 decode state ``one`` (a prefill's) into slot
        ``index`` (a ``[1]`` int64 tensor on the device) of ``slots``: all
        ``max_seq`` cache rows and the length, in place."""
        slots["k"].index_copy_(1, index, one["k"])
        slots["v"].index_copy_(1, index, one["v"])
        slots["length"].index_copy_(0, index, one["length"].reshape(1))

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
        for i in layer_loop(cfg.n_layers, lambda: x):
            x, k, v, _ = block_forward(layer_params(params["layers"], i),
                                       cfg, x, positions, self.impl,
                                       self.norm)
            state["k"][i, :, :S] = k
            state["v"][i, :, :S] = v
        x = self.norm(params["final_norm"], x)
        logits = unembed(params["emb"], x[:, -1:, :])
        state["length"].fill_(S)
        return state, logits

    def prefill_extend(self, params: Params, state: Dict[str, torch.Tensor],
                       tokens: torch.Tensor
                       ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Extend a decode state by one prompt chunk (chunked prefill).

        tokens: [B, C], the prompt's positions ``state["length"]`` ..
        ``length + C - 1``; the length is a ``[]`` tensor on the device, so
        one captured graph serves every start.  ``state`` is updated in
        place (the caches at those rows, then ``length + C``) and returned
        with the logits of the chunk's last position.
        """
        cfg = self.cfg
        x = embed(params["emb"], tokens, cfg.embed_scale)
        length = state["length"]
        pos = extend_positions(cfg, length, tokens.shape[1],
                               state["k"].shape[2])
        for i in layer_loop(cfg.n_layers, lambda: x):
            x = block_extend(layer_params(params["layers"], i), cfg, x,
                             state["k"][i], state["v"][i], pos, self.norm)
        x = self.norm(params["final_norm"], x)
        logits = unembed(params["emb"], x[:, -1:, :])
        length.add_(tokens.shape[1])
        return state, logits

    def decode_step(self, params: Params, state: Dict[str, torch.Tensor],
                    tokens: torch.Tensor
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One token for every sequence. tokens: [B, 1].

        ``state`` is updated in place (the caches at ``length``, then
        ``length + 1``) and returned.  Its ``length`` is one for the batch
        (``[]``) or one a slot (``[B]``, :meth:`init_slot_state`).
        """
        cfg = self.cfg
        x = embed(params["emb"], tokens, cfg.embed_scale)
        length = state["length"]
        pos = decode_positions(cfg, length, tokens.shape[0],
                               state["k"].shape[2])
        for i in layer_loop(cfg.n_layers, lambda: x):
            x = block_decode(layer_params(params["layers"], i), cfg, x,
                             state["k"][i], state["v"][i], pos, self.norm)
        x = self.norm(params["final_norm"], x)
        logits = unembed(params["emb"], x)
        length.add_(1)
        return state, logits
