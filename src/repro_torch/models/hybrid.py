"""Jamba-style hybrid LM: Mamba/attention interleave with an MoE cadence.

A port of ``repro.models.hybrid.HybridLM``.  Layers are grouped into periods
of ``cfg.attn_every`` (8 for jamba); within a period the sub-layer plan is
fixed (attention at ``attn_offset``, Mamba2 elsewhere; MoE in place of the
MLP on every ``moe_every``-th layer).  Parameters have the reference's
structure, ``"groups"/"sub{i}"`` with every leaf stacked on a leading
``[G]`` axis of groups; the reference's scan over groups becomes a loop.

The attention sub-layers run the flash kernel on the prompt
(``pos_embed="none"``: no rotary), the Mamba ones the SSD kernel
(``impl="cuda"``), or both plain routes (``impl="ref"``).  As in the
reference, :meth:`HybridLM.prefill` returns a zero KV cache and a zero SSM
state at length S: decode does not start from the prompt's state.  There is
no ``prefill_extend``, so chunked prefill and the paged KV backend refuse
the hybrid (``runtime/kv.py``), as the reference's do.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .attention import (IMPLS, attention, decode_attention, decode_positions,
                        init_kv_cache)
from .layers import (Norm, Params, Spec, cross_entropy_loss, dtype_of, embed,
                     embedding_specs, init_from_specs, layer_params,
                     map_params, plain_rms_norm, rms_norm, unembed)
from .mamba import (init_ssm_state, mamba_block, mamba_decode_step,
                    mamba_specs)
from .moe import moe_specs
from .transformer import (MOE_AUX_COEF, _train_route, attention_specs, ffn,
                          mean_aux, mlp_specs, train_layers)

__all__ = ["HybridLM", "param_specs", "plan"]


def plan(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """The fixed (mixer, ffn) plan of one period: ``"attn"`` or
    ``"mamba"``, ``"moe"`` or ``"mlp"``."""
    if cfg.attn_every <= 0 or cfg.n_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: a hybrid needs attn_every > 0 "
                         f"dividing n_layers={cfg.n_layers}")
    return [("attn" if cfg.is_attn_layer(i) else "mamba",
             "moe" if cfg.is_moe_layer(i) else "mlp")
            for i in range(cfg.attn_every)]


def param_specs(cfg: ModelConfig) -> Any:
    """The param tree for ``cfg``, one :class:`Spec` a leaf, stacked over
    the ``n_layers // attn_every`` groups."""
    G, d = cfg.n_layers // cfg.attn_every, cfg.d_model
    groups: Dict[str, Params] = {}
    for i, (mixer, kind) in enumerate(plan(cfg)):
        sub: Params = {"ln1": {"scale": Spec((G, d), 0.0)},
                       "ln2": {"scale": Spec((G, d), 0.0)}}
        sub[mixer] = (attention_specs(cfg, G) if mixer == "attn"
                      else mamba_specs(cfg, G))
        sub[kind] = moe_specs(cfg, G) if kind == "moe" else mlp_specs(cfg, G)
        groups[f"sub{i}"] = sub
    return {"emb": embedding_specs(cfg), "groups": groups,
            "final_norm": {"scale": Spec((d,), 0.0)}}


class HybridLM:
    """Hybrid (Mamba2 + attention + MoE) LM on one device.

    ``impl`` selects the prompt's routes (``"cuda"``: the flash and SSD
    kernels; ``"ref"``: dense softmax and the plain chunked scan).
    ``device`` defaults to ``cuda`` and raises without CUDA unless
    ``"cpu"`` is passed.
    """

    def __init__(self, cfg: ModelConfig, impl: str = "cuda",
                 device: Optional[Union[str, torch.device]] = None) -> None:
        if cfg.family != "hybrid":
            raise NotImplementedError(f"{cfg.name}: HybridLM serves the "
                                      f"hybrid family, not {cfg.family!r}")
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
        self.cfg = cfg
        self.impl = impl
        self.device = resolve_device(device)
        self.plan = plan(cfg)
        self.period = cfg.attn_every
        self.n_groups = cfg.n_layers // self.period
        self.n_attn_per_group = sum(m == "attn" for m, _ in self.plan)
        self.n_ssm_per_group = self.period - self.n_attn_per_group

    def init_params(self, seed: int = 0) -> Params:
        """Seeded random weights, drawn on the model's device."""
        return init_from_specs(param_specs(self.cfg), dtype_of(self.cfg),
                               self.device, seed)

    # ---- forward ---------------------------------------------------------
    def _group(self, gp: Params, x: torch.Tensor, norm: Norm
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One period over the whole sequence; returns x and the sum of
        its MoE aux losses over the period's length."""
        cfg = self.cfg
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, (mixer, _) in enumerate(self.plan):
            sub = gp[f"sub{i}"]
            h = norm(sub["ln1"], x)
            if mixer == "attn":
                x = x + attention(sub["attn"], cfg, h, impl=self.impl,
                                  norm=norm)[0]
            else:
                x = x + mamba_block(sub["mamba"], cfg, h, self.impl,
                                    norm=norm)
            m, aux = ffn(sub, cfg, norm(sub["ln2"], x))
            if aux is not None:
                aux_total = aux_total + aux
            x = x + m
        return x, aux_total / self.period

    def hidden_states_and_aux(self, params: Params, tokens: torch.Tensor,
                              mode: str = "serve"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Final-normed hidden states [B, S, D] and the groups' mean aux
        loss: the reference's ``hidden_states``.  ``mode="train"`` is the
        train path (plain route, plain norms, each group recomputed in the
        backward when ``cfg.remat``)."""
        cfg = self.cfg
        S = tokens.shape[1]
        chunk = min(cfg.ssm_chunk, S)
        if S % chunk:
            raise ValueError(f"{cfg.name}: prompt length {S} is not a "
                             f"multiple of the ssm chunk {chunk}")
        x = embed(params["emb"], tokens, cfg.embed_scale)
        if mode == "train":
            _train_route(self)
            x, auxs = train_layers(
                params["groups"], x, cfg.remat,
                lambda gp, y: self._group(gp, y, plain_rms_norm))
            return plain_rms_norm(params["final_norm"], x), mean_aux(
                auxs, x.device)
        auxs = []
        for g in range(self.n_groups):
            x, aux = self._group(layer_params(params["groups"], g), x,
                                 rms_norm)
            auxs.append(aux)
        return rms_norm(params["final_norm"], x), mean_aux(auxs, x.device)

    def hidden_states(self, params: Params, tokens: torch.Tensor,
                      mode: str = "serve") -> torch.Tensor:
        """The hidden states of :meth:`hidden_states_and_aux`."""
        return self.hidden_states_and_aux(params, tokens, mode)[0]

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Cross entropy plus ``MOE_AUX_COEF`` times the mean aux loss, and
        its metrics, as the reference's ``HybridLM.loss``."""
        cfg = self.cfg
        x, aux = self.hidden_states_and_aux(params, batch["tokens"],
                                            mode="train")
        ce = cross_entropy_loss(params["emb"], x, batch["labels"],
                                cfg.loss_chunk, vocab_valid=cfg.vocab_size)
        return ce + MOE_AUX_COEF * aux, {"ce": ce, "aux": aux}

    # ---- serving ---------------------------------------------------------
    def init_decode_state(self, batch: int, max_seq: int,
                          per_slot: bool = False) -> Params:
        """k and v [G, A, B, max_seq, Hkv, hd] (A attention sub-layers a
        group), ``length`` (``[]``, or ``[B]`` with ``per_slot``), and
        ``ssm``: the Mamba2 decode state, each leaf [G, M, B, ...] (M Mamba
        sub-layers a group)."""
        cfg, dev = self.cfg, self.device
        dtype = dtype_of(cfg)
        G, A, M = self.n_groups, self.n_attn_per_group, self.n_ssm_per_group
        kv = init_kv_cache(cfg, batch, max_seq, dtype, dev, per_slot,
                           n_layers=G * A)
        ssm = init_ssm_state(cfg, batch, dtype, dev, n_layers=G * M)
        return {"k": kv["k"].reshape((G, A) + kv["k"].shape[1:]),
                "v": kv["v"].reshape((G, A) + kv["v"].shape[1:]),
                "length": kv["length"],
                "ssm": {k: v.reshape((G, M) + v.shape[1:])
                        for k, v in ssm.items()}}

    def init_slot_state(self, batch: int, max_seq: int) -> Params:
        """The continuous engine's state: ``batch`` slots, each with its own
        cache length (``length`` of shape ``[batch]``)."""
        return self.init_decode_state(batch, max_seq, per_slot=True)

    def install_slot(self, slots: Params, one: Params, index: torch.Tensor
                     ) -> None:
        """Copy a batch-1 decode state ``one`` (a prefill's) into slot
        ``index`` (a ``[1]`` int64 tensor on the device) of ``slots``, in
        place: every leaf's slot axis is axis 2, the length's axis 0."""
        slots["k"].index_copy_(2, index, one["k"])
        slots["v"].index_copy_(2, index, one["v"])
        for k, v in slots["ssm"].items():
            v.index_copy_(2, index, one["ssm"][k])
        slots["length"].index_copy_(0, index, one["length"].reshape(1))

    def prefill(self, params: Params, tokens: torch.Tensor, max_seq: int,
                state: Optional[Params] = None
                ) -> Tuple[Params, torch.Tensor]:
        """Run the prompt; returns (state, last logits).

        As in the reference (``repro.models.hybrid.HybridLM.prefill``), the
        state is zero, KV cache and SSM state alike, at length S.  A given
        ``state`` (from :meth:`init_decode_state`) is zeroed in place and
        returned, so its addresses stay fixed; without it a fresh one is
        allocated.
        """
        B, S = tokens.shape
        if S > max_seq:
            raise ValueError(f"prompt length {S} exceeds max_seq={max_seq}")
        x = self.hidden_states(params, tokens)
        logits = unembed(params["emb"], x[:, -1:, :])
        if state is None:
            state = self.init_decode_state(B, max_seq)
        else:
            map_params(lambda t: t.zero_(), state)
        state["length"].fill_(S)
        return state, logits

    def decode_step(self, params: Params, state: Params,
                    tokens: torch.Tensor) -> Tuple[Params, torch.Tensor]:
        """One token for every sequence. tokens: [B, 1].

        ``state`` is updated in place (the caches at ``length``, the SSM
        state, then ``length + 1``) and returned; its ``length`` is one for
        the batch (``[]``) or one a slot (``[B]``)."""
        cfg = self.cfg
        x = embed(params["emb"], tokens, cfg.embed_scale)
        length = state["length"]
        pos = decode_positions(cfg, length, tokens.shape[0],
                               state["k"].shape[3])
        ssm = state["ssm"]
        for g in range(self.n_groups):
            gp = layer_params(params["groups"], g)
            ai = si = 0
            for i, (mixer, _) in enumerate(self.plan):
                sub = gp[f"sub{i}"]
                h = rms_norm(sub["ln1"], x)
                if mixer == "attn":
                    x = x + decode_attention(sub["attn"], cfg, h,
                                             state["k"][g, ai],
                                             state["v"][g, ai], pos)
                    ai += 1
                else:
                    dx, new = mamba_decode_step(
                        sub["mamba"], cfg, h,
                        {k: v[g, si] for k, v in ssm.items()})
                    for k, v in new.items():
                        ssm[k][g, si].copy_(v)
                    x = x + dx
                    si += 1
                x = x + ffn(sub, cfg, rms_norm(sub["ln2"], x))[0]
        x = rms_norm(params["final_norm"], x)
        logits = unembed(params["emb"], x)
        length.add_(1)
        return state, logits
