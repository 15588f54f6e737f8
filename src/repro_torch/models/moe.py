"""Mixture-of-Experts: top-k router + shared experts.

A port of ``repro.models.moe``, with its two dispatch implementations:

* ``dense`` (:func:`moe_dense`): every expert runs on every token, combined
  with the router weights; the oracle.
* ``sorted`` (:func:`moe_sorted`): capacity-bounded sort-based dispatch per
  batch row: the (token, choice) slots are sorted by expert, each expert
  takes a static capacity ``C = min(S, max(1, int(S*k*cf/E)))`` of them, and
  the outputs are combined back with the router weights.  The reference's
  ``"sorted_smap"`` runs this same function when no mesh is set, which is
  always the case on one device.

Every shape is static and nothing reads back to the host, so a CUDA graph
captures the sorted path: the per-expert counts are a comparison summed over
the slots (``bincount`` would size its output from the data); the
reference's ``.at[slot].set/add(mode="drop")`` becomes a scatter into one
spare column (``E*C``) that absorbs every dropped slot and is sliced off;
the combine is a gather of each token's kept slots, added in ascending
expert order in the model's type, as the reference's scatter-add adds them
(``index_add_`` would add with atomics in no fixed order on the card).

The router's top-k is a stable descending sort of the probabilities: equal
probabilities keep the lower expert first, as ``lax.top_k`` does
(``torch.topk`` states no order for ties).  Expert FFNs have no kernel in
the reference and stay plain PyTorch.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import Params, Spec, silu

__all__ = ["moe_specs", "moe_block", "moe_dense", "moe_sorted", "capacity"]


def moe_specs(cfg: ModelConfig, n_layers: int) -> Params:
    """``repro.models.moe.init_moe`` as a spec tree stacked over
    ``n_layers``: the router is fp32 whatever the model's type; the shared
    experts, if any, sit under ``"shared"``."""
    L, d, ff, E = n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
    s_in, s_ff = d ** -0.5, ff ** -0.5
    p = {"router": Spec((L, d, E), s_in, dtype=torch.float32),
         "w_gate": Spec((L, E, d, ff), s_in),
         "w_up": Spec((L, E, d, ff), s_in),
         "w_down": Spec((L, E, ff, d), s_ff)}
    if cfg.n_shared_experts:
        Es = cfg.n_shared_experts
        p["shared"] = {"w_gate": Spec((L, Es, d, ff), s_in),
                       "w_up": Spec((L, Es, d, ff), s_in),
                       "w_down": Spec((L, Es, ff, d), s_ff)}
    return p


def _act(g: torch.Tensor, act: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(g, approximate="tanh") if act == "gelu" else silu(g)


def _shared_ffn(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    """All shared experts on every token, their outputs summed."""
    g = torch.einsum("bsd,edf->ebsf", x, p["w_gate"])
    u = torch.einsum("bsd,edf->ebsf", x, p["w_up"])
    return torch.einsum("ebsf,efd->bsd", _act(g, act) * u, p["w_down"])


def _router(p: Params, cfg: ModelConfig, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (weights [B,S,k] fp32 normalised, ids [B,S,k] int64, aux).

    aux is the Switch load-balancing loss ``E * sum_e f_e * p_e``: the mean
    router probability of each expert times the share of tokens whose first
    choice it is."""
    E, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[..., :k], ids[..., :k]
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    experts = torch.arange(E, device=x.device)
    me = probs.mean(dim=(0, 1))
    fe = (ids[..., 0, None] == experts).float().mean(dim=(0, 1))
    return w, ids, E * torch.sum(me * fe)


def moe_dense(p: Params, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference: all experts on all tokens. x: [B, S, D]."""
    w, ids, aux = _router(p, cfg, x)
    g = torch.einsum("bsd,edf->ebsf", x, p["w_gate"])
    u = torch.einsum("bsd,edf->ebsf", x, p["w_up"])
    y_e = torch.einsum("ebsf,efd->ebsd", _act(g, cfg.act) * u, p["w_down"])
    experts = torch.arange(cfg.n_experts, device=x.device)
    mask = (ids[..., None] == experts).float()                 # [B,S,k,E]
    comb = torch.einsum("bske,bsk->ebs", mask, w).to(x.dtype)
    y = torch.einsum("ebs,ebsd->bsd", comb, y_e)
    if cfg.n_shared_experts:
        y = y + _shared_ffn(p["shared"], x, cfg.act)
    return y, aux


def capacity(cfg: ModelConfig, S: int) -> int:
    """Slots an expert takes from one batch row of ``S`` tokens."""
    C = max(1, int(S * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return min(C, S)


def _sorted_core(cfg: ModelConfig, x: torch.Tensor, w: torch.Tensor,
                 ids: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor) -> torch.Tensor:
    """Sort-based capacity dispatch given the router's outputs, one batch
    row at a time (each row sorts its own slots), as the reference's
    ``jax.vmap`` of ``dispatch_row`` and ``combine_row``."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)
    dev = x.device
    n = S * k
    flat_ids = ids.reshape(B, n)
    order = torch.argsort(flat_ids, dim=-1, stable=True)       # by expert
    sorted_ids = flat_ids.gather(1, order)
    sorted_tok = order // k                                    # source token
    sorted_w = w.reshape(B, n).gather(1, order)
    experts = torch.arange(E, device=dev)
    counts = (sorted_ids[..., None] == experts).sum(dim=1)     # [B, E]
    starts = torch.cumsum(counts, dim=1) - counts
    within = torch.arange(n, device=dev) - starts.gather(1, sorted_ids)
    # a dropped slot goes to the spare column E*C
    slot = torch.where(within < C, sorted_ids * C + within, E * C)
    src = torch.full((B, E * C + 1), S, dtype=torch.int64, device=dev)
    src.scatter_(1, slot, sorted_tok)                          # S: zero row
    wtab = torch.zeros(B, E * C + 1, dtype=torch.float32, device=dev)
    wtab.scatter_(1, slot, sorted_w)
    x_pad = torch.cat([x, x.new_zeros(B, 1, D)], dim=1)
    xe = x_pad.gather(1, src[:, :E * C, None].expand(-1, -1, D))
    xe = xe.reshape(B, E, C, D)
    g = torch.einsum("becd,edf->becf", xe, w_gate)
    u = torch.einsum("becd,edf->becf", xe, w_up)
    ye = torch.einsum("becf,efd->becd", _act(g, cfg.act) * u, w_down)
    ye = ye.reshape(B, E * C, D) * wtab[:, :E * C, None].to(ye.dtype)
    ye = torch.cat([ye, ye.new_zeros(B, 1, D)], dim=1)          # spare: zero
    # each token's k slots (E*C where dropped), in ascending slot order,
    # which is ascending expert order: the reference's scatter-add order
    slot_of = torch.empty_like(slot)
    slot_of.scatter_(1, order, slot)
    slot_of = torch.sort(slot_of.reshape(B, S, k), dim=-1).values
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + ye.gather(1, slot_of[..., j, None].expand(-1, -1, D))
    return out


def moe_sorted(p: Params, cfg: ModelConfig, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based capacity dispatch. x: [B, S, D] -> (y, aux)."""
    w, ids, aux = _router(p, cfg, x)
    y = _sorted_core(cfg, x, w, ids, p["w_gate"], p["w_up"], p["w_down"])
    if cfg.n_shared_experts:
        y = y + _shared_ffn(p["shared"], x, cfg.act)
    return y, aux


def moe_block(p: Params, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cfg.moe_impl``: ``"dense"`` runs :func:`moe_dense`; ``"sorted"``
    and ``"sorted_smap"`` run :func:`moe_sorted`."""
    if cfg.moe_impl == "dense":
        return moe_dense(p, cfg, x)
    return moe_sorted(p, cfg, x)
