"""Attention: GQA/MQA with rotary, the full-sequence (prefill) path and the
KV-cache decode path.

``impl`` selects the full-sequence route, as in ``repro.models.attention``:
``"cuda"`` is the flash-attention kernel (its wrapper takes the plain version
for CPU tensors), ``"ref"`` the dense O(S²)-memory softmax.  The reference's
chunked causal path, which only bounds memory for long training sequences,
is not ported.  Decode attention has no kernel in the reference and stays
plain PyTorch.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import flash_attention
from .layers import Params, apply_rope, rms_norm, rotary

__all__ = ["attention", "decode_attention", "decode_positions",
           "DecodePositions", "init_kv_cache", "dense_causal_attention",
           "IMPLS"]

IMPLS = ("cuda", "ref")


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    B, S, Hk, hd = k.shape
    k = k[:, :, :, None, :].expand(B, S, Hk, n_rep, hd)
    return k.reshape(B, S, Hk * n_rep, hd)


def dense_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           causal: bool = True) -> torch.Tensor:
    """Reference O(S^2)-memory attention. q,k,v: [B, S, H, hd]."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    scale = hd ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        mask = torch.ones(Sq, Sk, dtype=torch.bool,
                          device=q.device).tril(Sk - Sq)
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    # probabilities are cast to q's type before the PV product
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
              positions: Optional[torch.Tensor] = None, causal: bool = True,
              impl: str = "ref"
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence attention (prefill). x: [B, S, D].

    Returns ``(out [B, S, D], k, v)``: k and v are [B, S, Hkv, hd] after the
    k-norm and RoPE, the entries a prefill writes into the KV cache.
    """
    B, S, D = x.shape
    h, hd = cfg.n_heads_padded, cfg.hd
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"]).contiguous()
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q)
        k = rms_norm(p["k_norm"], k)
    if cfg.pos_embed == "rope":
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        sin, cos = rotary(positions, hd, cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    if impl == "cuda":
        out = flash_attention(q.contiguous(), k.contiguous(), v, causal=causal)
    elif impl == "ref":
        n_rep = h // k.shape[2]
        out = dense_causal_attention(q, _repeat_kv(k, n_rep),
                                     _repeat_kv(v, n_rep), causal)
    else:
        raise ValueError(f"unknown attention impl {impl!r}; expected one of "
                         f"{IMPLS}")
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), k, v


# --------------------------------------------------------------------------
# decode path
# --------------------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  dtype: torch.dtype, device: torch.device,
                  per_slot: bool = False) -> Dict[str, torch.Tensor]:
    """KV cache [L, B, S, Hkv, hd] + current length: a scalar int32, or
    one a sequence (``[B]``) with ``per_slot``."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "length": torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                              device=device),
    }


class DecodePositions(NamedTuple):
    """Where one decode step writes and what it reads, for every sequence:
    the same in every layer, so :func:`decode_positions` computes it once a
    step."""

    rows: Tuple[torch.Tensor, torch.Tensor]  # (b, clamped length) each
    masked: torch.Tensor          # [B, 1, 1, S_max], positions past length
    sin: Optional[torch.Tensor]   # [B, 1, hd/2], rope at the length
    cos: Optional[torch.Tensor]


def decode_positions(cfg: ModelConfig, length: torch.Tensor, batch: int,
                     max_seq: int) -> DecodePositions:
    """The positions of one decode step.  ``length`` (int32) is the number
    of valid cache positions, one for the batch (``[]``) or one a sequence
    (``[B]``, the continuous engine's slots).  The write row is clamped to
    ``max_seq - 1`` as the reference's ``dynamic_update_slice`` clamps (a
    finished slot that goes on decoding runs past ``max_seq``)."""
    lengths = length.expand(batch) if length.dim() == 0 else length
    dev = length.device
    rows = (torch.arange(batch, device=dev),
            lengths.clamp(0, max_seq - 1).long())
    masked = torch.arange(max_seq, device=dev)[None, :] > lengths[:, None]
    sin = cos = None
    if cfg.pos_embed == "rope":
        sin, cos = rotary(lengths.reshape(batch, 1), cfg.hd, cfg.rope_theta)
    return DecodePositions(rows, masked[:, None, None, :], sin, cos)


def decode_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: DecodePositions) -> torch.Tensor:
    """One-token attention against a cache.

    x: [B, 1, D]; k_cache/v_cache: [B, S_max, Hkv, hd]; ``pos`` from
    :func:`decode_positions`.  The new token's K/V are written into the
    caches *in place* at each sequence's row, one scatter on device-side
    indices, so a CUDA graph can capture it; writing in place saves a copy
    of the whole cache per layer and step.  Returns out [B, 1, D].
    """
    B, _, D = x.shape
    h, hk, hd = cfg.n_heads_padded, cfg.n_kv_heads, cfg.hd
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k_new = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v_new = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q)
        k_new = rms_norm(p["k_norm"], k_new)
    if pos.sin is not None:
        q = apply_rope(q, pos.sin, pos.cos)
        k_new = apply_rope(k_new, pos.sin, pos.cos)
    k_cache.index_put_(pos.rows, k_new[:, 0].to(k_cache.dtype))
    v_cache.index_put_(pos.rows, v_new[:, 0].to(v_cache.dtype))
    n_rep = h // hk
    scale = hd ** -0.5
    # scores against the whole cache; invalid positions masked by length
    q_ = q.reshape(B, hk, n_rep, hd)
    scores = torch.einsum("bgrd,bsgd->bgrs", q_, k_cache).float() * scale
    scores = scores.masked_fill(pos.masked, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", probs.to(v_cache.dtype), v_cache)
    out = out.reshape(B, 1, h, hd)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])
