"""Attention: GQA/MQA with rotary, the full-sequence (prefill) path and the
KV-cache decode path.

``impl`` selects the full-sequence route, as in ``repro.models.attention``:
``"cuda"`` is the flash-attention kernel (its wrapper takes the plain version
for CPU tensors); ``"ref"`` is the dense O(S²)-memory softmax, or, for a
causal sequence longer than ``cfg.attn_chunk``, the reference's chunked
streaming softmax (:func:`chunked_causal_attention`, or
:func:`triangle_chunked_attention` with ``cfg.attn_tri``).  Decode
attention, chunk (extend) attention and the paged cache's block-table
gather and scatter have no kernel in the reference and stay plain PyTorch.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import flash_attention
from .layers import Norm, Params, apply_rope, rms_norm, rotary

__all__ = ["attention", "decode_attention", "decode_positions",
           "DecodePositions", "extend_attention", "extend_positions",
           "ExtendPositions", "gather_block_table", "scatter_block_rows",
           "init_kv_cache", "dense_causal_attention",
           "chunked_causal_attention", "triangle_chunked_attention", "IMPLS"]

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


def _online_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: Optional[torch.Tensor], acc: torch.Tensor,
                 m: torch.Tensor, l: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One kv chunk of the streaming softmax, the reference's ``kv_body``:
    q [B,c,H,hd] against k, v [B,c,H,hd]; ``mask`` [c, c] (True: keep)."""
    s = torch.einsum("bqhd,bkhd->bqhk", q, k).float() * q.shape[-1] ** -0.5
    if mask is not None:
        s = s.masked_fill(~mask[None, :, None, :],
                          torch.finfo(torch.float32).min)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bqhk,bkhd->bqhd", p.to(v.dtype), v).float()
    return acc_new, m_new, l_new


def _online_init(q: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, c, H, hd = q.shape
    f32 = torch.float32
    return (torch.zeros(B, c, H, hd, dtype=f32, device=q.device),
            torch.full((B, c, H), torch.finfo(f32).min, dtype=f32,
                       device=q.device),
            torch.zeros(B, c, H, dtype=f32, device=q.device))


def _online_out(acc: torch.Tensor, l: torch.Tensor, dtype: torch.dtype
                ) -> torch.Tensor:
    return (acc / torch.clamp(l[..., None], min=1e-30)).to(dtype)


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, chunk: int = 1024,
                             causal: bool = True) -> torch.Tensor:
    """Flash-style streaming softmax over KV chunks: O(S·chunk) memory.

    ``repro.models.attention.chunked_causal_attention``: every (q chunk, kv
    chunk) pair in order, a future chunk masked whole, so it adds nothing.
    q, k, v: [B, S, H, hd]; S not a multiple of ``chunk``, or at most one
    chunk, takes the dense path.
    """
    B, S, H, hd = q.shape
    if S % chunk or S <= chunk:
        return dense_causal_attention(q, k, v, causal)
    n = S // chunk
    pos = torch.arange(chunk, device=q.device)
    diag = pos[:, None] >= pos[None, :]
    none = torch.zeros(chunk, chunk, dtype=torch.bool, device=q.device)
    outs = []
    for qi in range(n):
        q_i = q[:, qi * chunk:(qi + 1) * chunk]
        acc, m, l = _online_init(q_i)
        for kj in range(n):
            mask = (None if not causal else
                    diag if kj == qi else none if kj > qi else None)
            acc, m, l = _online_step(q_i, k[:, kj * chunk:(kj + 1) * chunk],
                                     v[:, kj * chunk:(kj + 1) * chunk], mask,
                                     acc, m, l)
        outs.append(_online_out(acc, l, q.dtype))
    return torch.cat(outs, dim=1)


def triangle_chunked_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, chunk: int = 1024
                               ) -> torch.Tensor:
    """Causal chunked attention over only the n(n+1)/2 causal chunk pairs.

    ``repro.models.attention.triangle_chunked_attention`` folds q chunk r
    with q chunk n-1-r, so that every folded row takes n+1 kv steps; each q
    chunk still meets kv chunks 0..r in order with the diagonal masked, so
    the result is :func:`chunked_causal_attention`'s.  An odd or single
    chunk count, or S not a multiple of ``chunk``, takes that path.
    """
    B, S, H, hd = q.shape
    n = S // chunk
    if n * chunk != S or n < 2 or n % 2:
        return chunked_causal_attention(q, k, v, chunk)
    pos = torch.arange(chunk, device=q.device)
    diag = pos[:, None] >= pos[None, :]
    outs: Dict[int, torch.Tensor] = {}
    for r in range(n // 2):
        for row in (r, n - 1 - r):          # the folded pair: n+1 kv steps
            q_i = q[:, row * chunk:(row + 1) * chunk]
            acc, m, l = _online_init(q_i)
            for kj in range(row + 1):
                acc, m, l = _online_step(
                    q_i, k[:, kj * chunk:(kj + 1) * chunk],
                    v[:, kj * chunk:(kj + 1) * chunk],
                    diag if kj == row else None, acc, m, l)
            outs[row] = _online_out(acc, l, q.dtype)
    return torch.cat([outs[i] for i in range(n)], dim=1)


def attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
              positions: Optional[torch.Tensor] = None, causal: bool = True,
              impl: str = "ref", norm: Norm = rms_norm
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence attention (prefill, train). x: [B, S, D].

    Returns ``(out [B, S, D], k, v)``: k and v are [B, S, Hkv, hd] after the
    k-norm and RoPE, the entries a prefill writes into the KV cache.
    ``norm`` is the q/k norm (the train path passes
    :func:`~.layers.plain_rms_norm`).
    """
    B, S, D = x.shape
    h, hd = cfg.n_heads_padded, cfg.hd
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"]).contiguous()
    if cfg.qk_norm:
        q = norm(p["q_norm"], q)
        k = norm(p["k_norm"], k)
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
        kr, vr = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
        if causal and cfg.attn_chunk and S > cfg.attn_chunk:
            chunked = (triangle_chunked_attention if cfg.attn_tri else
                       chunked_causal_attention)
            out = chunked(q, kr, vr, cfg.attn_chunk)
        else:
            out = dense_causal_attention(q, kr, vr, causal)
    else:
        raise ValueError(f"unknown attention impl {impl!r}; expected one of "
                         f"{IMPLS}")
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), k, v


# --------------------------------------------------------------------------
# decode path
# --------------------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  dtype: torch.dtype, device: torch.device,
                  per_slot: bool = False, n_layers: Optional[int] = None
                  ) -> Dict[str, torch.Tensor]:
    """KV cache [L, B, S, Hkv, hd] + current length: a scalar int32, or
    one a sequence (``[B]``) with ``per_slot``.  ``L`` is ``n_layers``,
    default the config's."""
    L = cfg.n_layers if n_layers is None else n_layers
    shape = (L, batch, max_seq, cfg.n_kv_heads, cfg.hd)
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


class ExtendPositions(NamedTuple):
    """Where one prompt chunk writes and what it reads: the same in every
    layer, so :func:`extend_positions` computes it once a chunk."""

    rows: torch.Tensor            # [C] int64, the clamped write rows
    masked: torch.Tensor          # [C, S_max], positions past each query
    sin: Optional[torch.Tensor]   # [1, C, hd/2], rope at start + arange(C)
    cos: Optional[torch.Tensor]


def extend_positions(cfg: ModelConfig, start: torch.Tensor, chunk: int,
                     max_seq: int) -> ExtendPositions:
    """The positions of a chunk of ``chunk`` prompt tokens at global
    position ``start`` (a ``[]`` int32 tensor on the device, so that one
    graph serves every start).  The write rows start at ``start`` clamped
    to ``max_seq - chunk``, as the reference's ``dynamic_update_slice``
    clamps; the rope positions and the mask use ``start`` itself."""
    dev = start.device
    ar = torch.arange(chunk, device=dev)
    q_pos = start.long() + ar
    rows = start.long().clamp(0, max_seq - chunk) + ar
    masked = torch.arange(max_seq, device=dev)[None, :] > q_pos[:, None]
    sin = cos = None
    if cfg.pos_embed == "rope":
        sin, cos = rotary(q_pos[None, :], cfg.hd, cfg.rope_theta)
    return ExtendPositions(rows, masked, sin, cos)


def extend_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: ExtendPositions) -> torch.Tensor:
    """Prompt-chunk attention against a cache (chunked prefill).

    x: [B, C, D], C new prompt positions from ``start``; k_cache/v_cache:
    [B, S_max, Hkv, hd] holding the first ``start`` positions; ``pos`` from
    :func:`extend_positions`.  The chunk's K/V are written into the caches
    *in place* at rows [start, start+C) on device-side indices, and the
    chunk's queries attend over the whole buffer, positions past each
    query masked (they get exactly zero softmax weight).  Returns out
    [B, C, D].
    """
    B, C, D = x.shape
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
    k_cache.index_copy_(1, pos.rows, k_new.to(k_cache.dtype))
    v_cache.index_copy_(1, pos.rows, v_new.to(v_cache.dtype))
    n_rep = h // hk
    scale = hd ** -0.5
    # GQA without repeating the cache: query head g * n_rep + r reads KV
    # head g, as the reference's _repeat_kv lays them out
    q_ = q.reshape(B, C, hk, n_rep, hd)
    scores = torch.einsum("bcgrd,bsgd->bgrcs", q_, k_cache).float() * scale
    scores = scores.masked_fill(pos.masked, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrcs,bsgd->bcgrd", probs, v_cache)
    return torch.einsum("bshk,hkd->bsd", out.reshape(B, C, h, hd), p["wo"])


# --------------------------------------------------------------------------
# paged KV: block-table gather / scatter
# --------------------------------------------------------------------------
def gather_block_table(pool: torch.Tensor, table: torch.Tensor,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather pages into contiguous caches, the dense decode layout.

    pool: [L, P, page_tokens, Hkv, hd]; table: [n_blk] int32 physical page
    ids (one slot, returns [L, 1, n_blk*page_tokens, Hkv, hd]) or [B, n_blk]
    (B slots, returns [L, B, n_blk*page_tokens, Hkv, hd]).  ``out``, of the
    returned shape, receives the gather in place (a fixed buffer a CUDA
    graph reads).
    """
    L, P, pt, Hk, hd = pool.shape
    tables = table.reshape(-1, table.shape[-1])
    B, n_blk = tables.shape
    if out is None:
        out = torch.empty((L, B, n_blk * pt, Hk, hd), dtype=pool.dtype,
                          device=pool.device)
    torch.index_select(pool, 1, tables.reshape(-1).long(),
                       out=out.view(L, B * n_blk, pt, Hk, hd))
    return out


def scatter_block_rows(pool: torch.Tensor, table: torch.Tensor,
                       rows: torch.Tensor, start: torch.Tensor) -> None:
    """Write ``rows`` at logical positions start..start+n-1, in place.

    One slot: table [n_blk], rows [L, n, Hkv, hd], start [] int32; or B
    slots at once: table [B, n_blk], rows [L, B, n, Hkv, hd], start [B].
    Positions past ``S - 1`` (``S = n_blk * page_tokens``) clamp to ``S -
    1`` and the page index to ``n_blk - 1``, as the reference clamps the
    dense cache's write, so a request finishing at the KV cap behaves as in
    dense.  There the reference's loop lets the *last* row win; a scatter
    with repeated indices has no defined winner on CUDA, so the last row is
    written again after the scatter.
    """
    L, P, pt, Hk, hd = pool.shape
    if table.dim() == 1:
        table, rows, start = table[None], rows[:, None], start.reshape(1)
    B, n_blk = table.shape
    n = rows.shape[2]
    S = n_blk * pt
    pos = (start.long()[:, None]
           + torch.arange(n, device=pool.device)).clamp(max=S - 1)
    page = table.long().gather(1, (pos // pt).clamp(max=n_blk - 1))
    flat = page * pt + pos % pt                       # [B, n] pool rows
    pool_rows = pool.view(L, P * pt, Hk, hd)
    pool_rows.index_copy_(1, flat.reshape(-1),
                          rows.reshape(L, B * n, Hk, hd).to(pool.dtype))
    pool_rows.index_copy_(1, flat[:, -1], rows[:, :, -1].to(pool.dtype))
