"""Plain PyTorch version of the flash-attention kernel (CPU path and oracle)."""
from __future__ import annotations

import torch

__all__ = ["flash_attention_ref"]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q: [B, S, H, hd]; k, v: [B, S, Hkv, hd] with Hkv dividing H.

    Query head h reads K/V head ``h // (H // Hkv)``.  Everything is computed
    in fp32, as the kernel does, and the output is cast to q's type.
    """
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * hd ** -0.5
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
