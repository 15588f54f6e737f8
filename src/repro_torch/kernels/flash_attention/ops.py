"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

Replaces ``repro.kernels.flash_attention.ops.flash_attention``.  Unlike the
TPU kernel it takes any S (the ragged tail is masked in the kernel) and K/V
with fewer heads than Q (GQA/MQA without expanding them).  bf16 inputs run
on the tensor cores (P is rounded to bf16 before P V); float32 inputs run on
the FP32 pipes, which meet the fp32 tolerance.  A CPU tensor takes the plain
version (``ref.flash_attention_ref``); a CUDA tensor launches the kernel or
raises (bf16 pointers must be 16-byte aligned, as fresh allocations are).
"""
from __future__ import annotations

import torch

from .. import _build, launches
from .ref import flash_attention_ref

__all__ = ["flash_attention", "HEAD_DIMS"]

HEAD_DIMS = (64, 128, 256)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: [B, S, H, hd]; k, v: [B, S, Hkv, hd], Hkv | H -> [B, S, H, hd]."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    if k.shape[:2] != (B, S) or k.shape[3] != hd or S < 1 or H % Hkv:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (same B, S, hd; Hkv | H; S >= 1)")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"flash_attention: q, k, v must share one type, "
                        f"float32 or bfloat16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: hd={hd} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, Hkv, hd, int(causal), hd ** -0.5,
            _build.dtype_code(q.dtype), _build.stream_ptr(q.device))
    _build.check(err, "flash_attention")
    launches["flash_attention"] += 1
    return out
