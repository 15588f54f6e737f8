"""Wrapper of the RMSNorm kernel (``csrc/rms_norm.cu``).

Replaces ``repro.kernels.rms_norm.ops.rms_norm_fused``.  A CPU tensor takes
the plain version (``ref.rms_norm_ref``); a ``meta`` tensor gets an empty
output of its shape, launching nothing (a recording then holds the
kernel's entry); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from .. import KernelCost, _build, launches, recorded
from .ref import rms_norm_ref

__all__ = ["rms_norm", "rms_norm_cost", "MAX_D"]

MAX_D = 16384


def rms_norm_cost(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> KernelCost:
    """x and scale read, the output written; no operation is counted (the
    bound is the bytes)."""
    nbytes = x.numel() * x.element_size()
    return KernelCost("rms_norm", 0, nbytes + scale.numel() * x.element_size(),
                      nbytes)


@recorded(rms_norm_cost)
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x: [..., D] contiguous; scale: [D] of x's type -> [..., D]."""
    D = x.shape[-1] if x.dim() else 0
    if D == 0 or scale.shape != (D,):
        raise ValueError(f"rms_norm: scale {tuple(scale.shape)} does not "
                         f"match x {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or scale.dtype != x.dtype:
        raise TypeError(f"rms_norm: x {x.dtype} and scale {scale.dtype} must "
                        f"be one type, float32 or bfloat16")
    if x.device != scale.device:
        raise ValueError(f"rms_norm: x on {x.device}, scale on {scale.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rms_norm: x and scale must be contiguous")
    if x.device.type == "cpu":
        return rms_norm_ref(x, scale, eps)
    if x.device.type == "meta":           # shapes only: nothing to launch
        return torch.empty_like(x)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: unsupported device {x.device}")
    vec = 16 // x.element_size()          # elements per 16-byte vector
    if D % vec or not 0 < D <= MAX_D:
        raise ValueError(f"rms_norm kernel: D={D} must be a multiple of {vec} "
                         f"and at most {MAX_D}")
    if x.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("rms_norm kernel: x and scale must be 16-byte aligned")
    out = torch.empty_like(x)
    rows = x.numel() // D
    if rows == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.rms_norm_fwd(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                               rows, D, eps, _build.dtype_code(x.dtype),
                               _build.stream_ptr(x.device))
    _build.check(err, "rms_norm")
    launches["rms_norm"] += 1
    return out
