"""Plain PyTorch version of the RMSNorm kernel (the CPU path and the oracle)."""
from __future__ import annotations

import torch

__all__ = ["rms_norm_ref"]


def rms_norm_ref(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """x: [..., D]; scale: [D] (zero-init, ``(1 + scale)`` gain).

    The mean of squares is taken in fp32 and the result cast back to x's type.
    """
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)
