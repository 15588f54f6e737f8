"""Device resolution for every entry point of the port.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Without a CUDA device and without an explicit ``"cpu"`` they raise: the
port never quietly continues on the CPU.

Resolving a device also turns TF32 off for matrix products and cuDNN
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``), so a float32 model on the card
computes its products in full float32, as the JAX reference does on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "wait"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def wait(device: torch.device) -> None:
    """Wait for the work queued on ``device``'s current stream (nothing to
    wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
