"""Wrapper of the DMA-copy kernels (``csrc/dma_copy.cu``).

Replaces ``repro.kernels.dma_copy.ops.dma_copy``: an [R, C] copy in tiles of
``block_rows`` rows, either ``"pipelined"`` (the hardware keeps each thread's
vector loads in flight, as BlockSpec pipelining does on the TPU) or
``"explicit"`` (one thread of each block issues Hopper bulk (TMA) copies
global→shared→global and waits on each, as the reference's hand-issued
async copies and DMA semaphores do).  A CPU tensor takes the plain tiled
version (``ref.dma_copy_tiled``); a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from .. import _build, launches
from .ref import dma_copy_tiled

__all__ = ["dma_copy", "MODES"]

MODES = ("pipelined", "explicit")


def dma_copy(x: torch.Tensor, mode: str = "pipelined",
             block_rows: int = 256) -> torch.Tensor:
    """x: [R, C] contiguous, any type -> a new [R, C] copy.

    ``block_rows`` is cut to R and must then divide R, as in the reference.
    """
    if mode not in MODES:
        raise ValueError(f"dma_copy: mode {mode!r} is not one of {MODES}")
    if x.dim() != 2:
        raise ValueError(f"dma_copy: x must be 2-D, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("dma_copy: x must be contiguous")
    R, C = x.shape
    block_rows = min(block_rows, R)
    if block_rows < 1 or R % block_rows:
        raise ValueError(f"dma_copy: {R} rows are not a multiple of "
                         f"block_rows={block_rows}")
    if x.device.type == "cpu":
        return dma_copy_tiled(x, block_rows)
    if x.device.type != "cuda":
        raise ValueError(f"dma_copy: unsupported device {x.device}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _build.library()
    fn = lib.dma_copy_explicit if mode == "explicit" else lib.dma_copy_pipelined
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), R, C, x.element_size(),
                 block_rows, _build.stream_ptr(x.device))
    _build.check(err, f"dma_copy_{mode}")
    launches[f"dma_copy_{mode}"] += 1
    return out
