"""Plain PyTorch versions of the DMA-copy kernels (the CPU path and the
oracle).

``dma_copy_ref`` is the reference's oracle, the identity, as a fresh tensor.
``dma_copy_tiled`` moves the same ``block_rows``-row tiles the kernels move,
one ``copy_`` per tile in a Python loop: the CPU path of the wrapper, and the
plain version the kernels are held against on the card.
"""
from __future__ import annotations

import torch

__all__ = ["dma_copy_ref", "dma_copy_tiled"]


def dma_copy_ref(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def dma_copy_tiled(x: torch.Tensor, block_rows: int) -> torch.Tensor:
    """[R, C] copy, tile by tile; ``block_rows`` must divide R."""
    R = x.shape[0]
    out = torch.empty_like(x)
    for i in range(R // block_rows):
        rows = slice(i * block_rows, (i + 1) * block_rows)
        out[rows].copy_(x[rows])
    return out
