"""Wrapper of the DMA-copy kernels (``csrc/dma_copy.cu``).

Replaces ``repro.kernels.dma_copy.ops.dma_copy``: an [R, C] copy in tiles of
``block_rows`` rows, either ``"pipelined"`` (the hardware keeps each thread's
vector loads in flight, as BlockSpec pipelining does on the TPU; each tile is
cut into ``SLICE_BYTES`` slices, one block a slice, ``pipelined_split``) or
``"explicit"`` (one thread of each block issues Hopper bulk (TMA) copies
global→shared→global through a ring of four 32 KiB pieces, each load
waited on its stage's mbarrier and each store issued as a bulk group, as
the reference's hand-issued async copies and DMA semaphores do).  A CPU tensor takes the plain tiled
version (``ref.dma_copy_tiled``); a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from .. import KernelCost, _build, launches, recorded
from .ref import dma_copy_tiled

__all__ = ["dma_copy", "dma_copy_cost", "MODES", "SLICE_BYTES",
           "pipelined_split", "occupancy"]

MODES = ("pipelined", "explicit")
# bytes a block of the pipelined copy moves: one pass of its 256 threads,
# four 16-byte loads each (csrc/dma_copy.cu); a multiple of 16
SLICE_BYTES = 16 * 1024


def pipelined_split(tile_bytes: int) -> List[Tuple[int, int]]:
    """The byte ranges [begin, end) of a tile that the pipelined kernel's
    blocks copy, in block order: slice j begins at ``j * SLICE_BYTES``, and
    the last one ends at the tile's end."""
    return [(b, min(b + SLICE_BYTES, tile_bytes))
            for b in range(0, tile_bytes, SLICE_BYTES)]


def dma_copy_cost(x: torch.Tensor, mode: str = "pipelined",
                  block_rows: int = 256) -> KernelCost:
    """x read once and its copy written once; no operation."""
    nbytes = x.numel() * x.element_size()
    return KernelCost(f"dma_copy_{mode}", 0, nbytes, nbytes)


@recorded(dma_copy_cost)
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
    args = [x.data_ptr(), out.data_ptr(), R, C, x.element_size(), block_rows]
    if mode == "explicit":
        fn = lib.dma_copy_explicit
    else:
        fn = lib.dma_copy_pipelined
        args.append(SLICE_BYTES)
    with torch.cuda.device(x.device):
        err = fn(*args, _build.stream_ptr(x.device))
    _build.check(err, f"dma_copy_{mode}")
    launches[f"dma_copy_{mode}"] += 1
    return out


def occupancy(x: torch.Tensor, mode: str, block_rows: int) -> Tuple[int, int]:
    """(blocks in the grid, blocks one SM holds at once) of the ``mode`` copy
    of the CUDA tensor ``x`` in tiles of ``block_rows`` rows."""
    R, C = x.shape
    grid, per_sm = ctypes.c_longlong(), ctypes.c_int()
    with torch.cuda.device(x.device):
        err = _build.library().dma_copy_occupancy(
            MODES.index(mode), R, C, x.element_size(), min(block_rows, R),
            SLICE_BYTES, ctypes.byref(grid), ctypes.byref(per_sm))
    _build.check(err, f"dma_copy_{mode} occupancy")
    return grid.value, per_sm.value
