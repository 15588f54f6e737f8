"""Wrapper of the SSD-scan kernels (``csrc/ssd_scan.cu``).

Replaces ``repro.kernels.ssd_scan.ops.ssd_scan`` and, like it, returns
``(y, None)``: the kernels do not write the final state.  A CPU tensor takes
the plain version (``ref.ssd_chunked``); a CUDA tensor launches the kernels
or raises.  One call is one ``launches["ssd_scan"]``: the five launches of
the chunked scan (``ref.ssd_chunk_states``, ``ssd_state_passing`` and
``ssd_chunk_outputs`` are their steps in plain PyTorch) go through one C
entry point.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .. import _build, launches
from .ref import ssd_chunked

__all__ = ["ssd_scan", "workspace_shapes", "MAX_P", "MAX_N", "MAX_CHUNK",
           "TILE"]

MAX_P = 64
MAX_N = 128
MAX_CHUNK = 4096
TILE = 64            # rows of q and k in the kernels' tiles (kTile)


def workspace_shapes(B: int, S: int, H: int, P: int, N: int, chunk: int
                     ) -> Dict[str, Tuple[int, ...]]:
    """The fp32 workspaces of one kernel call, in the order of the C entry
    point: cum(dt * A) and dt along S per (b, h); C B^T per (b, chunk) on
    tiles padded to TILE rows; the state at the start of each chunk after
    the first."""
    n = S // chunk
    Qp = -(-chunk // TILE) * TILE
    return {"cum": (B, H, S), "dt": (B, H, S), "cb": (B, n, Qp, Qp),
            "states": (B, H, n - 1, P, N)}


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bc: torch.Tensor, Cc: torch.Tensor, chunk: int = 128
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """xh: [B,S,H,P]; dt: [B,S,H] fp32 (post-softplus); A: [H] fp32
    (negative); Bc/Cc: [B,S,N] of xh's type.  The chunk is ``min(chunk, S)``
    and must divide S.  Returns (y [B,S,H,P] of xh's type, None)."""
    if xh.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bc.dim() != 3:
        raise ValueError(f"ssd_scan: xh {tuple(xh.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bc "
                         f"{tuple(Bc.shape)}")
    B, S, H, P = xh.shape
    N = Bc.shape[-1]
    if (dt.shape != (B, S, H) or A.shape != (H,) or Bc.shape[:2] != (B, S)
            or Cc.shape != Bc.shape or min(B, S, H, P, N) < 1):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                         f"Bc {tuple(Bc.shape)}, Cc {tuple(Cc.shape)} do not "
                         f"fit xh {tuple(xh.shape)}")
    if xh.dtype not in (torch.float32, torch.bfloat16) or not (
            Bc.dtype == Cc.dtype == xh.dtype):
        raise TypeError(f"ssd_scan: xh, Bc, Cc must share one type, float32 "
                        f"or bfloat16; got {xh.dtype}, {Bc.dtype}, {Cc.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dt and A must be float32; got {dt.dtype}, "
                        f"{A.dtype}")
    chunk = min(chunk, S)
    if chunk < 1 or S % chunk:
        raise ValueError(f"ssd_scan: sequence length {S} must be divisible "
                         f"by the chunk {chunk}")
    tensors = (xh, dt, A, Bc, Cc)
    if any(t.device != xh.device for t in tensors):
        raise ValueError("ssd_scan: inputs on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan: inputs must be contiguous")
    if xh.device.type == "cpu":
        y, _ = ssd_chunked(xh, dt, A, Bc, Cc, chunk)
        return y, None
    if xh.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {xh.device}")
    if P > MAX_P or N > MAX_N or chunk > MAX_CHUNK:
        raise ValueError(f"ssd_scan kernel: P={P}, N={N}, chunk={chunk} must "
                         f"be at most {MAX_P}, {MAX_N}, {MAX_CHUNK}")
    y = torch.empty_like(xh)
    # on the current stream, from PyTorch's caching allocator: a CUDA graph
    # can capture the call
    ws = [torch.empty(shape, dtype=torch.float32, device=xh.device)
          for shape in workspace_shapes(B, S, H, P, N, chunk).values()]
    lib = _build.library()
    with torch.cuda.device(xh.device):
        err = lib.ssd_scan_fwd(
            xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), y.data_ptr(), *(w.data_ptr() for w in ws),
            B, S, H, P, N, chunk, _build.dtype_code(xh.dtype),
            _build.stream_ptr(xh.device))
    _build.check(err, "ssd_scan")
    launches["ssd_scan"] += 1
    return y, None
