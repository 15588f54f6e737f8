"""Hardware peaks for roofline bounds: the port's copy of ``HW`` and
``model_flops`` from ``repro.core.roofline``.

Only the hardware model and the useful-FLOP count are ported here.  The
reference's ``RooflineReport``, ``analyze``, ``attribute`` and ``adjusted``
read a captured command stream, which the port does not capture yet.

:data:`H100_SXM` holds NVIDIA's published figures for one H100 SXM (data
sheet, dense rates without sparsity, at its 700 W limit): 989 TFLOP/s in
bf16, 3.35 TB/s of HBM3, 80 GiB, and NVLink at 450 GB/s each way.  A card set
below 700 W reaches less; a bound computed from these peaks says so beside
the card's power limit.
"""
from __future__ import annotations

import dataclasses

__all__ = ["HW", "H100_SXM", "model_flops"]


@dataclasses.dataclass(frozen=True)
class HW:
    name: str
    peak_flops: float          # per chip, bf16
    hbm_bw: float              # bytes/s per chip
    ici_bw: float              # bytes/s per link (NVLink, each way)
    hbm_bytes: float           # capacity per chip


H100_SXM = HW(name="h100_sxm", peak_flops=989e12, hbm_bw=3.35e12,
              ici_bw=450e9, hbm_bytes=80 * 2**30)


def model_flops(n_params_active: float, tokens: float,
                mode: str = "train") -> float:
    """Useful model FLOPs: 6·N·D for training, 2·N·D for inference."""
    k = 6.0 if mode == "train" else 2.0
    return k * n_params_active * tokens
