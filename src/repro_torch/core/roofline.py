"""Three-term roofline from captured command streams, the port's copy of
``repro.core.roofline``.

The paper's goal is performance *attribution*: split an observed duration
into the stage that actually produced it (engine execution vs submission path
vs software overhead).  The same question per step is which hardware term
bounds it: tensor-core compute, HBM traffic, or NVLink traffic.

All terms are derived from the *captured command stream* (``core.capture``:
the op-level stream of one step, per device), never measured:

    compute_s    = FLOPs_per_device     / PEAK_FLOPS
    memory_s     = HBM_bytes_per_device / HBM_BW
    collective_s = link_bytes_per_device / NVLINK_BW   (0 on one card)

:data:`H100_SXM` holds NVIDIA's published figures for one H100 SXM (data
sheet, dense rates without sparsity, at its 700 W limit): 989 TFLOP/s in
bf16, 3.35 TB/s of HBM3, 80 GiB, and NVLink at 450 GB/s each way.  A card set
below 700 W reaches less; a bound computed from these peaks says so beside
the card's power limit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

__all__ = ["HW", "H100_SXM", "RooflineReport", "analyze", "attribute",
           "adjusted", "model_flops"]


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


@dataclasses.dataclass
class RooflineReport:
    name: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    hbm_bytes_per_device: float
    ici_bytes_per_device: float
    model_flops_total: float = 0.0
    xla_flops_per_device: float = 0.0
    hw: HW = H100_SXM

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Lower-bound step time: max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def model_flops_ratio(self) -> float:
        """MODEL_FLOPS / stream FLOPs — how much recorded compute is useful."""
        total_hlo = self.flops_per_device * self.chips
        return self.model_flops_total / total_hlo if total_hlo else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / bounded step time.

        1.0 means the step runs at the compute roofline with zero redundant
        FLOPs; lower values quantify headroom in the dominant term.
        """
        if self.step_time_s <= 0:
            return 0.0
        useful_s = (self.model_flops_total / self.chips) / self.hw.peak_flops
        return useful_s / self.step_time_s

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "ici_bytes_per_device": self.ici_bytes_per_device,
            "model_flops_total": self.model_flops_total,
            "model_flops_ratio": self.model_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "xla_flops_per_device": self.xla_flops_per_device,
            "hw": self.hw.name,
        }


def attribute(captured: Any, *tags: str) -> Dict[str, float]:
    """Totals for command-stream entries whose ``op_path`` matches any tag —
    used to credit the port's kernels, whose entries carry the kernel's name
    (``"flash_attention"``, ``"ssd_scan"``) as their path."""
    flops = mem = ici = 0.0
    for e in captured.stream.entries:
        if any(t in e.op_path for t in tags):
            flops += e.flops * e.multiplier
            mem += (e.result_bytes + e.operand_bytes) * e.multiplier
            ici += e.link_bytes * e.multiplier
    return {"flops": flops, "memory_bytes": mem, "ici_bytes": ici}


def adjusted(report: RooflineReport, d_flops: float = 0.0,
             d_mem: float = 0.0, d_ici: float = 0.0,
             name: Optional[str] = None) -> RooflineReport:
    """New report with per-device deltas applied (kernel credit, modeled
    optimization).  Deltas are per-device bytes/FLOPs, may be negative."""
    flops = max(0.0, report.flops_per_device + d_flops)
    mem = max(0.0, report.hbm_bytes_per_device + d_mem)
    ici = max(0.0, report.ici_bytes_per_device + d_ici)
    return dataclasses.replace(
        report,
        name=name or report.name,
        flops_per_device=flops,
        hbm_bytes_per_device=mem,
        ici_bytes_per_device=ici,
        compute_s=flops / report.hw.peak_flops,
        memory_s=mem / report.hw.hbm_bw,
        collective_s=ici / report.hw.ici_bw)


def analyze(captured: Any, chips: int, model_flops_total: float = 0.0,
            hw: HW = H100_SXM, name: Optional[str] = None) -> RooflineReport:
    """Roofline terms for one captured stream (see ``core.capture``)."""
    flops = float(captured.flops)
    mem_b = float(captured.memory_bytes)
    ici_b = float(captured.collective_link_bytes)
    return RooflineReport(
        name=name or captured.name, chips=chips,
        compute_s=flops / hw.peak_flops,
        memory_s=mem_b / hw.hbm_bw,
        collective_s=ici_b / hw.ici_bw,
        flops_per_device=flops,
        hbm_bytes_per_device=mem_b,
        ici_bytes_per_device=ici_b,
        model_flops_total=model_flops_total,
        xla_flops_per_device=float(captured.xla_flops),
        hw=hw)
