"""Learning-rate schedules: functions of the step counter, the port's copy
of ``repro.optim.schedule``.

The step may be a device tensor (the trainer's counter inside a CUDA
Graph): every branch is a ``torch.where`` on the device, never a Python
``if`` that would read it on the host.
"""
from __future__ import annotations

import math
from typing import Union

import torch

__all__ = ["linear_warmup", "cosine_schedule"]

Step = Union[int, float, torch.Tensor]


def _f32(step: Step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(step: Step, warmup: int, peak: float) -> torch.Tensor:
    s = _f32(step)
    return peak * torch.clamp(s / max(1.0, float(warmup)), max=1.0)


def cosine_schedule(step: Step, warmup: int, total: int, peak: float,
                    floor: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor * peak`` at ``total``; an fp32 0-d tensor on the step's
    device."""
    s = _f32(step)
    warm = peak * torch.clamp(s / max(1.0, float(warmup)), max=1.0)
    t = torch.clamp((s - warmup) / max(1.0, float(total - warmup)), 0, 1)
    cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup, warm, cos)
