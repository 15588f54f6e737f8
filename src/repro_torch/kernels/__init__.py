"""Hand-written Hopper kernels of the port.

Each kernel has a CUDA source under ``csrc/``, a wrapper (``ops.py``) that
checks its inputs and launches it on the current stream, and a plain PyTorch
version (``ref.py``).  A wrapper takes the plain version only for a tensor on
the CPU; for a CUDA tensor it launches the kernel or raises.

``launches`` counts kernel launches by name; a wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its path went
through the kernels.  Under a CUDA Graph capture the wrappers' adds happen
once and launch nothing: ``core.graphs.CapturedStep`` takes them back and
adds them again at every replay.

A wrapper is no aten op (it launches through ctypes), so the op-level
command stream (``core.stream.record_ops``) would not see it.  Each wrapper
is therefore declared with :func:`recorded` and its cost: while a recording
is active (``recorder`` is set) a call reports one kernel entry, and the
aten ops inside it (the plain version's on the CPU, the output's allocation
on the card) are not recorded, so the stream is the same on both devices.
With no recording active a call costs one global lookup.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Any, Callable

__all__ = ["launches", "reset_launches", "KernelCost", "recorded", "recorder"]

launches: "collections.Counter[str]" = collections.Counter()

#: the active op recorder (``core.stream``), or None when nothing records
recorder: Any = None


def reset_launches() -> None:
    launches.clear()


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """What one kernel call must do, from its shapes: the operations and the
    bytes of its inputs (each read once) and outputs (each written once), by
    the formula of the kernel's bound."""

    name: str
    flops: int
    operand_bytes: int
    result_bytes: int


def recorded(cost: Callable[..., KernelCost]) -> Callable[[Callable], Callable]:
    """Declare a kernel wrapper: ``cost`` takes the wrapper's arguments."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args: Any, **kwargs: Any) -> Any:
            rec = recorder
            if rec is None:
                return fn(*args, **kwargs)
            return rec.kernel(fn, cost, args, kwargs)
        return call
    return wrap
