"""Hand-written Hopper kernels of the port.

Each kernel has a CUDA source under ``csrc/``, a wrapper (``ops.py``) that
checks its inputs and launches it on the current stream, and a plain PyTorch
version (``ref.py``).  A wrapper takes the plain version only for a tensor on
the CPU; for a CUDA tensor it launches the kernel or raises.

``launches`` counts kernel launches by name; a wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its path went
through the kernels.
"""
from __future__ import annotations

import collections

__all__ = ["launches", "reset_launches"]

launches: "collections.Counter[str]" = collections.Counter()


def reset_launches() -> None:
    launches.clear()
