"""PyTorch/CUDA port of ``repro``: dense transformer and Mamba2 serving on one
NVIDIA H100.

The port keeps the module names of the JAX package so each file has an
obvious counterpart, imports ``torch`` and numpy only, and never imports
``jax`` or anything from ``repro``.  Every entry point takes a ``device``;
it runs on ``cuda`` unless the caller asks for ``"cpu"`` (see
:func:`repro_torch.device.resolve_device`).  Hand-written Hopper kernels
live under :mod:`repro_torch.kernels`.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
