"""Computation-environment presets for tuning runs.

The port's copy of ``repro.tune.env``, in torch and CUDA terms.  A learned
policy is only valid in the environment it was measured in — the same
lesson as the paper's careful pinning of driver/CUDA versions.  An
:class:`EnvPreset` captures the environment knobs that change submission
behaviour (CUDA environment variables such as ``CUDA_MODULE_LOADING`` or
``CUDA_DEVICE_MAX_CONNECTIONS``, the visible card count, the platform),
applies them *before* measurement, and serializes into
the policy JSON so a loader can check (or re-create) the conditions a
policy was learned under.  :func:`snapshot_env` records what was in force.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Dict, Optional, Union

import torch

__all__ = ["EnvPreset", "snapshot_env"]

PLATFORMS = ("cuda", "cpu")
#: environment variables recorded by :func:`snapshot_env`
ENV_PREFIXES = ("CUDA_", "PYTORCH_")


def _pairs(cuda_env: str) -> Dict[str, str]:
    out = {}
    for pair in cuda_env.split():
        key, sep, value = pair.partition("=")
        if not key or not sep:
            raise ValueError(f"cuda_env expects KEY=VALUE pairs, got {pair!r}")
        out[key] = value
    return out


@dataclasses.dataclass(frozen=True)
class EnvPreset:
    """Environment knobs applied before a tuning (or tuned) run.

    ``cuda_env`` and ``device_count`` only take effect if applied before
    CUDA is initialized in this process — :meth:`apply` warns otherwise
    instead of silently recording an environment that was never in force.
    """

    device_count: Optional[int] = None   # CUDA_VISIBLE_DEVICES=0,..,N-1
    cuda_env: str = ""                   # KEY=VALUE pairs, space-separated
    platform: Optional[str] = None       # cuda | cpu

    def apply(self) -> None:
        """Apply the preset; must run before the first CUDA call."""
        if self.platform is not None and self.platform not in PLATFORMS:
            raise ValueError(f"platform {self.platform!r}: expected one of "
                             f"{PLATFORMS}")
        env = _pairs(self.cuda_env)
        if self.device_count is not None:
            env["CUDA_VISIBLE_DEVICES"] = ",".join(
                str(i) for i in range(int(self.device_count)))
        if env:
            if torch.cuda.is_initialized():
                warnings.warn(
                    "EnvPreset.apply() after CUDA initialization: the CUDA "
                    "environment will not take effect for this process",
                    RuntimeWarning)
            os.environ.update(env)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EnvPreset":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def snapshot_env(device: Optional[Union[str, torch.device]] = None
                 ) -> Dict[str, Any]:
    """Record the effective environment a measurement on ``device``
    (``None`` means ``cuda``) ran under."""
    dev = torch.device("cuda" if device is None else device)
    on_card = dev.type == "cuda"
    return {
        "platform": dev.type,
        "device_count": torch.cuda.device_count() if on_card else 1,
        "device_name": (torch.cuda.get_device_name(dev) if on_card
                        else "cpu"),
        "cuda_env": {k: v for k, v in sorted(os.environ.items())
                     if k.startswith(ENV_PREFIXES)},
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }
