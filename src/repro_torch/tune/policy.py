"""Learned submission policies: the JSON record and its apply hooks.

The port's copy of ``repro.tune.policy``.  A :class:`Policy` is the output
of one autotuning run: the best knob values found for one (model config,
platform, device count) cell, together with the before/after objective so
the win is auditable, and the environment preset it was measured under.
Policies persist as one JSON file per cell, keyed
``<arch>__<platform>__d<device_count>.json``, in the same schema as the
reference's (a file written by one package loads in the other's
:meth:`Policy.from_dict`).

The platform is the torch device type the owner runs on, ``"cuda"`` or
``"cpu"``; the device count is ``torch.cuda.device_count()`` on ``cuda``
and 1 on the CPU.  The port's policies live in a ``torch/`` subdirectory of
the reference's directory: ``$REPRO_POLICY_DIR/torch`` (default
``results/policies/torch``), so the two packages' files never collide.  An
explicit ``policy_dir`` is used as given.

Apply hooks: ``Trainer``, ``Server`` and ``ContinuousBatchingServer`` call
:func:`load_policy_for` (with their own device) when a launch knob is left
unset (``None``), and :func:`activate_policy` makes the loaded policy
ambient so knobs without an owner object — the
:class:`~repro_torch.core.dma.HybridMover` inline/direct threshold —
resolve through :func:`resolve_knob`.  Explicit constructor arguments always
win; ``REPRO_POLICY_DISABLE=1`` turns auto-loading off entirely (in both
packages).
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Any, Dict, Optional, Tuple, Union

import torch

__all__ = [
    "KNOB_NAMES",
    "Policy",
    "default_policy_dir",
    "policy_path",
    "save_policy",
    "load_policy",
    "load_policy_for",
    "activate_policy",
    "active_policy",
    "clear_active_policy",
    "resolve_knob",
]

#: The exposed submission knobs a policy may set — the ones the paper's §7
#: says CUDA hides (DMA protocol threshold, launch batching, graph
#: granularity).
KNOB_NAMES = ("dma_threshold_bytes", "tokens_per_launch", "steps_per_launch")

ENV_DIR = "REPRO_POLICY_DIR"
ENV_DISABLE = "REPRO_POLICY_DISABLE"
DEFAULT_DIR = os.path.join("results", "policies")
#: the port's subdirectory of the (shared) policy directory
SUBDIR = "torch"


@dataclasses.dataclass
class Policy:
    """One tuned cell: knob values + the measurements that justify them."""

    arch: str
    platform: str
    device_count: int
    knobs: Dict[str, Any]
    objective: Dict[str, Any] = dataclasses.field(default_factory=dict)
    env: Dict[str, Any] = dataclasses.field(default_factory=dict)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    version: int = 1

    def knob(self, name: str, default: Any = None) -> Any:
        return self.knobs.get(name, default)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Policy":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def platform_of(device: Optional[Union[str, torch.device]] = None
                ) -> Tuple[str, int]:
    """``(platform, device_count)`` of the owner's device (``None`` means
    ``cuda``), the key its policy is stored under."""
    dev = torch.device("cuda" if device is None else device)
    return dev.type, (torch.cuda.device_count() if dev.type == "cuda" else 1)


def default_policy_dir() -> str:
    """Resolved at call time so tests/processes can redirect via env."""
    return os.path.join(os.environ.get(ENV_DIR) or DEFAULT_DIR, SUBDIR)


def policy_path(arch: str, platform: str, device_count: int,
                policy_dir: Optional[str] = None) -> str:
    d = policy_dir or default_policy_dir()
    return os.path.join(d, f"{arch}__{platform}__d{int(device_count)}.json")


def save_policy(policy: Policy, policy_dir: Optional[str] = None) -> str:
    path = policy_path(policy.arch, policy.platform, policy.device_count,
                       policy_dir)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(policy.to_dict(), f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def load_policy(arch: str, platform: Optional[str] = None,
                device_count: Optional[int] = None,
                policy_dir: Optional[str] = None,
                device: Optional[Union[str, torch.device]] = None
                ) -> Optional[Policy]:
    """Load the policy for (arch, platform, device_count), or None.

    Platform/device_count default to those of ``device`` (``None`` means
    ``cuda``; see :func:`platform_of`).  Falls back to any same-arch,
    same-platform policy (different device count) so a policy tuned on one
    host shape still provides sane defaults on another.
    """
    if os.environ.get(ENV_DISABLE):
        return None
    if platform is None or device_count is None:
        dev_platform, dev_count = platform_of(device)
        platform = platform or dev_platform
        device_count = device_count or dev_count
    path = policy_path(arch, platform, device_count, policy_dir)
    if not os.path.exists(path):
        d = policy_dir or default_policy_dir()
        relaxed = sorted(glob.glob(
            os.path.join(d, f"{arch}__{platform}__d*.json")))
        if not relaxed:
            return None
        path = relaxed[0]
    try:
        with open(path) as f:
            return Policy.from_dict(json.load(f))
    except (OSError, ValueError, TypeError):
        return None


def load_policy_for(cfg: Any, policy_dir: Optional[str] = None,
                    activate: bool = True,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Optional[Policy]:
    """Auto-apply hook: load (and activate) the policy for a model config
    on the owner's ``device``."""
    arch = getattr(cfg, "name", None)
    if not arch:
        return None
    pol = load_policy(arch, policy_dir=policy_dir, device=device)
    if pol is not None and activate:
        activate_policy(pol)
    return pol


# -- ambient policy --------------------------------------------------------
# Knobs with an owner object (Trainer.k, Server.T) read the loaded policy
# directly; the DMA threshold has no owner until a HybridMover exists, so the
# most recently loaded/saved policy is kept ambient for resolve_knob().
_active: Optional[Policy] = None


def activate_policy(policy: Optional[Policy]) -> None:
    global _active
    _active = policy


def active_policy() -> Optional[Policy]:
    return _active


def clear_active_policy() -> None:
    activate_policy(None)


def resolve_knob(name: str, default: Any) -> Any:
    """Ambient-policy knob lookup (explicit values should bypass this)."""
    if _active is None or os.environ.get(ENV_DISABLE):
        return default
    return _active.knob(name, default)
