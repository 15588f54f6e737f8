"""Meshes over the running process group, the production layouts, and the
fleet-identity session helper.

The port of ``repro.launch.mesh``.  Axes:

  (data=16, model=16)            -- one pod slice, 256 devices
  (pod=2, data=16, model=16)     -- two pods, 512 devices

:func:`make_mesh` builds a ``DeviceMesh`` over the process group this
process already runs in (``torch.distributed.init_process_group``), its
world size the product of the axes.  On ``cuda`` (the default) the group
must be NCCL's: the port never falls back to gloo or the CPU; on ``cpu``
it is gloo's.  The reference builds its production meshes on 256 or 512
placeholder host devices; the port cannot start that many ranks, so
:func:`make_production_mesh` returns a mesh only where the world has that
size, and :meth:`MeshLayout.production` gives the layout (names and sizes,
no process group) that ``ShardingRules`` reads.

:func:`fleet_session` is the one place launchers build their
:class:`~repro_torch.core.session.TraceSession`: it stamps the session with
:func:`~repro_torch.distributed.context.process_tags` and, when a trace
path is given, writes JSONL at the per-process
:func:`~repro_torch.distributed.context.shard_path`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["make_production_mesh", "make_mesh", "fleet_session",
           "MeshLayout", "SINGLE_POD", "MULTI_POD"]

SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)


def _names(ndim: int) -> Tuple[str, ...]:
    return ("pod", "data", "model") if ndim == 3 else ("data", "model")


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh's axis names and sizes, with no process group behind it."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @classmethod
    def of(cls, data: int, model: int, pod: int = 1) -> "MeshLayout":
        """The layout :func:`make_mesh` would build for these sizes."""
        sizes = (pod, data, model) if pod > 1 else (data, model)
        return cls(_names(len(sizes)), sizes)

    @classmethod
    def production(cls, multi_pod: bool = False) -> "MeshLayout":
        shape = MULTI_POD if multi_pod else SINGLE_POD
        return cls(_names(len(shape)), shape)


def _mesh(sizes: Tuple[int, ...],
          device: Optional[Union[str, torch.device]]) -> Any:
    from torch.distributed.device_mesh import init_device_mesh
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is available; pass "
                           "device='cpu' for a gloo mesh on the CPU")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh: no process group; call "
                           "torch.distributed.init_process_group first")
    backend = dist.get_backend()
    want = "nccl" if dev.type == "cuda" else "gloo"
    if backend != want:
        raise RuntimeError(f"make_mesh: a {dev.type} mesh needs the {want} "
                           f"backend; the process group runs {backend}")
    n = 1
    for s in sizes:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"make_mesh: a mesh of {sizes} needs {n} ranks; the "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(dev.type, sizes, mesh_dim_names=_names(len(sizes)))


def make_mesh(data: int, model: int, pod: int = 1,
              device: Optional[Union[str, torch.device]] = None) -> Any:
    """(pod x) data x model ``DeviceMesh`` over the running process group."""
    return _mesh(MeshLayout.of(data, model, pod).sizes, device)


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[Union[str, torch.device]] = None
                         ) -> Any:
    """The production mesh, where the process group has 256 (512) ranks;
    otherwise raises: ``MeshLayout.production(multi_pod)`` is the layout."""
    layout = MeshLayout.production(multi_pod)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != layout.size:
        raise ValueError(f"make_production_mesh: {layout.shape} needs "
                         f"{layout.size} ranks, this process group has "
                         f"{world}; MeshLayout.production(multi_pod="
                         f"{multi_pod}) gives the layout without ranks")
    return _mesh(layout.sizes, device)


def fleet_session(name: str, trace_path: Optional[str] = None
                  ) -> Tuple[Any, Optional[str]]:
    """Build this process's fleet-identified :class:`TraceSession`.

    Returns ``(session, shard_jsonl_path)``: the path is None without
    ``trace_path``, else the :func:`shard_path`-mangled per-process file
    (``trace.jsonl`` -> ``trace.p3.jsonl`` in a 4-process fleet) ready for
    ``python -m repro_torch.obs.aggregate`` / ``python -m
    repro_torch.obs.export``.
    """
    from ..core.session import TraceSession
    from ..distributed.context import process_tags, shard_path
    path = shard_path(trace_path) if trace_path else None
    return TraceSession(name=name, jsonl_path=path,
                        tags=process_tags()), path
