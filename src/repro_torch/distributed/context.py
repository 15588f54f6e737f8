"""Process identity: which process of the fleet this is, for trace shards.

The port's copy of the process-identity helpers of
``repro.distributed.context`` (:func:`process_info`, :func:`process_tags`,
:func:`shard_path`), which fleet launchers use to tag their per-process
:class:`~repro_torch.core.session.TraceSession` so that JSONL shards
identify themselves to :mod:`repro_torch.obs.aggregate`.  The mesh context
and ``shard_map`` of that module wait for the distributed slice.

Identity comes from ``torch.distributed`` when a process group is
initialised, else this is process 0 of 1.  ``REPRO_PROCESS_ID`` /
``REPRO_PROCESS_COUNT`` override both, as in the reference, so that
processes launched side by side on one host can name their shards without
a process group.
"""
from __future__ import annotations

import os
import socket
from typing import Any, Dict

import torch.distributed as dist

__all__ = ["process_info", "process_tags", "shard_path"]


def process_info() -> Dict[str, Any]:
    """This process's place in the fleet (no process group -> 0 of 1)."""
    env_idx = os.environ.get("REPRO_PROCESS_ID")
    if env_idx is not None:
        idx = int(env_idx)
        count = int(os.environ.get("REPRO_PROCESS_COUNT", idx + 1))
    elif dist.is_available() and dist.is_initialized():
        idx, count = dist.get_rank(), dist.get_world_size()
    else:
        idx, count = 0, 1
    return {"host": socket.gethostname(), "process": int(idx),
            "process_count": int(count)}


def process_tags() -> Dict[str, Any]:
    """Session tags for this process: ``TraceSession(tags=process_tags())``.

    Every event the session emits then carries ``host``/``process`` in its
    ``meta``, the shard identity :mod:`repro_torch.obs.aggregate` merges by.
    """
    info = process_info()
    return {"host": info["host"], "process": info["process"]}


def shard_path(base: str) -> str:
    """Per-process JSONL shard path: ``trace.jsonl`` -> ``trace.p3.jsonl``.

    The identity for a single-process fleet, so single-host CLIs can use it
    unconditionally.
    """
    info = process_info()
    if info["process_count"] <= 1:
        return base
    root, ext = os.path.splitext(base)
    return f"{root}.p{info['process']}{ext or '.jsonl'}"
