"""Doorbell (dispatch) tracking: the port's copy of ``repro.core.doorbell``.

In the paper, the doorbell write is the driver's final commit point for a
submission cycle; counting doorbell writes counts submission cycles.  In the
port a doorbell is one call of a wrapped host function that submits work to
the CUDA stream: in the server, one CUDA Graph replay of the prefill or of a
T-step decode block (``core/graphs.py``), however many kernels it holds.

:class:`DoorbellTracker` owns that dispatch boundary: callables wrapped by a
tracker ring its doorbell on every call, recording the submission timestamp,
the host time to enqueue, optionally the time to complete, and the argument
payload bytes.  Every recorded cycle is also published as a ``dispatch``
event on the bound or ambient :class:`~repro_torch.core.session.TraceSession`.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .session import TraceSession, resolve_session

__all__ = ["DoorbellRecord", "DoorbellTracker", "payload_bytes"]


def payload_bytes(tree: Any) -> int:
    """Bytes of the tensor arguments in a nested structure.

    Tuples, lists and dicts are walked; a tensor or numpy array counts its
    bytes; an ``nn.Module`` counts its parameters and buffers.  ``None``
    counts nothing and any other leaf (a Python scalar) 4 bytes, as the
    reference counts a scalar leaf of a JAX pytree, so a dispatch's payload
    equals the reference's for the same ``(params, state, tokens)``.
    """
    if tree is None:
        return 0
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return int(tree.nbytes)
    if isinstance(tree, torch.nn.Module):
        return sum(payload_bytes(t) for t in
                   (*tree.parameters(), *tree.buffers()))
    if isinstance(tree, dict):
        return sum(payload_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(payload_bytes(v) for v in tree)
    return 4


@dataclasses.dataclass
class DoorbellRecord:
    """One submission cycle."""

    seq: int
    name: str
    t_submit: float            # perf_counter at dispatch
    dispatch_s: float          # time to enqueue (returns before completion)
    complete_s: float          # time to completion (if blocked)
    payload_bytes: int


class DoorbellTracker:
    """Counts and times submission cycles ("doorbell writes")."""

    def __init__(self, session: Optional[TraceSession] = None) -> None:
        self.records: List[DoorbellRecord] = []
        self._seq = 0
        self._session = session

    # -- wrapping ----------------------------------------------------------
    def wrap(self, fn: Callable, name: str = "dispatch",
             block: bool = False) -> Callable:
        """Wrap a callable so each call rings the doorbell.

        With ``block=True`` the wrapper waits for the card with
        ``torch.cuda.synchronize()`` and records the full duration;
        otherwise only the host time to enqueue is recorded — the analogue
        of the doorbell write returning while the GPU consumes the GPFIFO.
        """
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            t1 = time.perf_counter()
            complete = 0.0
            if block:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                complete = time.perf_counter() - t0
            self._record(name, t0, t1 - t0, complete,
                         payload_bytes((args, kwargs)))
            return out
        return wrapped

    def ring(self, name: str = "manual", payload: int = 0) -> None:
        """Explicitly record a submission cycle."""
        t = time.perf_counter()
        self._record(name, t, 0.0, 0.0, payload)

    def _record(self, name: str, t0: float, disp: float, comp: float,
                payload: int) -> None:
        self.records.append(DoorbellRecord(
            seq=self._seq, name=name, t_submit=t0, dispatch_s=disp,
            complete_s=comp, payload_bytes=payload))
        self._seq += 1
        sess = resolve_session(self._session)
        if sess is not None:
            sess.emit("dispatch", name, dur_s=disp, complete_s=comp,
                      payload_bytes=payload, t=t0)

    # -- accounting --------------------------------------------------------
    @property
    def count(self) -> int:
        return len(self.records)

    def summary(self) -> Dict[str, Any]:
        by_name: Dict[str, Dict[str, float]] = {}
        for r in self.records:
            d = by_name.setdefault(r.name, {"doorbells": 0, "dispatch_s": 0.0,
                                            "payload_bytes": 0})
            d["doorbells"] += 1
            d["dispatch_s"] += r.dispatch_s
            d["payload_bytes"] += r.payload_bytes
        return {"total_doorbells": self.count, "by_name": by_name}
