"""Progress trackers — the memory semaphore: the port's copy of
``repro.core.semaphore``.

The paper (§4.3) describes NVIDIA's *memory semaphore*: the driver appends a
semaphore-release command (target address + payload) after a submitted
sequence; the payload appearing at the address proves everything before it
completed, and an optional timestamp gives device-side timing.  The paper's
controlled DMA benchmark (§6.2) brackets a command sequence between two
releases and subtracts their timestamps.

On CUDA both halves exist as such.  :meth:`ProgressTracker.release` enqueues
a fence, an int32 payload computed from the data of the tensor it is tied to,
on that tensor's stream, and records a timing ``torch.cuda.Event`` right
after it: the semaphore release and its timestamp.  :meth:`~ProgressTracker.wait`
reads the fence back (which waits for everything enqueued before it), checks
the payload and records the host time.  :meth:`~ProgressTracker.elapsed`
between two releases is the device-side time between their events
(``cudaEventElapsedTime``).  For a release tied to CPU tensors there is no
device clock, and ``elapsed`` is the host time from one completion to the
other, as in the reference.  :class:`Heartbeat` builds the fault-tolerance
liveness signal on top.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .session import TraceSession, resolve_session

__all__ = ["SemaphoreToken", "ProgressTracker", "Heartbeat"]


@dataclasses.dataclass
class SemaphoreToken:
    """One semaphore release: (payload, fence tensor, timestamps).

    ``event`` is the CUDA event recorded right after the fence on the fence's
    stream, or ``None`` when the fence lies on the CPU.
    """

    payload: int
    fence: torch.Tensor        # the int32 tensor acting as the semaphore
    t_release: float           # host time when the release was submitted
    t_complete: Optional[float] = None
    event: Optional[torch.cuda.Event] = None

    @property
    def completed(self) -> bool:
        return self.t_complete is not None


def _first_leaf(tree: Any) -> Optional[torch.Tensor]:
    """The first tensor (or numpy array, as a tensor) in a nested structure."""
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for v in tree:
            leaf = _first_leaf(v)
            if leaf is not None:
                return leaf
    return None


class ProgressTracker:
    """Semaphore release/wait protocol over tensors on their streams."""

    def __init__(self, session: Optional[TraceSession] = None) -> None:
        self._next_payload = 1
        self.tokens: List[SemaphoreToken] = []
        self._session = session

    def release(self, tied_to: Any) -> SemaphoreToken:
        """Append a release after ``tied_to`` (nested tensors).

        The fence value is data-dependent on the first tensor of ``tied_to``
        so its readiness implies completion of everything that produced it —
        the same in-order guarantee the hardware semaphore gives within a
        channel.  On CUDA the fence and the timing event go on the current
        stream of that tensor's device.
        """
        payload = self._next_payload
        self._next_payload += 1
        x = _first_leaf(tied_to)
        if x is not None:
            zero = ((x.reshape(-1)[0] * 0).to(torch.int32) if x.numel()
                    else torch.zeros((), dtype=torch.int32, device=x.device))
            fence = zero + payload
        else:
            fence = torch.tensor(payload, dtype=torch.int32)
        event = None
        if fence.device.type == "cuda":
            event = torch.cuda.Event(enable_timing=True)
            event.record(torch.cuda.current_stream(fence.device))
        tok = SemaphoreToken(payload=payload, fence=fence,
                             t_release=time.perf_counter(), event=event)
        self.tokens.append(tok)
        sess = resolve_session(self._session)
        if sess is not None:
            sess.emit("progress", "release", t=tok.t_release, payload=payload)
        return tok

    def wait(self, token: SemaphoreToken) -> float:
        """Block until the semaphore value lands; record its timestamp."""
        val = int(token.fence.item())
        if val != token.payload:
            raise RuntimeError(
                f"semaphore payload mismatch: expected {token.payload}, "
                f"observed {val}")
        token.t_complete = time.perf_counter()
        sess = resolve_session(self._session)
        if sess is not None:
            sess.emit("progress", "wait", t=token.t_complete,
                      complete_s=token.t_complete - token.t_release,
                      payload=token.payload)
        return token.t_complete

    def elapsed(self, a: SemaphoreToken, b: SemaphoreToken) -> float:
        """Seconds between two releases.

        When both fences lie on the card this is the device time between the
        two releases' CUDA events (the semaphore-timestamp bracket of the
        paper's controlled DMA benchmark); otherwise it is the host time from
        one completion to the other, as the reference measures it.
        """
        if not a.completed:
            self.wait(a)
        if not b.completed:
            self.wait(b)
        if a.event is not None and b.event is not None:
            return abs(a.event.elapsed_time(b.event)) / 1e3
        return abs(b.t_complete - a.t_complete)


class Heartbeat:
    """Liveness/straggler signal built on progress completions.

    Each worker (host, or simulated worker) beats when its step's progress
    tracker completes; ``stragglers()`` flags workers whose most recent beat
    lags the median by more than ``factor``× the median inter-beat interval.
    """

    def __init__(self, n_workers: int, factor: float = 3.0) -> None:
        self.n_workers = int(n_workers)
        self.factor = float(factor)
        self.last_beat: Dict[int, float] = {}
        self.intervals: Dict[int, List[float]] = {i: [] for i in range(n_workers)}

    def beat(self, worker: int, t: Optional[float] = None) -> None:
        t = time.perf_counter() if t is None else t
        prev = self.last_beat.get(worker)
        if prev is not None:
            self.intervals[worker].append(t - prev)
        self.last_beat[worker] = t

    def _median_interval(self) -> float:
        allint = sorted(x for xs in self.intervals.values() for x in xs)
        if not allint:
            return 0.0
        return allint[len(allint) // 2]

    def stragglers(self, now: Optional[float] = None) -> List[int]:
        now = time.perf_counter() if now is None else now
        med = self._median_interval()
        if med <= 0:
            return []
        out = []
        for w in range(self.n_workers):
            last = self.last_beat.get(w)
            if last is None or (now - last) > self.factor * med:
                out.append(w)
        return out

    def dead(self, timeout_s: float, now: Optional[float] = None) -> List[int]:
        now = time.perf_counter() if now is None else now
        return [w for w in range(self.n_workers)
                if self.last_beat.get(w) is None
                or (now - self.last_beat[w]) > timeout_s]
