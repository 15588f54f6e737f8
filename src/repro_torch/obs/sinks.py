"""Production sinks: never block the decode loop, never lose count.

The paper's capture guarantee is *completeness at the commit point*; at
fleet rates the naive way to keep it — synchronous file writes inside
``TraceSession.emit`` — would put disk latency on the doorbell path.  These
sinks trade completeness for boundedness **explicitly**: every event that is
not delivered downstream is *counted*, so the observability loss is itself
observable (``stats()`` rides along in BENCH artifacts and loadtest
records).

* :class:`AsyncSink` — bounded hand-off queue plus a writer thread.  The
  emitting thread only ever enqueues (or, if the queue is full, increments a
  drop counter); the writer thread forwards to the wrapped sink.  Exact
  accounting invariant: ``enqueued + dropped == offered`` always, and after
  ``close()``, ``forwarded == enqueued``.
* :class:`SamplingSink` — deterministic per-kind decimation (keep one event
  in every N of a kind), with exact per-kind counts of what was sampled
  away.  Deterministic (counter-based, not random) so replays and tests see
  identical keeps.

The port's copy of ``repro.obs.sinks`` (host code).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Mapping, Optional

from ..core.session import TraceEvent

__all__ = ["AsyncSink", "SamplingSink"]

_CLOSE = object()       # writer-thread shutdown sentinel


class AsyncSink:
    """Non-blocking wrapper: bounded queue + writer thread + drop accounting.

    ``emit`` never blocks and never touches the wrapped sink: it either
    enqueues the event or — queue full — drops it and counts the drop.  A
    single daemon writer thread drains the queue into ``inner.emit``.

    ``flush()`` waits for the queue to drain (bounded by ``timeout_s``) and
    then flushes the inner sink; ``close()`` drains, stops the writer, and
    closes the inner sink.  Both are safe to call repeatedly.
    """

    def __init__(self, inner: Any, maxsize: int = 8192,
                 name: str = "trace-writer") -> None:
        self.inner = inner
        self.maxsize = int(maxsize)
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=self.maxsize)
        self._lock = threading.Lock()       # guards the counters only
        self._offered = 0
        self._enqueued = 0
        self._dropped = 0
        self._forwarded = 0
        self._write_errors = 0
        self._closed = False
        self._thread = threading.Thread(target=self._drain, name=name,
                                        daemon=True)
        self._thread.start()

    # -- emitting thread(s) -------------------------------------------------
    def emit(self, event: TraceEvent) -> None:
        with self._lock:
            self._offered += 1
            if self._closed:
                self._dropped += 1
                return
        try:
            self._q.put_nowait(event)
        except queue.Full:
            with self._lock:
                self._dropped += 1
            return
        with self._lock:
            self._enqueued += 1

    # -- writer thread ------------------------------------------------------
    def _drain(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is _CLOSE:
                    return
                try:
                    self.inner.emit(item)
                    with self._lock:
                        self._forwarded += 1
                except Exception:
                    # a failing backend must not kill the writer thread; the
                    # failure is accounted, not raised into the decode loop
                    with self._lock:
                        self._write_errors += 1
                        self._forwarded += 1
            finally:
                self._q.task_done()

    # -- control ------------------------------------------------------------
    def flush(self, timeout_s: float = 10.0) -> bool:
        """Wait (bounded) for the queue to drain, then flush ``inner``.

        Returns True if the queue fully drained within the timeout.
        """
        deadline = threading.Event()
        waiter = threading.Thread(
            target=lambda: (self._q.join(), deadline.set()), daemon=True)
        waiter.start()
        drained = deadline.wait(timeout_s)
        flush = getattr(self.inner, "flush", None)
        if flush is not None:
            flush()
        return drained

    def close(self, timeout_s: float = 10.0) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._q.put(_CLOSE)             # after _CLOSE, emit() only drops
        self._thread.join(timeout=timeout_s)
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            s = {"sink": "AsyncSink", "maxsize": self.maxsize,
                 "offered": self._offered, "enqueued": self._enqueued,
                 "forwarded": self._forwarded, "dropped": self._dropped,
                 "write_errors": self._write_errors,
                 "pending": self._enqueued - self._forwarded}
        inner_stats = getattr(self.inner, "stats", None)
        if inner_stats is not None:
            s["inner"] = inner_stats()
        return s


class SamplingSink:
    """Deterministic per-kind decimation with exact loss accounting.

    ``every`` maps an event kind to N — keep the 1st, (N+1)th, ... event of
    that kind, sample away the rest; kinds not listed use ``default_every``
    (1 = keep everything).  ``always_names`` lists event names that bypass
    sampling entirely — barrier events default in, because dropping a
    barrier would cost :mod:`repro_torch.obs.aggregate` its clock alignment.
    """

    def __init__(self, inner: Any,
                 every: Optional[Mapping[str, int]] = None,
                 default_every: int = 1,
                 always_names: tuple = ("obs.barrier",)) -> None:
        self.inner = inner
        self.every = {k: max(1, int(n)) for k, n in dict(every or {}).items()}
        self.default_every = max(1, int(default_every))
        self.always_names = tuple(always_names)
        self._lock = threading.Lock()
        self._seen: Dict[str, int] = {}
        self._kept: Dict[str, int] = {}

    def emit(self, event: TraceEvent) -> None:
        with self._lock:
            n = self._seen.get(event.kind, 0)
            self._seen[event.kind] = n + 1
            period = self.every.get(event.kind, self.default_every)
            keep = (event.name in self.always_names) or (n % period == 0)
            if keep:
                self._kept[event.kind] = self._kept.get(event.kind, 0) + 1
        if keep:
            self.inner.emit(event)

    def flush(self) -> None:
        flush = getattr(self.inner, "flush", None)
        if flush is not None:
            flush()

    def close(self) -> None:
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            seen = dict(self._seen)
            kept = dict(self._kept)
        s = {"sink": "SamplingSink",
             "every": dict(self.every), "default_every": self.default_every,
             "seen": seen, "kept": kept,
             "sampled_away": {k: seen[k] - kept.get(k, 0) for k in seen},
             "total_sampled_away": sum(seen.values()) - sum(kept.values())}
        inner_stats = getattr(self.inner, "stats", None)
        if inner_stats is not None:
            s["inner"] = inner_stats()
        return s
