"""Unified trace session: one submission-event timeline for the whole stack.

This is the port's copy of ``repro.core.session``.  The event schema
(:class:`TraceEvent`, span stamps, ``obs.span``/``obs.barrier`` names) is
unchanged, so the reference's ``repro.obs`` tools read the port's JSONL.  The
bound doorbell, transfer and progress facades are ported (``sess.doorbell``,
``sess.mover``, ``sess.progress``, ``sess.wrap``, ``sess.put``) and so is
the capture facade (``sess.capture``, ``sess.lower_and_compile``).

The paper's methodological core is a *single, complete* observation point —
the doorbell watchpoint — through which every submission passes exactly once.
Our reproduction previously scattered that visibility across five disjoint
primitives (capture, doorbell, DMA, graph launch, progress) that consumers
wired by hand with no shared clock or event model.  :class:`TraceSession` is
the watchpoint analogue for the PyTorch stack: every instrumented code path —
compile, dispatch, transfer, graph launch, progress fence — reports into one
session, under one monotonic sequence number and one timestamp base, so the
merged timeline interleaves events in true submission order.

Activation follows the watchpoint model too: installing a session makes it
ambient.  ``with TraceSession(...) as sess:`` publishes the session through a
:mod:`contextvars` variable; any tracker, mover, launcher, or capture created
*without* an explicit session reports to the ambient one while the block is
active (and stays silent outside it — legacy standalone behaviour is
unchanged).  Explicit injection (``DoorbellTracker(session=sess)``) is still
supported and wins over the ambient session.

Events flow to pluggable sinks.  The sink protocol is deliberately small —
``emit(event)`` is required; ``flush()``, ``close()``, and ``stats()`` are
optional (see :class:`Sink`).  Two sinks are built in:

* :class:`RingBufferSink` — bounded in-memory ring (always installed; backs
  :meth:`TraceSession.timeline`);
* :class:`JsonlSink` — append-only JSONL file for offline analysis.

Sessions may be *tagged* (``tags={"host": ..., "process": ...}``) so every
event's ``meta`` carries its origin and per-process JSONL shards can be
merged into one cross-host submission-ordered timeline.

Causal attribution rides on *spans*: ``with sess.span("request", uid=7):``
opens a nestable, contextvar-scoped span, and every event emitted under it
is stamped with the span's identity (``span_id``/``parent_span_id``/
``span_path``/``span_ids``) — each doorbell, transfer, and graph launch is
tied back to the API call that caused it.  Closing a span emits an
:data:`SPAN_EVENT` close event; :mod:`repro.obs.profile` turns those into
per-span command-attribution profiles.

:meth:`TraceSession.report` renders the Listing-1-style interleaved timeline;
:meth:`TraceSession.summary` gives JSON-serializable per-kind accounting.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import json
import threading
import time
import warnings
from typing import (Any, Callable, Dict, IO, Iterable, Iterator, List,
                    Optional, Tuple)

__all__ = [
    "EVENT_KINDS",
    "BARRIER_EVENT",
    "SPAN_EVENT",
    "TraceEvent",
    "Sink",
    "SpanFrame",
    "SpanHandle",
    "RingBufferSink",
    "JsonlSink",
    "TraceSession",
    "current_session",
    "ambient_span",
    "resolve_session",
]

#: The five submission-event kinds, mirroring the subsystems they unify:
#: ``compile`` (capture.py), ``dispatch`` (doorbell.py), ``transfer``
#: (dma.py), ``graph_launch`` (graphs.py), ``progress`` (semaphore.py).
EVENT_KINDS = ("compile", "dispatch", "transfer", "graph_launch", "progress")

#: Event name used by :meth:`TraceSession.barrier`.  Barrier events carry a
#: shared id plus a wall-clock reading in ``meta``; :mod:`repro.obs.aggregate`
#: uses them to align the per-process monotonic clocks of JSONL shards.
BARRIER_EVENT = "obs.barrier"

#: Event name emitted when a span closes (see :meth:`TraceSession.span`).
#: A span-close event records the span's start time (``t``), duration
#: (``dur_s``), identity (``span``/``span_id``/``parent_span_id``/
#: ``span_path``/``span_ids``) and any caller attributes — the causal unit
#: :mod:`repro.obs.profile` attributes command traffic to and
#: :mod:`repro.obs.export` renders as a Perfetto duration event.
SPAN_EVENT = "obs.span"


class Sink:
    """The sink protocol (documentation class — duck typing is enough).

    A sink must provide ``emit(event)``; it may provide ``flush()``,
    ``close()``, and ``stats()``.  ``emit`` is always called under the owning
    session's lock, but a sink shared across sessions (or wrapped in
    :class:`~repro.obs.AsyncSink`'s writer thread) must synchronize its own
    mutable state.  ``stats()`` returns a JSON-serializable dict and should
    include a ``"sink"`` key naming the sink type plus whatever loss
    accounting the sink keeps (``dropped``, ``sampled_away``, ...) — this is
    how observability *loss* stays observable.
    """

    def emit(self, event: "TraceEvent") -> None:  # pragma: no cover
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def stats(self) -> Dict[str, Any]:
        return {"sink": type(self).__name__}


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One submission event on the unified timeline.

    ``seq`` is unique and monotonic *across all kinds* within a session —
    the analogue of observing every doorbell write from one watchpoint.
    ``t`` is seconds since the session's timestamp base (``perf_counter``
    at session construction), so events from different subsystems are
    directly comparable.
    """

    seq: int
    kind: str                   # one of EVENT_KINDS
    name: str                   # subsystem-chosen label (e.g. "train_step")
    t: float                    # seconds since session t0
    dur_s: float = 0.0          # host time to submit/enqueue
    complete_s: float = 0.0     # host time to completion (0 if not fenced)
    payload_bytes: int = 0      # bytes riding this submission
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "seq": self.seq, "kind": self.kind, "name": self.name,
            "t": self.t, "dur_s": self.dur_s, "complete_s": self.complete_s,
            "payload_bytes": self.payload_bytes, "meta": self.meta,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TraceEvent":
        return cls(seq=int(d["seq"]), kind=d["kind"], name=d["name"],
                   t=float(d["t"]), dur_s=float(d.get("dur_s", 0.0)),
                   complete_s=float(d.get("complete_s", 0.0)),
                   payload_bytes=int(d.get("payload_bytes", 0)),
                   meta=dict(d.get("meta", {})))

    def describe(self) -> str:
        """One fixed-width timeline line (Listing-1 style)."""
        extra = ""
        if self.payload_bytes:
            extra += f" payload={self.payload_bytes}B"
        if self.complete_s:
            extra += f" complete={self.complete_s*1e6:.1f}us"
        for k in ("mode", "chain_len", "doorbells", "command_bytes",
                  "payload"):
            if k in self.meta:
                extra += f" {k}={self.meta[k]}"
        return (f"{self.seq:>6d}  {self.t*1e3:>10.3f}ms  {self.kind:<12s} "
                f"{self.name:<28s} dur={self.dur_s*1e6:>9.1f}us{extra}")


class RingBufferSink:
    """Bounded in-memory event store (drops oldest beyond ``maxlen``).

    Thread-safe: a ring shared across sessions (each serializing its own
    ``emit`` under its own lock) still counts ``n_emitted``/``dropped``
    exactly, and snapshot reads never observe a half-applied append.
    """

    def __init__(self, maxlen: int = 4096) -> None:
        self.maxlen = int(maxlen)
        self._buf: collections.deque = collections.deque(maxlen=self.maxlen)
        self._lock = threading.Lock()
        self._n_emitted = 0         # total ever seen, incl. dropped

    def emit(self, event: TraceEvent) -> None:
        with self._lock:
            self._buf.append(event)
            self._n_emitted += 1

    @property
    def n_emitted(self) -> int:
        with self._lock:
            return self._n_emitted

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._n_emitted - len(self._buf)

    def events(self) -> List[TraceEvent]:
        with self._lock:
            return list(self._buf)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def __iter__(self) -> Iterator[TraceEvent]:
        return iter(self.events())

    def close(self) -> None:  # sink protocol
        pass

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"sink": "RingBufferSink", "maxlen": self.maxlen,
                    "emitted": self._n_emitted,
                    "dropped": self._n_emitted - len(self._buf)}


class JsonlSink:
    """Append-only JSONL file sink; one event per line.

    The file is opened lazily on first emit so constructing a session with a
    ``jsonl_path`` is free until something is actually traced.  The lazy open
    and every write/flush/close run under one internal lock: a sink shared by
    several sessions (or hit from a traffic-generator thread while the decode
    loop emits) never double-opens the file or interleaves partial lines.
    """

    def __init__(self, path: str) -> None:
        self.path = str(path)
        self._fh: Optional[IO[str]] = None
        self._lock = threading.Lock()
        self._n_written = 0

    def emit(self, event: TraceEvent) -> None:
        line = json.dumps(event.to_dict()) + "\n"
        with self._lock:
            if self._fh is None:
                self._fh = open(self.path, "a")
            self._fh.write(line)
            self._n_written += 1

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"sink": "JsonlSink", "path": self.path,
                    "written": self._n_written}

    @staticmethod
    def load(path: str) -> List[TraceEvent]:
        """Read a JSONL trace back into events (round-trip helper).

        A malformed *final* line is skipped with a warning instead of
        raising: a process killed mid-write leaves a truncated last line,
        and :mod:`repro.obs.aggregate` must still merge the shards of dead
        processes.  Corruption anywhere earlier still raises — that is not
        a crash artifact but a broken file.
        """
        with open(path) as f:
            lines = f.read().splitlines()
        out: List[TraceEvent] = []
        for i, line in enumerate(lines):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(TraceEvent.from_dict(json.loads(line)))
            except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                if any(l.strip() for l in lines[i + 1:]):
                    raise
                warnings.warn(
                    f"{path}: skipping truncated trailing line "
                    f"({len(line)} chars) — partial write from a "
                    f"crashed/killed process", RuntimeWarning)
                break
        return out


_current: contextvars.ContextVar = contextvars.ContextVar(
    "repro_trace_session", default=None)


def current_session() -> Optional["TraceSession"]:
    """The ambient session installed by ``with TraceSession(...)`` (or None)."""
    return _current.get()


@dataclasses.dataclass(frozen=True)
class SpanFrame:
    """Immutable identity of one span: its place in the causal tree.

    ``ids`` is the full ancestor chain ending at this span (so the root
    request a deeply nested doorbell belongs to is recoverable from the
    stamped event alone, with no ordering assumptions); ``path`` is the
    matching ``/``-joined name chain, the aggregation key
    :class:`~repro.obs.profile.SpanProfile` reports by.
    """

    span_id: int
    parent_id: Optional[int]
    name: str
    path: str                   # "request/decode_iter"
    ids: Tuple[int, ...]        # ancestor span_ids, self last

    def stamp(self) -> Dict[str, Any]:
        """The meta keys stamped onto every event emitted under this span."""
        return {"span": self.name, "span_id": self.span_id,
                "parent_span_id": self.parent_id, "span_path": self.path,
                "span_ids": list(self.ids)}


class SpanHandle:
    """One open span; :meth:`end` emits its ``obs.span`` close event.

    Handles exist so *logical* spans that cannot be a lexical ``with``
    block — a serve request whose decode launches interleave with other
    requests' — can still be first-class spans: the owner keeps the handle,
    accumulates attribution (doorbell participations, payload bytes), and
    declares them at :meth:`end`.  Context-managed spans
    (:meth:`TraceSession.span`) are built on the same handle and close
    automatically.
    """

    def __init__(self, session: "TraceSession", frame: SpanFrame,
                 attrs: Dict[str, Any], t_start: float) -> None:
        self.session = session
        self.frame = frame
        self.attrs = dict(attrs)
        self.t_start = t_start          # absolute perf_counter reading
        self.scoped = False             # True when contextvar-installed
        self._done = False

    @property
    def span_id(self) -> int:
        return self.frame.span_id

    @property
    def name(self) -> str:
        return self.frame.name

    def end(self, **attrs: Any) -> Optional["TraceEvent"]:
        """Close the span (idempotent); extra ``attrs`` merge into — and on
        collision win over — the open-time attributes.

        Declared-attribution keys (``doorbells``, ``payload``,
        ``graph_launches``) are how an owner credits work that was shared
        with other spans (e.g. one vmapped decode launch serving many
        requests) to this span explicitly.
        """
        if self._done:
            return None
        self._done = True
        t_end = time.perf_counter()
        meta = {**self.frame.stamp(), "scoped": self.scoped,
                "thread": threading.get_ident(), **self.attrs, **attrs}
        # Stamped at *end* time: in a time-sorted merged timeline the close
        # must follow every event emitted inside the span, or consumers
        # (SpanProfile) would fold the span before crediting them.  Slice
        # start is recoverable as ``t - dur_s``.
        return self.session.emit("progress", SPAN_EVENT,
                                 dur_s=t_end - self.t_start,
                                 t=t_end, **meta)


def ambient_span(name: str, **attrs: Any):
    """Span on the ambient session — a no-op context when none is active.

    Lets library code declare causal structure unconditionally without
    forcing a session on callers.
    """
    sess = current_session()
    if sess is None:
        return contextlib.nullcontext(None)
    return sess.span(name, **attrs)


class TraceSession:
    """The single entry point for all command-stream instrumentation.

    Usage (ambient activation — instrumented paths report implicitly)::

        with TraceSession("serve", jsonl_path="trace.jsonl") as sess:
            cs = sess.capture.lower_and_compile("step", step_fn, args=(...,))
            step = sess.wrap(model.decode_step, "decode_step")
            step(params, state, tokens)             # -> dispatch event
        print(sess.report())

    Or explicit injection, no context manager required::

        sess = TraceSession("bench")
        tracker = DoorbellTracker(session=sess)

    The session owns the shared clock (``t0``), the device's place on it
    (:meth:`anchor`, :meth:`device_time`) and the monotonic sequence
    counter; :meth:`emit` is thread-safe so async checkpoint/data threads can
    report concurrently.
    """

    def __init__(self, name: str = "session",
                 sinks: Optional[Iterable[Any]] = None,
                 ring_size: int = 4096,
                 jsonl_path: Optional[str] = None,
                 tags: Optional[Dict[str, Any]] = None) -> None:
        self.name = name
        #: Origin tags merged into every emitted event's ``meta`` (explicit
        #: per-event meta wins on key collision).  Fleet launchers set
        #: ``tags=distributed.context.process_tags()`` so per-process JSONL
        #: shards identify themselves to :mod:`repro.obs.aggregate`.
        self.tags: Dict[str, Any] = dict(tags or {})
        self.t0 = time.perf_counter()
        self.t0_wall = time.time()
        # the device clock: a CUDA timing event and the perf_counter reading
        # beside it (anchor())
        self._anchor: Optional[Tuple[Any, float]] = None
        self._seq = 0
        self._span_seq = 0
        # The active span stack is contextvar-scoped: each thread (and each
        # asyncio task) sees only the spans it opened itself, so a traffic
        # thread's submits are never mis-attributed to the decode loop's
        # iteration span.  Per-instance so two sessions never share a stack.
        self._span_var: contextvars.ContextVar = contextvars.ContextVar(
            f"repro_span_{id(self)}", default=None)
        self._lock = threading.Lock()
        # Accounting accumulated at emit time, NOT derived from the ring —
        # summary() stays exact even after the bounded ring drops events.
        self._by_kind: Dict[str, int] = {}
        self._by_name: Dict[str, Dict[str, Any]] = {}
        self._kind_dur_s: Dict[str, float] = {}
        self._kind_payload: Dict[str, int] = {}
        self._total_payload = 0
        self._dispatch_s = 0.0
        self.ring = RingBufferSink(ring_size)
        self.sinks: List[Any] = [self.ring]
        if jsonl_path is not None:
            self.sinks.append(JsonlSink(jsonl_path))
        if sinks:
            self.sinks.extend(sinks)
        self._tokens: List[contextvars.Token] = []

        # Bound subsystem facades — one session drives everything.  Imported
        # lazily to avoid an import cycle (those modules import this one).
        # None of them touches the device before its first use.
        from .capture import CommandStreamCapture
        from .dma import HybridMover
        from .doorbell import DoorbellTracker
        from .semaphore import ProgressTracker
        self.capture = CommandStreamCapture(session=self)
        self.doorbell = DoorbellTracker(session=self)
        self.mover = HybridMover(session=self)
        self.progress = ProgressTracker(session=self)

    # -- activation --------------------------------------------------------
    def __enter__(self) -> "TraceSession":
        self._tokens.append(_current.set(self))
        return self

    def __exit__(self, *exc: Any) -> None:
        _current.reset(self._tokens.pop())
        if not self._tokens:            # outermost exit: flush file sinks
            self.close()

    def close(self) -> None:
        for s in list(self.sinks):
            close = getattr(s, "close", None)
            if close is not None:
                close()

    # -- sink management ----------------------------------------------------
    def add_sink(self, sink: Any) -> Any:
        """Attach a sink mid-flight (thread-safe w.r.t. concurrent emits)."""
        with self._lock:
            self.sinks = self.sinks + [sink]    # swap, never mutate in place
        return sink

    def remove_sink(self, sink: Any) -> None:
        with self._lock:
            self.sinks = [s for s in self.sinks if s is not sink]

    def flush(self) -> None:
        """Flush every sink that supports it (e.g. before aggregation)."""
        for s in list(self.sinks):
            flush = getattr(s, "flush", None)
            if flush is not None:
                flush()

    def sink_stats(self) -> List[Dict[str, Any]]:
        """Per-sink loss/throughput accounting (JSON-serializable).

        Sinks without a ``stats()`` method report just their type name, so
        the list always has one entry per installed sink.
        """
        out: List[Dict[str, Any]] = []
        for s in list(self.sinks):
            stats = getattr(s, "stats", None)
            out.append(stats() if stats is not None
                       else {"sink": type(s).__name__})
        return out

    # -- spans (causal attribution) ----------------------------------------
    def current_span(self) -> Optional[SpanFrame]:
        """The innermost span active in *this* context (or None)."""
        return self._span_var.get()

    def start_span(self, name: str, parent: Optional[SpanFrame] = None,
                   **attrs: Any) -> SpanHandle:
        """Open a span *without* installing it as ambient context.

        The returned handle must be closed with ``handle.end(**attrs)``.
        ``parent`` defaults to the caller's current ambient span, so manual
        spans still slot into the causal tree.  Use :meth:`span` for the
        common lexically-scoped case — manual handles are for spans whose
        lifetime crosses scheduler iterations (a serve request).
        """
        if parent is None:
            parent = self._span_var.get()
        with self._lock:
            sid = self._span_seq
            self._span_seq += 1
        if parent is None:
            frame = SpanFrame(span_id=sid, parent_id=None, name=name,
                              path=name, ids=(sid,))
        else:
            frame = SpanFrame(span_id=sid, parent_id=parent.span_id,
                              name=name, path=f"{parent.path}/{name}",
                              ids=parent.ids + (sid,))
        return SpanHandle(self, frame, attrs, time.perf_counter())

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[SpanHandle]:
        """Nestable causal span: every event emitted in this context (and
        thread) is stamped with the span's identity.

        ::

            with sess.span("request", uid=7):
                prefill(...)                    # dispatch -> span-stamped
                with sess.span("decode_iter"):  # nested child span
                    decode(...)

        Exiting emits the ``obs.span`` close event (``t`` = span start,
        ``dur_s`` = span wall time) carrying ``attrs``.  Contextvar scoping
        makes concurrent threads' spans invisible to each other.
        """
        handle = self.start_span(name, **attrs)
        handle.scoped = True
        token = self._span_var.set(handle.frame)
        try:
            yield handle
        finally:
            self._span_var.reset(token)
            handle.end()

    # -- the device clock --------------------------------------------------
    def anchor(self, device: Any) -> None:
        """Tie the device's clock to this session's: call right after a host
        synchronize with ``device``, so that the anchor event recorded here
        runs on an idle stream at the ``perf_counter`` reading taken beside
        it.  Re-anchoring at each sync keeps the drift between the two
        clocks to what one interval between syncs accrues.  Nothing to do
        on the CPU, whose stamps are ``perf_counter`` readings already."""
        if getattr(device, "type", device) != "cuda":
            return
        import torch
        event = (self._anchor[0] if self._anchor is not None
                 else torch.cuda.Event(enable_timing=True))
        event.record(torch.cuda.current_stream(device))
        self._anchor = (event, time.perf_counter())

    def device_time(self, stamp: Any) -> float:
        """A stamp on the ``perf_counter`` clock: a recorded CUDA timing
        event is the anchor's reading plus ``anchor.elapsed_time(stamp)``,
        and must have been recorded after the anchor and be complete; a
        float (a CPU stamp) is that reading already."""
        if isinstance(stamp, float):
            return stamp
        if self._anchor is None:
            raise RuntimeError("device_time: the device clock has no anchor; "
                               "call anchor() after a host synchronize")
        event, t = self._anchor
        return t + event.elapsed_time(stamp) / 1e3

    # -- emission ----------------------------------------------------------
    def emit(self, kind: str, name: str,
             dur_s: float = 0.0, complete_s: float = 0.0,
             payload_bytes: int = 0, t: Optional[float] = None,
             **meta: Any) -> TraceEvent:
        """Record one event; returns it with its assigned sequence number.

        ``t`` is an absolute ``perf_counter`` reading (defaults to now) and
        is rebased onto the session clock.
        """
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {kind!r}; "
                             f"expected one of {EVENT_KINDS}")
        t_abs = time.perf_counter() if t is None else t
        # Attribution stamping: tags < active span < explicit meta.  A
        # span-close event carries its *own* identity explicitly, so the
        # (by then parent) ambient frame never overwrites it.
        frame = self._span_var.get()
        if frame is not None:
            meta = {**frame.stamp(), **meta}
        if self.tags:
            meta = {**self.tags, **meta}        # explicit meta wins
        # The whole emit is one critical section: sequence assignment,
        # accounting, and sink fan-out (lazy file opens, ring pushes) must
        # not interleave across threads.
        with self._lock:
            seq = self._seq
            self._seq += 1
            ev = TraceEvent(seq=seq, kind=kind, name=name,
                            t=t_abs - self.t0, dur_s=dur_s,
                            complete_s=complete_s,
                            payload_bytes=payload_bytes, meta=meta)
            self._by_kind[kind] = self._by_kind.get(kind, 0) + 1
            self._kind_dur_s[kind] = self._kind_dur_s.get(kind, 0.0) + dur_s
            self._kind_payload[kind] = (self._kind_payload.get(kind, 0)
                                        + payload_bytes)
            d = self._by_name.setdefault(name, {"events": 0, "dur_s": 0.0,
                                                "payload_bytes": 0})
            d["events"] += 1
            d["dur_s"] += dur_s
            d["payload_bytes"] += payload_bytes
            self._total_payload += payload_bytes
            if kind == "dispatch":
                self._dispatch_s += dur_s
            for s in self.sinks:
                s.emit(ev)
        return ev

    def barrier(self, barrier_id: str, wall: Optional[float] = None
                ) -> TraceEvent:
        """Emit a clock-alignment barrier event (name ``obs.barrier``).

        Every process of a fleet emits a barrier with the *same*
        ``barrier_id`` at (approximately) the same real moment — e.g. right
        after a collective, or at mesh setup.  Each barrier records the
        process-local session clock *and* a wall-clock reading, giving
        :mod:`repro.obs.aggregate` two independent ways to solve for the
        per-shard clock offset when merging JSONL shards.
        """
        return self.emit("progress", BARRIER_EVENT,
                         barrier=str(barrier_id),
                         wall=time.time() if wall is None else wall)

    # -- convenience wrappers (delegate to bound facades) ------------------
    def wrap(self, fn: Callable, name: str = "dispatch",
             block: bool = False) -> Callable:
        """Doorbell-wrap a callable; each call lands a ``dispatch`` event."""
        return self.doorbell.wrap(fn, name=name, block=block)

    def lower_and_compile(self, name: str, fn: Callable, **kw: Any):
        """Capture a submission unit through the bound capture facade."""
        return self.capture.lower_and_compile(name, fn, **kw)

    def put(self, x: Any):
        """Move data through the bound :class:`HybridMover`."""
        return self.mover.put(x)

    # -- querying ----------------------------------------------------------
    @property
    def n_events(self) -> int:
        return self.ring.n_emitted

    def timeline(self, kinds: Optional[Iterable[str]] = None,
                 name: Optional[str] = None) -> List[TraceEvent]:
        """Events in submission order (monotonic ``seq``), optionally
        filtered by kind(s) and/or name."""
        evs = self.ring.events()
        if kinds is not None:
            ks = {kinds} if isinstance(kinds, str) else set(kinds)
            evs = [e for e in evs if e.kind in ks]
        if name is not None:
            evs = [e for e in evs if e.name == name]
        return sorted(evs, key=lambda e: e.seq)

    def summary(self) -> Dict[str, Any]:
        """JSON-serializable per-kind/per-name accounting.

        Counts come from emit-time accumulators (exact over the whole run);
        only ``timeline()`` is bounded by the ring.  ``total_dispatch_s``
        sums host dispatch time over ``dispatch`` events only — compile and
        transfer durations live under their names in ``by_name``.

        The schema is fixed whether or not anything was traced.  Keys:
        ``session`` (name), ``events`` (total emitted), ``dropped`` (ring
        overflow), ``by_kind`` / ``dur_s_by_kind`` / ``payload_by_kind``
        (per-kind counts / host seconds / payload bytes), ``by_name``
        (per-label ``{events, dur_s, payload_bytes}``),
        ``total_payload_bytes``, ``total_dispatch_s``, and ``wall_s``.  An
        *empty* session returns this exact shape zeroed — per-kind maps
        carry every kind in :data:`EVENT_KINDS` at 0 — so downstream
        consumers (live endpoints, BENCH artifacts, aggregation) never
        special-case "nothing happened yet".
        """
        with self._lock:
            n = self._seq
            by_kind = dict(self._by_kind)
            by_name = {k: dict(v) for k, v in self._by_name.items()}
            kind_dur = dict(self._kind_dur_s)
            kind_payload = dict(self._kind_payload)
            payload = self._total_payload
            dispatch_s = self._dispatch_s
        if n == 0:
            by_kind = {k: 0 for k in EVENT_KINDS}
            kind_dur = {k: 0.0 for k in EVENT_KINDS}
            kind_payload = {k: 0 for k in EVENT_KINDS}
        return {
            "session": self.name,
            "events": self.ring.n_emitted,
            "dropped": self.ring.dropped,
            "by_kind": by_kind,
            "dur_s_by_kind": kind_dur,
            "payload_by_kind": kind_payload,
            "by_name": by_name,
            "total_payload_bytes": payload,
            "total_dispatch_s": dispatch_s,
            "wall_s": time.perf_counter() - self.t0,
        }

    def report(self, max_events: int = 60,
               kinds: Optional[Iterable[str]] = None) -> str:
        """Listing-1-style interleaved timeline: every subsystem's events in
        one submission-ordered view."""
        evs = self.timeline(kinds=kinds)
        s = self.summary()
        lines = [f"==== TRACE SESSION {self.name} ===="]
        lines.append("  ".join(f"{k}={v}" for k, v in s["by_kind"].items())
                     or "  (no events)")
        lines.append(f"events={s['events']} dropped={s['dropped']} "
                     f"payload={s['total_payload_bytes']}B "
                     f"wall={s['wall_s']:.3f}s")
        lines.append(f"{'seq':>6s}  {'t':>12s}  {'kind':<12s} "
                     f"{'name':<28s} host-cost")
        for e in evs[:max_events]:
            lines.append(e.describe())
        if len(evs) > max_events:
            lines.append(f"  ... {len(evs) - max_events} more")
        lines.append(f"==== END TRACE SESSION {self.name} ====")
        return "\n".join(lines)


def resolve_session(explicit: Optional[TraceSession]) -> Optional[TraceSession]:
    """Explicit injection wins; otherwise fall back to the ambient session.

    Instrumented primitives call this *at emission time* so a tracker built
    before ``with TraceSession(...)`` still reports while the block is
    active — the watchpoint sees everything, whenever it was armed.
    """
    return explicit if explicit is not None else current_session()
