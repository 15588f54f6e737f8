"""The traced slice of a ``--trace 1`` run: torch.profiler over a steady part
of the window, read back launch by launch.

The slice opens between two scheduler iterations once ``start_s`` of the
window have passed, and closes between two iterations once it is at least
``min_s`` long and has seen ``min_prefills`` prefills (or at the window's
close); with ``from_end_s`` it is the window's last ``from_end_s`` seconds,
so that the tracer's stop, which takes seconds, falls after the close.  The
tracer is started once in the set-up (:meth:`Slice.prepare`), and the trace
is read after the window.  While it is open every ``torch.cuda.CUDAGraph.replay`` is logged in
order; the profiler's graph launches, in order, are those replays, and each
device record carries its launch's correlation id, so every kernel is
attributed to the graph (a prefill of a length, or the decode) that ran it.

The tracer drops the first device records of a window, so each opens with
64 spin kernels that take that loss; CUPTI's buffers are flushed before it
closes.  The slice's own span (``bench.slice``, a ``record_function``)
gives its bounds on the trace's clock, and the offset between that clock
and ``perf_counter``, by which idle gaps are named after the host span
they fall in.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import re
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["Slice", "Traced"]

SENTINELS, SENTINEL = 64, "spin_kernel"     # torch.cuda._sleep's kernel
MARGIN_S = 0.05
SLICE = "bench.slice"
GRAPH_LAUNCH = re.compile(r"^cu(da)?GraphLaunch")


def _cupti_flush() -> None:
    """Hand every CUPTI activity buffer to the profiler now (forced)."""
    with open("/proc/self/maps") as maps:
        paths = sorted({ln.split()[-1] for ln in maps if "libcupti" in ln})
    if paths:
        ctypes.CDLL(paths[0]).cuptiActivityFlushAll(ctypes.c_uint32(1))


@dataclasses.dataclass
class Traced:
    """What the slice read."""

    window_s: float
    busy_s: float
    launches: List[Tuple[str, float]]      # (graph name, device s) in order
    kernels: List[List[Tuple[str, float]]]  # each launch's (kernel, s)
    steps: List[Any]            # the window's steps inside the slice
    ops: List[Tuple[str, float]]           # device time by op name
    gaps: List[Tuple[float, float]]        # device idle, perf_counter clock
    matched: bool               # graph launches == logged replays


class Slice:
    """Opens and closes the profiler from the window's ``on_tick``."""

    def __init__(self, engine: Any, start_s: float = 0.0, min_s: float = 0.0,
                 min_prefills: int = 0, from_end_s: float = 0.0) -> None:
        self.engine = engine
        self.start_s, self.min_s = start_s, min_s
        self.min_prefills = min_prefills
        self.from_end_s = from_end_s
        self.log: List[Any] = []
        self.state = "before"
        self.prof: Any = None
        self.rf: Any = None
        self.step0 = self.step1 = 0
        self.t0 = self.t1 = 0.0
        self.result: Optional[Traced] = None
        self._replay: Any = None
        self.diag = ""

    # -- driven by the window ---------------------------------------------
    def prepare(self) -> None:
        """A profiler window over a few kernels in the set-up, so that the
        tracer's first start (seconds) does not fall in the window."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            for _ in range(SENTINELS):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()

    def tick(self, now: float, window: Any) -> None:
        start = (window.t_close - self.from_end_s if self.from_end_s
                 else window.t_open + self.start_s)
        if self.state == "before" and start <= now < window.t_close:
            self._open(window)
        elif self.state == "open":
            steps = window.steps[self.step0:]
            prefills = sum(len(s.prefills) for s in steps)
            if now >= window.t_close or (
                    not self.from_end_s and now - self.t0 >= self.min_s
                    and prefills >= self.min_prefills):
                self._close(window)

    def finish(self, window: Any) -> None:
        """Close the slice if the window left it open, and read it."""
        if self.state == "open":
            self._close(window)
        if self.state == "closed" and self.result is None:
            self.result = self._read(window.steps[self.step0:self.step1])

    def _open(self, window: Any) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        log, replay = self.log, torch.cuda.CUDAGraph.replay
        self._replay = replay
        torch.cuda.CUDAGraph.replay = lambda g: (log.append(g), replay(g))[1]
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        time.sleep(MARGIN_S)
        for _ in range(SENTINELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        self.rf = torch.profiler.record_function(SLICE)
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        self.step0 = len(window.steps)
        self.state = "open"

    def _close(self, window: Any) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.rf.__exit__(None, None, None)
        _cupti_flush()
        time.sleep(MARGIN_S)
        self.prof.__exit__(None, None, None)
        torch.cuda.CUDAGraph.replay = self._replay
        self.state = "closed"
        self.step1 = len(window.steps)

    # -- reading ------------------------------------------------------------
    def _read(self, steps: List[Any]) -> Traced:
        names = {id(g.graph): n for n, g in self.engine.graphs().items()
                 if g is not None and g.graph is not None}
        cuda = torch.autograd.DeviceType.CUDA
        events = list(self.prof.profiler.kineto_results.events())
        dev, host, spans = [], [], []
        for e in events:
            if e.name() == SLICE:
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                              e.device_type() == cuda))
                continue
            (dev if e.device_type() == cuda else host).append(e)
        dev = [e for e in dev if SENTINEL not in e.name()]
        if not spans:
            raise RuntimeError("the profiler recorded no bench.slice span")
        # the host's span (the GPU's copy of the annotation, where the
        # tracer gives one, covers only the kernels launched in it)
        host_spans = [sp for sp in spans if not sp[2]] or spans
        span_ns = max(host_spans, key=lambda sp: sp[1] - sp[0])[:2]
        self.diag = (f"traced slice: {len(spans)} bench.slice events "
                     f"{[(round((b - a) / 1e9, 6), c) for a, b, c in spans]}"
                     f", host {self.t1 - self.t0:.6f} s, {len(dev)} device "
                     f"records, {len(self.log)} replays logged")
        lo, hi = span_ns
        offset_ns = lo - self.t0 * 1e9
        graphs = [e.correlation_id() for e in
                  sorted(host, key=lambda e: e.start_ns())
                  if GRAPH_LAUNCH.match(e.name()) and lo <= e.start_ns() <= hi]
        matched = len(graphs) == len(self.log)
        under: Dict[int, List[Tuple[str, float]]] = collections.defaultdict(
            list)
        ops: Dict[str, float] = collections.Counter()
        intervals = []
        for e in dev:
            a = max(e.start_ns(), lo)
            b = min(e.start_ns() + e.duration_ns(), hi)
            if b <= a:
                continue
            intervals.append((a, b))
            under[e.correlation_id()].append((e.name(), e.duration_ns() / 1e9))
            ops[e.name()] += (b - a) / 1e9
        busy_ns, gaps = 0, []
        cur_a = cur_b = None
        last = lo
        for a, b in sorted(intervals):
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    busy_ns += cur_b - cur_a
                if a > last:
                    gaps.append(((last - offset_ns) / 1e9,
                                 (a - offset_ns) / 1e9))
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
            last = cur_b
        if cur_b is not None:
            busy_ns += cur_b - cur_a
        if hi > last:
            gaps.append(((last - offset_ns) / 1e9, (hi - offset_ns) / 1e9))
        launches: List[Tuple[str, float]] = []
        kernels: List[List[Tuple[str, float]]] = []
        if matched:
            for g, corr in zip(self.log, graphs):
                recs = under.get(corr, [])
                launches.append((names.get(id(g), "?"),
                                 sum(s for _, s in recs)))
                kernels.append(recs)
        return Traced(window_s=(hi - lo) / 1e9, busy_s=busy_ns / 1e9,
                      launches=launches,
                      kernels=kernels, steps=steps,
                      ops=sorted(ops.items(), key=lambda kv: -kv[1]),
                      gaps=gaps, matched=matched)


def label_gaps(traced: Traced, spans: Sequence[Tuple[str, float, float]],
               sleeps: Sequence[Tuple[float, float]], top: int = 10
               ) -> List[List[Any]]:
    """The device's idle time in the slice by what the host was doing in
    the middle of each gap: a program span (``serve.prefill``,
    ``serve.decode_iter``: gaps between a graph's nodes and the harvest),
    the benchmark waiting for an arrival (``bench.wait_for_arrival``), or
    else the engine's step outside those spans (admission, scheduling);
    the largest totals first."""
    marks = [(a, b, n) for n, a, b in spans] + [
        (a, b, "bench.wait_for_arrival") for a, b in sleeps]
    total: Dict[str, float] = collections.Counter()
    for a, b in traced.gaps:
        mid = (a + b) / 2
        inside = [n for s, e, n in marks if s <= mid <= e]
        total[inside[-1] if inside else
              "engine.step (admission, scheduling, harvest)"] += b - a
    return [[n, s] for n, s in sorted(total.items(),
                                      key=lambda kv: -kv[1])[:top]]
