"""Span-based command attribution: from "what happened" to "why".

The paper's command-stream timeline answers *what* the driver submitted;
performance attribution needs *why* — which request, decode iteration, or
train step caused each doorbell ring, DMA, and graph launch.  Spans
(:meth:`~repro_torch.core.session.TraceSession.span`) stamp that causality onto
every event; this module rolls the stamped timeline up into a
:class:`SpanProfile` — per-span-name command attribution (doorbells,
payload bytes, graph launches, host dispatch time, wall time) with
**streaming log-bucketed histograms** so p50/p90/p99 are available without
ever storing raw samples (the PyGraph/Arafa-style low-overhead
characterization layer).

Two consumption modes, one accumulator:

* **live** — install a :class:`SpanProfile` as a session sink; it folds
  every event in as it is emitted (thread-safe), and :meth:`snapshot`
  answers mid-run;
* **post-mortem** — :meth:`SpanProfile.from_events` over any event list: a
  session ring, a JSONL shard, or the cross-host output of
  :func:`repro_torch.obs.aggregate.aggregate` (span ids are deduplicated per
  shard, so merged fleets profile correctly).

Attribution semantics: an event stamped with span chain ``a -> a/b`` is
credited to *both* paths (roll-up), so a request span sees the doorbells of
its nested decode-iteration spans.  Work shared across spans — one vmapped
decode launch serving many requests — cannot be stamped exclusively; owners
declare each span's share at close time instead
(``handle.end(doorbells=.., payload=..)``), and :class:`SpanProfile` adds
declared attribution on top of stamped attribution.

The port's copy of ``repro.obs.profile`` (host code).
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ..core.session import SPAN_EVENT, TraceEvent

__all__ = ["LogHistogram", "SpanProfile"]

#: default bucket growth factor: representative values are off by at most
#: ``sqrt(growth) - 1`` (~7%) from the true nearest-rank percentile
DEFAULT_GROWTH = 1.15


class LogHistogram:
    """Streaming log-bucketed histogram: percentiles without raw samples.

    Positive values land in geometric buckets ``[growth^i, growth^(i+1))``;
    non-positive values share one exact "zero" bucket.  Memory is O(number
    of occupied buckets) — bounded by the dynamic range, not the sample
    count — so a decode loop can feed one per span name forever.

    :meth:`percentile` returns the geometric midpoint of the bucket holding
    the nearest-rank sample, clamped into the exact observed ``[min, max]``:
    the relative error is at most ``sqrt(growth) - 1``.
    """

    __slots__ = ("growth", "_log_g", "_counts", "_zero", "n", "total",
                 "_min", "_max")

    def __init__(self, growth: float = DEFAULT_GROWTH) -> None:
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        self.growth = float(growth)
        self._log_g = math.log(self.growth)
        self._counts: Dict[int, int] = {}
        self._zero = 0
        self.n = 0
        self.total = 0.0
        self._min = math.inf
        self._max = -math.inf

    def add(self, value: float, count: int = 1) -> None:
        v = float(value)
        self.n += count
        self.total += v * count
        self._min = min(self._min, v)
        self._max = max(self._max, v)
        if v <= 0.0:
            self._zero += count
        else:
            i = math.floor(math.log(v) / self._log_g)
            self._counts[i] = self._counts.get(i, 0) + count

    @property
    def min(self) -> float:
        return 0.0 if self.n == 0 else self._min

    @property
    def max(self) -> float:
        return 0.0 if self.n == 0 else self._max

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile estimate (p in [0, 100])."""
        if self.n == 0:
            return 0.0
        rank = max(1, min(self.n, math.ceil(p / 100.0 * self.n)))
        if rank <= self._zero:
            # non-positive bucket: 0 clamped into the observed range
            return float(min(max(0.0, self._min), self._max))
        seen = self._zero
        for i in sorted(self._counts):
            seen += self._counts[i]
            if seen >= rank:
                rep = self.growth ** (i + 0.5)
                return float(min(max(rep, self._min), self._max))
        return float(self._max)

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Fold ``other`` in (bucket-exact when growth factors match)."""
        if other.n == 0:
            return self
        if abs(other.growth - self.growth) > 1e-12:
            raise ValueError(
                f"cannot merge histograms with growth {other.growth} "
                f"into {self.growth}")
        for i, c in other._counts.items():
            self._counts[i] = self._counts.get(i, 0) + c
        self._zero += other._zero
        self.n += other.n
        self.total += other.total
        self._min = min(self._min, other._min)
        self._max = max(self._max, other._max)
        return self

    def summary(self, percentiles: Tuple[float, ...] = (50.0, 90.0, 99.0)
                ) -> Dict[str, float]:
        out = {"n": self.n, "mean": self.mean, "min": self.min,
               "max": self.max}
        for p in percentiles:
            out[f"p{p:g}"] = self.percentile(p)
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {"growth": self.growth, "zero": self._zero, "n": self.n,
                "total": self.total,
                "min": self.min, "max": self.max,
                "counts": {str(i): c for i, c in sorted(self._counts.items())}}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LogHistogram":
        h = cls(growth=float(d["growth"]))
        h._zero = int(d.get("zero", 0))
        h.n = int(d["n"])
        h.total = float(d.get("total", 0.0))
        if h.n:
            h._min = float(d["min"])
            h._max = float(d["max"])
        h._counts = {int(i): int(c)
                     for i, c in (d.get("counts") or {}).items()}
        return h


@dataclasses.dataclass
class _OpenSpan:
    """Stamped attribution accumulated for one not-yet-closed span."""

    path: str
    events: int = 0
    doorbells: int = 0
    graph_launches: int = 0
    transfers: int = 0
    compiles: int = 0
    payload_bytes: int = 0
    dispatch_s: float = 0.0

    def count(self, e: TraceEvent) -> None:
        self.events += 1
        self.payload_bytes += e.payload_bytes
        if e.kind == "dispatch":
            self.doorbells += 1
            self.dispatch_s += e.dur_s
        elif e.kind == "graph_launch":
            self.graph_launches += 1
        elif e.kind == "transfer":
            self.transfers += 1
        elif e.kind == "compile":
            self.compiles += 1


class _PathStats:
    """Aggregate over all closed spans sharing one ``span_path``."""

    __slots__ = ("spans", "events", "doorbells", "graph_launches",
                 "transfers", "compiles", "payload_bytes", "dispatch_s",
                 "wall_hist", "doorbell_hist", "payload_hist")

    def __init__(self, growth: float) -> None:
        self.spans = 0
        self.events = 0
        self.doorbells = 0
        self.graph_launches = 0
        self.transfers = 0
        self.compiles = 0
        self.payload_bytes = 0
        self.dispatch_s = 0.0
        self.wall_hist = LogHistogram(growth)
        self.doorbell_hist = LogHistogram(growth)
        self.payload_hist = LogHistogram(growth)

    def fold(self, inst: _OpenSpan, wall_s: float) -> None:
        self.spans += 1
        self.events += inst.events
        self.doorbells += inst.doorbells
        self.graph_launches += inst.graph_launches
        self.transfers += inst.transfers
        self.compiles += inst.compiles
        self.payload_bytes += inst.payload_bytes
        self.dispatch_s += inst.dispatch_s
        self.wall_hist.add(wall_s)
        self.doorbell_hist.add(inst.doorbells)
        self.payload_hist.add(inst.payload_bytes)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "spans": self.spans,
            "events": self.events,
            "doorbells": self.doorbells,
            "graph_launches": self.graph_launches,
            "transfers": self.transfers,
            "compiles": self.compiles,
            "payload_bytes": self.payload_bytes,
            "dispatch_s": self.dispatch_s,
            "wall_s": self.wall_hist.summary(),
            "doorbells_per_span": self.doorbell_hist.summary(),
            "payload_bytes_per_span": self.payload_hist.summary(),
        }


class SpanProfile:
    """Per-span-name command attribution over a stamped timeline.

    Feed it events (as a session sink, or offline via
    :meth:`from_events`); read :meth:`snapshot` / :meth:`report`.  Keyed by
    ``span_path`` ("request", "request/decode_iter", ...), with roll-up:
    an event in a nested span is credited to every ancestor on its
    ``span_ids`` chain.  Span identity is deduplicated per shard, so the
    merged output of :func:`repro_torch.obs.aggregate.aggregate` — where two
    processes reuse the same local span ids — profiles correctly.
    """

    def __init__(self, name: str = "profile",
                 growth: float = DEFAULT_GROWTH) -> None:
        self.name = name
        self.growth = float(growth)
        self._lock = threading.Lock()
        # (shard, span_id) -> stamped attribution of a still-open span
        self._open: Dict[Tuple[Any, int], _OpenSpan] = {}
        self._paths: Dict[str, _PathStats] = {}
        self._events_seen = 0

    # -- sink protocol ------------------------------------------------------
    def emit(self, event: TraceEvent) -> None:
        self.feed(event)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"sink": "SpanProfile", "name": self.name,
                    "events": self._events_seen,
                    "open_spans": len(self._open),
                    "paths": len(self._paths)}

    def close(self) -> None:    # sink protocol
        pass

    # -- accumulation -------------------------------------------------------
    def feed(self, event: TraceEvent) -> None:
        meta = event.meta
        if "span_id" not in meta:
            return
        shard = meta.get("shard")
        with self._lock:
            self._events_seen += 1
            if event.name == SPAN_EVENT and "span" in meta:
                self._close_span(shard, event)
                return
            path = str(meta.get("span_path") or meta.get("span") or "")
            names = path.split("/") if path else []
            ids = meta.get("span_ids") or [meta["span_id"]]
            for depth, sid in enumerate(ids):
                inst = self._open.get((shard, int(sid)))
                if inst is None:
                    inst = _OpenSpan(path="/".join(names[:depth + 1])
                                     or str(meta.get("span", "")))
                    self._open[(shard, int(sid))] = inst
                inst.count(event)

    def _close_span(self, shard: Any, event: TraceEvent) -> None:
        meta = event.meta
        sid = int(meta["span_id"])
        path = str(meta.get("span_path") or meta["span"])
        inst = self._open.pop((shard, sid), None)
        if inst is None:
            inst = _OpenSpan(path=path)
        inst.path = path
        # declared attribution: the owner's share of work that could not be
        # stamped exclusively (e.g. one decode launch serving many requests)
        inst.doorbells += int(meta.get("doorbells", 0))
        inst.payload_bytes += int(meta.get("payload", 0))
        inst.graph_launches += int(meta.get("graph_launches", 0))
        stats = self._paths.get(path)
        if stats is None:
            stats = self._paths[path] = _PathStats(self.growth)
        stats.fold(inst, wall_s=event.dur_s)

    @classmethod
    def from_events(cls, events: Iterable[TraceEvent],
                    name: str = "profile",
                    growth: float = DEFAULT_GROWTH) -> "SpanProfile":
        """Post-mortem profile of any stamped timeline (ring, shard,
        or :func:`~repro_torch.obs.aggregate.aggregate` merge)."""
        prof = cls(name=name, growth=growth)
        for e in events:
            prof.feed(e)
        return prof

    # -- querying -----------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable per-path attribution with percentile fields."""
        with self._lock:
            return {
                "profile": self.name,
                "events": self._events_seen,
                "open_spans": len(self._open),
                "spans": {path: st.to_dict()
                          for path, st in sorted(self._paths.items())},
            }

    def path(self, span_path: str) -> Optional[Dict[str, Any]]:
        """One path's stats dict (or None if never closed)."""
        with self._lock:
            st = self._paths.get(span_path)
            return st.to_dict() if st is not None else None

    def store_metrics(self, span_path: Optional[str] = None
                      ) -> Dict[str, float]:
        """Flat ``{metric_id: value}`` view for the metrics store
        (:mod:`repro_torch.obs.store`) — ids are ``path/column`` so
        ``repro_torch.obs.trajectory`` can diff them across runs."""
        out: Dict[str, float] = {}
        for path, st in self.snapshot()["spans"].items():
            if span_path is not None and path != span_path:
                continue
            d = st
            for col in ("spans", "doorbells", "payload_bytes",
                        "graph_launches", "dispatch_s"):
                out[f"{path}/{col}"] = float(d[col])
            for col in ("wall_s", "doorbells_per_span",
                        "payload_bytes_per_span"):
                for pk in ("p50", "p90", "p99", "mean"):
                    out[f"{path}/{col}_{pk}"] = float(d[col][pk])
        return out

    def report(self, max_paths: int = 24) -> str:
        """Fixed-width attribution table (the profiler's Listing-1)."""
        snap = self.snapshot()
        lines = [f"==== SPAN PROFILE {self.name} ====",
                 f"{'span_path':<32s} {'spans':>6s} {'doorbells':>10s} "
                 f"{'payload':>12s} {'glaunch':>8s} "
                 f"{'wall p50':>10s} {'p90':>10s} {'p99':>10s}"]
        for path, st in list(snap["spans"].items())[:max_paths]:
            w = st["wall_s"]
            lines.append(
                f"{path:<32.32s} {st['spans']:>6d} {st['doorbells']:>10d} "
                f"{st['payload_bytes']:>11d}B {st['graph_launches']:>8d} "
                f"{w['p50']*1e3:>8.2f}ms {w['p90']*1e3:>8.2f}ms "
                f"{w['p99']*1e3:>8.2f}ms")
        if len(snap["spans"]) > max_paths:
            lines.append(f"  ... {len(snap['spans']) - max_paths} more")
        if snap["open_spans"]:
            lines.append(f"  ({snap['open_spans']} spans still open)")
        lines.append(f"==== END SPAN PROFILE {self.name} ====")
        return "\n".join(lines)
