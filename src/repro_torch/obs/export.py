"""Chrome-trace / Perfetto export of TraceSession timelines.

Turns any event list — a live session ring, a JSONL shard, or the merged
cross-host output of :mod:`repro_torch.obs.aggregate` — into the Chrome Trace
Event JSON that ``ui.perfetto.dev`` (or ``chrome://tracing``) loads
directly, so the paper's Listing-1 timeline becomes a zoomable flame view:

* each **shard** (one process's session) maps to a Perfetto *process*
  (``pid``), named via metadata events from its ``host``/``process`` tags;
* **scoped spans** (``with sess.span(...)``) map to complete duration
  events (``ph: "X"``) on a per-thread track — contextvar scoping
  guarantees proper nesting in time, which Perfetto renders as a stack;
* **unscoped spans** (manual :class:`~repro_torch.core.session.SpanHandle`\\ s,
  e.g. serve requests that overlap arbitrarily) map to *async* event pairs
  (``ph: "b"/"e"`` keyed by span id) so overlap is legal and visible;
* every other event kind rides its own named track: ``dispatch`` events
  with a measurable duration as tiny ``X`` slices, zero-duration ones as
  instants (``ph: "i"``).

CLI::

    python -m repro_torch.obs.export trace.jsonl -o trace_perfetto.json
    python -m repro_torch.obs.export shard.p0.jsonl shard.p1.jsonl -o fleet.json

Multiple inputs are barrier-aligned and merged via
:func:`repro_torch.obs.aggregate.aggregate` first, so one Perfetto view shows the
whole fleet on one clock.

The port's copy of ``repro.obs.export`` (host code).
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Iterable, List, Optional, Sequence

from ..core.session import (BARRIER_EVENT, EVENT_KINDS, SPAN_EVENT,
                            JsonlSink, TraceEvent)

__all__ = ["to_chrome_trace", "export", "main"]

#: tid layout per process: spans stack on low tids (one per emitting
#: thread), event-kind tracks sit above them at a fixed offset
KIND_TID_BASE = 100
_KIND_TID = {k: KIND_TID_BASE + i for i, k in enumerate(EVENT_KINDS)}

#: meta keys that are span/shard plumbing, not useful Perfetto args
_PLUMBING = frozenset({"span_ids", "thread", "scoped", "shard", "src_seq"})


def _shard_key(e: TraceEvent) -> str:
    m = e.meta
    if m.get("shard") is not None:              # aggregate() provenance
        return str(m["shard"])
    host = m.get("host")
    proc = m.get("process")
    if host is not None or proc is not None:
        return f"{host or 'host'}/p{proc if proc is not None else 0}"
    return "local"


def _args_of(e: TraceEvent) -> Dict[str, Any]:
    args: Dict[str, Any] = {"seq": e.seq}
    if e.payload_bytes:
        args["payload_bytes"] = e.payload_bytes
    if e.complete_s:
        args["complete_us"] = round(e.complete_s * 1e6, 3)
    for k, v in e.meta.items():
        if k not in _PLUMBING and isinstance(v, (str, int, float, bool,
                                                 type(None))):
            args[k] = v
    return args


def to_chrome_trace(events: Iterable[TraceEvent],
                    trace_name: str = "repro_torch") -> Dict[str, Any]:
    """Build the Chrome Trace Event JSON object for ``events``.

    Returns the standard object form: ``{"traceEvents": [...],
    "displayTimeUnit": "ms", "otherData": {...}}`` — serializable with
    ``json.dump`` and loadable by Perfetto as-is.
    """
    evs = sorted(events, key=lambda e: (e.t, e.seq))
    out: List[Dict[str, Any]] = []
    pids: Dict[str, int] = {}
    # (pid, python thread ident) -> span tid; tid 0 is the anonymous track
    span_tids: Dict[Any, int] = {}
    kinds_used: Dict[int, set] = {}
    # Perfetto dislikes negative timestamps; rebase if alignment produced
    # any.  Span events are stamped at close time, so their slice *start*
    # (t - dur_s) is what must stay non-negative.
    t_base = min((e.t - (e.dur_s if e.name == SPAN_EVENT else 0.0)
                  for e in evs), default=0.0)
    t_base = t_base if t_base < 0.0 else 0.0

    def pid_of(e: TraceEvent) -> int:
        key = _shard_key(e)
        if key not in pids:
            pids[key] = len(pids)
            out.append({"ph": "M", "name": "process_name", "pid": pids[key],
                        "tid": 0, "args": {"name": key}})
        return pids[key]

    def span_tid(pid: int, thread: Any) -> int:
        key = (pid, thread)
        if key not in span_tids:
            n = sum(1 for (p, _t) in span_tids if p == pid)
            span_tids[key] = n
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": n,
                        "args": {"name": "spans" if n == 0
                                 else f"spans t{n}"}})
        return span_tids[key]

    for e in evs:
        pid = pid_of(e)
        ts = (e.t - t_base) * 1e6                       # microseconds
        if e.name == SPAN_EVENT and "span" in e.meta:
            name = str(e.meta["span"])
            dur = max(e.dur_s, 0.0) * 1e6
            ts = ts - dur       # span events are stamped at close time
            if e.meta.get("scoped"):
                # contextvar spans nest properly in time per thread ->
                # complete events on a shared track render as a stack
                out.append({"ph": "X", "cat": "span", "name": name,
                            "pid": pid,
                            "tid": span_tid(pid, e.meta.get("thread", 0)),
                            "ts": ts, "dur": dur, "args": _args_of(e)})
            else:
                # manual handles overlap arbitrarily -> async pairs
                sid = f"span{e.meta.get('span_id', e.seq)}"
                base = {"cat": "span", "name": name, "pid": pid, "tid": 0,
                        "id": sid}
                out.append({**base, "ph": "b", "ts": ts,
                            "args": _args_of(e)})
                out.append({**base, "ph": "e", "ts": ts + dur, "args": {}})
            continue
        tid = _KIND_TID.get(e.kind, KIND_TID_BASE + len(EVENT_KINDS))
        if tid not in kinds_used.setdefault(pid, set()):
            kinds_used[pid].add(tid)
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": e.kind}})
        name = e.name
        cat = "barrier" if e.name == BARRIER_EVENT else e.kind
        dur = max(e.dur_s, e.complete_s) * 1e6
        if dur > 0.0:
            out.append({"ph": "X", "cat": cat, "name": name, "pid": pid,
                        "tid": tid, "ts": ts, "dur": dur,
                        "args": _args_of(e)})
        else:
            out.append({"ph": "i", "cat": cat, "name": name, "pid": pid,
                        "tid": tid, "ts": ts, "s": "t",
                        "args": _args_of(e)})
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {"trace": trace_name, "events": len(evs),
                      "shards": sorted(pids)},
    }


def export(paths: Sequence[str], out_path: str,
           trace_name: str = "repro_torch") -> Dict[str, Any]:
    """Load shard(s), merge if several, write Chrome-trace JSON.

    Returns the trace object (also written to ``out_path``).
    """
    if len(paths) == 1:
        events: List[TraceEvent] = sorted(JsonlSink.load(paths[0]),
                                          key=lambda e: e.seq)
    else:
        from .aggregate import aggregate
        events = aggregate(list(paths)).events
    trace = to_chrome_trace(events, trace_name=trace_name)
    with open(out_path, "w") as f:
        json.dump(trace, f)
        f.write("\n")
    return trace


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.export",
        description="Export TraceSession JSONL timeline(s) as Chrome-trace "
                    "JSON for ui.perfetto.dev (several shards are "
                    "barrier-aligned and merged first).")
    ap.add_argument("shards", nargs="+", help="TraceSession .jsonl file(s)")
    ap.add_argument("-o", "--out", default="trace_perfetto.json",
                    help="output Chrome-trace JSON path")
    ap.add_argument("--name", default="repro_torch", help="trace name metadata")
    args = ap.parse_args(argv)

    trace = export(args.shards, args.out, trace_name=args.name)
    n_span = sum(1 for t in trace["traceEvents"]
                 if t.get("cat") == "span" and t["ph"] in ("X", "b"))
    print(f"wrote {args.out}: {len(trace['traceEvents'])} trace events "
          f"({n_span} spans, {len(trace['otherData']['shards'])} "
          f"process(es)) — open at https://ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
