"""The arithmetic of the end-to-end metrics, on the window's records.

A request that failed (never finished, evicted, rejected) has an infinite
latency: it counts in every percentile, never drops out of one.
Percentiles are by nearest rank, so the p95 of 200 requests is the 190th
smallest and has ten beyond it."""
from __future__ import annotations

import math
from typing import Any, List, Sequence

INF = float("inf")

__all__ = ["INF", "percentile", "attempted", "failed", "ttft_s", "tpot_s",
           "queue_wait_s", "window_tokens", "window_work", "window_doorbells"]


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank ``q`` percentile (0 < q <= 100); inf stays inf."""
    if not values:
        raise ValueError("percentile of no values")
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def attempted(w: Any, offline: bool) -> List[Any]:
    """The requests a run answers for: every one due in an open loop's
    window; an offline batch's admitted before its close (the rest of its
    queue never started)."""
    if not offline:
        return list(w.reqs)
    return [r for r in w.reqs if 0 <= r.ticket.t_admit <= w.t_close]


def ok(r: Any) -> bool:
    t = r.ticket
    return t.status == "done" and len(t.tokens) == r.arrival.max_new_tokens


def failed(w: Any, offline: bool) -> List[Any]:
    """Attempted requests that did not come: an open loop's not done once
    the drain ended; an offline batch's evicted or rejected (those still
    decoding at the close are cut there, not failed)."""
    out = []
    for r in attempted(w, offline):
        if ok(r):
            continue
        if offline and r.ticket.status in ("active", "queued"):
            continue
        out.append(r)
    return out


def ttft_s(r: Any) -> float:
    t = r.ticket
    return t.t_first - r.due if t.t_first >= 0 else INF


def tpot_s(r: Any) -> float:
    if not ok(r):
        return INF
    t = r.ticket
    n = len(t.tokens)
    return (t.t_done - t.t_first) / (n - 1) if n > 1 else 0.0


def queue_wait_s(r: Any) -> float:
    t = r.ticket
    return t.t_admit - r.due if t.t_admit >= 0 else INF


def window_tokens(w: Any) -> int:
    """Output tokens harvested by steps that ended inside the window."""
    inside = w.in_window()
    return inside[-1].tokens if inside else 0


def window_work(w: Any) -> float:
    """Output tokens of the window: those of the steps that ended inside
    it, and of the step in flight at the close the share of its tokens
    that its time inside the window bears.  A count that steps make in
    jumps of a whole launch is then a rate over all the window's time."""
    done = window_tokens(w)
    after = [s for s in w.steps if s.t1 > w.t_close]
    if after and after[0].t0 < w.t_close:
        s = after[0]
        done += (s.tokens - done) * (w.t_close - s.t0) / (s.t1 - s.t0)
    return float(done)


def window_doorbells(w: Any) -> int:
    inside = w.in_window()
    return (inside[-1].doorbells if inside else w.doorbells_open) \
        - w.doorbells_open
