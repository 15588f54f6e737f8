"""The measured window: the traffic into the engine, on the host's clock.

One thread drives everything.  An open loop submits each request when it
falls due (``ContinuousBatchingServer.submit``) between scheduler
iterations (``ContinuousBatchingServer.step``, the body of ``run``'s loop),
which admit only between decode launches anyway; when the engine is idle it
sleeps until the next request is due.  Each request is timed from when it
was due, so a late submit counts against it; one due while the last
launch ran is submitted when it returns.  After that nothing more is
submitted, and an open loop drains what was due for at most
the mix's ``drain_s``; what is left then has failed.  An offline mix queues
every request when the window opens and stops at the close.

The records are the program's own tickets (admission, first token, done,
the tokens) plus what the benchmark saw: due and submit times, each step's
start and end, the decode launch each step made with the cache length of
every request it carried, the engine's doorbell count and the tokens
harvested at each step's end.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from .traffic import Arrival

__all__ = ["Req", "Step", "Window", "drive", "SpanLog"]


@dataclasses.dataclass
class Req:
    arrival: Arrival
    due: float                  # perf_counter
    submitted: float
    ticket: Any                 # the engine's RequestTicket


@dataclasses.dataclass
class Step:
    t0: float
    t1: float
    tokens: int                 # every request's tokens at the step's end
    doorbells: int              # the engine's doorbell count at the end
    prefills: List[int]         # prompt lengths prefilled in the step
    decoded: List[int]          # cache length of each request decoded ...
    kept: List[int]             # ... and the tokens it kept from the launch
    replays: Any = None         # (first, end) in the replay log (traced)


@dataclasses.dataclass
class Window:
    t_open: float
    t_close: float
    t_end: float                # the drain's end
    reqs: List[Req]
    steps: List[Step]
    sleeps: List[Any]           # (start, end) of the waits for arrivals
    doorbells_open: int
    max_late_s: float

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open

    def in_window(self) -> List[Step]:
        return [s for s in self.steps if s.t1 <= self.t_close]


class SpanLog:
    """A session sink: the program's ``obs.span`` close events of the named
    spans, as (name, start, end) on the ``perf_counter`` clock."""

    def __init__(self, session: Any, names: Sequence[str]) -> None:
        self.t0 = session.t0
        self.names = set(names)
        self.spans: List[Any] = []

    def emit(self, event: Any) -> None:
        if event.name != "obs.span":
            return
        name = event.meta.get("span")
        if name in self.names:
            end = self.t0 + event.t
            self.spans.append((name, end - event.dur_s, end))

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def stats(self) -> Dict[str, Any]:
        return {"sink": type(self).__name__, "spans": len(self.spans)}


def drive(engine: Any, arrivals: Sequence[Arrival], seconds: float,
          offline: bool, drain_s: float, make_request: Callable[..., Any],
          on_tick: Optional[Callable[[float, "Window"], None]] = None,
          replay_log: Optional[List[Any]] = None) -> Window:
    """Run the window; ``on_tick(now, window)`` runs between steps (the
    traced slice opens and closes there); ``replay_log`` is the list that
    a traced run's graph replays land in."""
    pending = collections.deque(sorted(arrivals, key=lambda a: a.t))
    t_open = time.perf_counter()
    w = Window(t_open=t_open, t_close=t_open + seconds, t_end=t_open,
               reqs=[], steps=[], sleeps=[],
               doorbells_open=engine.tracker.count, max_late_s=0.0)
    live: List[Req] = []
    while True:
        now = time.perf_counter()
        closed = now >= w.t_close
        # every request due inside the window, the last launch's too
        while pending and t_open + pending[0].t <= min(now, w.t_close):
            a = pending.popleft()
            due = t_open + a.t
            tix = engine.submit(make_request(a))
            r = Req(a, due, time.perf_counter(), tix)
            w.max_late_s = max(w.max_late_s, r.submitted - due)
            w.reqs.append(r)
            live.append(r)
        if on_tick is not None:
            on_tick(time.perf_counter(), w)
        live = [r for r in live if not r.ticket.finished]
        if closed and (offline or not live or now >= w.t_close + drain_s):
            break
        before = {id(r): len(r.ticket.tokens) for r in live
                  if r.ticket.status == "active"}
        launches = {id(r): r.ticket.n_launches for r in live}
        n_replays = len(replay_log) if replay_log is not None else 0
        t0 = time.perf_counter()
        busy = engine.step()
        t1 = time.perf_counter()
        if not busy and len(engine.queue) == 0:
            nxt = (t_open + pending[0].t if pending and not closed
                   else min(w.t_close, now + 0.002) if not closed
                   else now + 0.002)
            wait = nxt - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            w.sleeps.append((t1, time.perf_counter()))
            continue
        prefills, decoded, kept = [], [], []
        for r in live:
            tix = r.ticket
            n0 = before.get(id(r))
            if tix.n_launches > launches[id(r)]:
                if n0 is None or n0 == 0:
                    # admitted this step: its prefill gave token 0
                    n0 = 1
                decoded.append(len(r.arrival.prompt) + n0 - 1)
                kept.append(len(tix.tokens) - n0)
            if id(r) not in before and tix.n_prefill_launches:
                prefills.append(len(r.arrival.prompt))
        tokens = sum(len(r.ticket.tokens) for r in w.reqs)
        w.steps.append(Step(t0, t1, tokens, engine.tracker.count, prefills,
                            decoded, kept,
                            (n_replays, len(replay_log))
                            if replay_log is not None else None))
    w.t_end = time.perf_counter()
    return w
