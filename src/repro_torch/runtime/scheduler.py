"""Request scheduling for the continuous-batching server.

The decode loop is the paper's pathological small-submission regime; what a
production engine adds around it is *membership churn*: requests arrive on
their own clock (a traffic thread), wait in a bounded admission queue, get a
KV slot when one frees up, and leave (or are evicted) mid-stream while the
rest of the batch keeps decoding.  This module holds the bookkeeping side of
that — tickets, the admission queue, eviction policies, and the percentile
helpers the load harness reports with — host code only, so it is
unit-testable without a device.  The port's copy of
``repro.runtime.scheduler``.

Lifecycle of a :class:`RequestTicket`::

    queued --admit--> active --finish--> done
       |                 |
       | (queue full,    | (KV budget would overrun max_seq)
       |  drop_oldest)   v
       +--------------> evicted
       | (queue full, reject / prompt too long)
       v
    rejected
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import collections

__all__ = ["RequestTicket", "AdmissionQueue", "SchedulerPolicy",
           "FifoPolicy", "PriorityPolicy", "FairSharePolicy", "make_policy",
           "SCHED_POLICIES", "percentile", "latency_stats"]

#: terminal ticket states
FINISHED = ("done", "evicted", "rejected")


@dataclasses.dataclass
class RequestTicket:
    """One request's journey through the engine, with timing for metrics.

    Timestamps are ``perf_counter`` readings; ``-1.0`` means "never
    happened".  ``cap`` is the KV-capacity token budget computed at admission
    (``max_seq - len(prompt) + 1``): a request asking for more is truncated
    there and finishes as ``evicted``.
    """

    request: Any                     # runtime.server.Request
    status: str = "queued"           # queued|active|done|evicted|rejected
    reason: str = ""                 # why evicted/rejected
    slot: int = -1
    cap: int = 0
    t_submit: float = -1.0
    t_admit: float = -1.0
    t_first: float = -1.0            # first token harvested
    t_done: float = -1.0
    tokens: List[int] = dataclasses.field(default_factory=list)
    n_launches: int = 0              # decode launches this request rode
    n_prefill_launches: int = 0      # prefill/extend launches (chunks)

    @property
    def uid(self) -> int:
        return self.request.uid

    @property
    def finished(self) -> bool:
        return self.status in FINISHED

    @property
    def latency_s(self) -> float:
        """Submit -> terminal state (includes queue wait)."""
        if self.t_done < 0 or self.t_submit < 0:
            return -1.0
        return self.t_done - self.t_submit

    @property
    def ttft_s(self) -> float:
        """Submit -> first harvested token."""
        if self.t_first < 0 or self.t_submit < 0:
            return -1.0
        return self.t_first - self.t_submit

    def to_dict(self) -> Dict[str, Any]:
        return {
            "uid": self.uid, "status": self.status, "reason": self.reason,
            "prompt_len": int(len(self.request.prompt)),
            "max_new_tokens": int(self.request.max_new_tokens),
            "n_tokens": len(self.tokens),
            "n_launches": self.n_launches,
            "n_prefill_launches": self.n_prefill_launches,
            "latency_s": self.latency_s, "ttft_s": self.ttft_s,
        }


class SchedulerPolicy:
    """Chooses which queued ticket is admitted next.

    ``select`` receives a snapshot of the queued tickets (FIFO order) and
    returns the index to admit.  ``note_admitted`` is called with the ticket
    actually removed, so stateful policies (fair-share) can account for it.
    Policies never mutate the queue — :meth:`AdmissionQueue.pop` does the
    removal under its own lock.
    """

    name = "fifo"

    def select(self, queued: Sequence["RequestTicket"]) -> int:
        return 0

    def note_admitted(self, ticket: "RequestTicket") -> None:
        pass

    def note_finished(self, ticket: "RequestTicket") -> None:
        """Called when an admitted ticket reaches a terminal state, so
        stateful policies can reconcile admission-time estimates against
        what the request actually consumed.  No-op for tickets that never
        passed through :meth:`note_admitted`."""
        pass


class FifoPolicy(SchedulerPolicy):
    """Strict arrival order — the pre-policy behavior."""

    name = "fifo"


class PriorityPolicy(SchedulerPolicy):
    """Highest ``Request.priority`` first; FIFO among equals."""

    name = "priority"

    def select(self, queued: Sequence["RequestTicket"]) -> int:
        best, best_p = 0, None
        for i, t in enumerate(queued):
            p = int(getattr(t.request, "priority", 0))
            if best_p is None or p > best_p:
                best, best_p = i, p
        return best


class FairSharePolicy(SchedulerPolicy):
    """Least-served ``Request.user`` first; FIFO within a user.

    "Served" is charged as the decode-token *budget* at admission (so
    fairness reacts before any token is generated), then reconciled to
    the tokens actually emitted when the request finishes — a request
    evicted after a few tokens does not permanently bill its user for
    output it never received.  The per-user ledger is bounded: past
    ``max_users`` distinct users, the least-recently-active entry with no
    in-flight request is evicted, so long-running servers with churny
    user strings do not grow state without bound.
    """

    name = "fair"

    def __init__(self, max_users: int = 1024) -> None:
        self.max_users = int(max_users)
        # user -> tokens served, ordered by last activity (LRU eviction)
        self._served: "collections.OrderedDict[str, int]" = \
            collections.OrderedDict()
        self._inflight: Dict[int, Tuple[str, int]] = {}  # uid->(user,charge)

    @staticmethod
    def _user(request: Any) -> str:
        return str(getattr(request, "user", ""))

    def select(self, queued: Sequence["RequestTicket"]) -> int:
        best, best_cost = 0, None
        for i, t in enumerate(queued):
            cost = self._served.get(self._user(t.request), 0)
            if best_cost is None or cost < best_cost:
                best, best_cost = i, cost
        return best

    def _charge(self, user: str, amount: int) -> None:
        self._served[user] = self._served.get(user, 0) + amount
        self._served.move_to_end(user)
        while len(self._served) > self.max_users:
            live = {u for u, _ in self._inflight.values()}
            stale = next((u for u in self._served
                          if u != user and u not in live), None)
            if stale is None:
                break
            del self._served[stale]

    def note_admitted(self, ticket: "RequestTicket") -> None:
        user = self._user(ticket.request)
        est = int(getattr(ticket.request, "max_new_tokens", 1))
        self._inflight[ticket.uid] = (user, est)
        self._charge(user, est)

    def note_finished(self, ticket: "RequestTicket") -> None:
        entry = self._inflight.pop(ticket.uid, None)
        if entry is None:
            return
        user, est = entry
        self._charge(user, len(ticket.tokens) - est)


SCHED_POLICIES = ("fifo", "priority", "fair")


def make_policy(name: str) -> SchedulerPolicy:
    if name == "fifo":
        return FifoPolicy()
    if name == "priority":
        return PriorityPolicy()
    if name == "fair":
        return FairSharePolicy()
    raise ValueError(f"unknown scheduler policy {name!r}; "
                     f"expected one of {SCHED_POLICIES}")


class AdmissionQueue:
    """Bounded, thread-safe FIFO of queued tickets.

    ``policy`` decides what happens when the queue is full:

    * ``"reject"`` — the *incoming* ticket is refused (callers mark it
      ``rejected``); the queue is untouched.
    * ``"drop_oldest"`` — the oldest *queued* ticket is evicted to make
      room (callers mark it ``evicted``); the incoming one is accepted.

    ``close()`` marks end-of-intake: further submits are refused and the
    engine's drain loop knows no more work is coming.
    """

    POLICIES = ("reject", "drop_oldest")

    def __init__(self, max_pending: int = 256,
                 policy: str = "reject") -> None:
        if policy not in self.POLICIES:
            raise ValueError(f"unknown admission policy {policy!r}; "
                             f"expected one of {self.POLICIES}")
        self.max_pending = int(max_pending)
        self.policy = policy
        self._q: Deque[RequestTicket] = collections.deque()
        self._lock = threading.Lock()
        # wakes the engine's drain loop on submit/close so run() blocks on
        # this instead of spinning on poll_s (which stays as the fallback)
        self._cv = threading.Condition(self._lock)
        self._closed = False
        self.n_submitted = 0
        self.n_refused = 0
        self.n_dropped = 0

    def submit(self, ticket: RequestTicket
               ) -> Tuple[bool, Optional[RequestTicket]]:
        """Try to enqueue; returns ``(accepted, dropped_ticket)``.

        ``dropped_ticket`` is the queued ticket evicted under
        ``drop_oldest`` (None otherwise).  The caller owns status updates
        for both tickets — the queue only moves them.
        """
        with self._lock:
            if self._closed:
                self.n_refused += 1
                return False, None
            dropped = None
            if len(self._q) >= self.max_pending:
                if self.policy == "reject":
                    self.n_refused += 1
                    return False, None
                dropped = self._q.popleft()
                self.n_dropped += 1
            self._q.append(ticket)
            self.n_submitted += 1
            self._cv.notify_all()
            return True, dropped

    def pop(self, policy: Optional["SchedulerPolicy"] = None
            ) -> Optional[RequestTicket]:
        """Remove and return the next ticket per ``policy`` (default FIFO).

        The policy sees an immutable snapshot and returns an index; removal
        happens here, under the queue lock, so policies can reorder without
        reaching into ``_q`` (and ``drop_oldest`` semantics in
        :meth:`submit` are untouched — overflow always drops the *oldest*
        queued ticket regardless of admission order).
        """
        with self._lock:
            if not self._q:
                return None
            i = 0
            if policy is not None:
                i = int(policy.select(tuple(self._q)))
                if not 0 <= i < len(self._q):
                    i = 0
            t = self._q[i]
            del self._q[i]
        if policy is not None:
            policy.note_admitted(t)
        return t

    def peek(self, policy: Optional["SchedulerPolicy"] = None
             ) -> Optional[RequestTicket]:
        """The ticket :meth:`pop` would return, without removing it."""
        with self._lock:
            if not self._q:
                return None
            i = 0
            if policy is not None:
                i = int(policy.select(tuple(self._q)))
                if not 0 <= i < len(self._q):
                    i = 0
            return self._q[i]

    def wait_for_work(self, timeout: float) -> bool:
        """Block until a ticket is queued or intake closes (or timeout).

        Returns True if there is something to look at.  This is what lets
        the engine's drain loop sleep instead of busy-polling.
        """
        with self._lock:
            if self._q or self._closed:
                return True
            self._cv.wait(timeout=max(0.0, timeout))
            return bool(self._q) or self._closed

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._cv.notify_all()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)


def percentile(xs: Sequence[float], p: float) -> float:
    """Linear-interpolated percentile (numpy-free so it runs anywhere)."""
    vals = sorted(x for x in xs if x >= 0.0)
    if not vals:
        return 0.0
    if len(vals) == 1:
        return float(vals[0])
    rank = (p / 100.0) * (len(vals) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(vals) - 1)
    frac = rank - lo
    return float(vals[lo] * (1.0 - frac) + vals[hi] * frac)


def latency_stats(tickets: Sequence[RequestTicket]) -> Dict[str, float]:
    """p50/p99 latency and time-to-first-token over terminal tickets."""
    lats = [t.latency_s for t in tickets if t.t_done >= 0]
    ttfts = [t.ttft_s for t in tickets if t.t_first >= 0]
    return {
        "latency_p50_s": percentile(lats, 50.0),
        "latency_p99_s": percentile(lats, 99.0),
        "ttft_p50_s": percentile(ttfts, 50.0),
        "ttft_p99_s": percentile(ttfts, 99.0),
    }
