"""Synthetic serving traffic: seeded Poisson arrivals + replay harness.

Production decode traffic is not a static batch: requests arrive on their
own clock with mixed prompt and output lengths, join a running batch, and
leave when done.  This module generates that pattern deterministically (one
``numpy`` Generator seed fixes the arrival times, prompts, and budgets) and
replays it against a :class:`~repro_torch.runtime.server.ContinuousBatchingServer`
either in real time (a producer thread sleeps to each arrival and submits
while the decode loop runs — the regime the thread-safe ``TraceSession``
exists for) or synchronously (submit everything, then drain — deterministic
scheduling for tests and count parity).  The port's copy of
``repro.runtime.traffic``: only the decode-loop thread touches the device;
the producer thread's ``submit`` is host-only.

Replay metrics come from one place: the engine's run metrics, which are
TraceSession deltas (doorbells = ``dispatch`` events, tokens carried on
``serve.finish`` progress payloads) plus per-ticket latency percentiles.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .scheduler import RequestTicket
from .server import ContinuousBatchingServer, Request

__all__ = ["TrafficSpec", "Arrival", "generate", "replay"]


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """Shape of a synthetic load: Poisson arrivals, mixed lengths.

    ``rate`` is the mean arrival rate in requests/second (inter-arrival
    gaps are exponential); prompt and output lengths are drawn uniformly
    from the given choices.  Keeping ``prompt_lens`` a small discrete set
    bounds prefill compilation to one compile per distinct length.
    """

    n_requests: int = 64
    rate: float = 50.0
    prompt_lens: Tuple[int, ...] = (4, 8, 16)
    new_tokens: Tuple[int, ...] = (4, 8, 16)
    seed: int = 0
    #: tokens of seeded prefix shared by every prompt (0 = independent
    #: prompts); models system-prompt traffic, the regime where the paged
    #: KV backend's prefix-page reuse pays off
    prefix_len: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request: submit at ``t`` seconds after replay start."""

    t: float
    request: Request


def generate(spec: TrafficSpec, vocab_size: int) -> List[Arrival]:
    """Deterministic schedule: same spec (incl. seed) -> same arrivals."""
    rng = np.random.default_rng(spec.seed)
    prefix = rng.integers(0, vocab_size, size=spec.prefix_len
                          ).astype(np.int32)
    arrivals: List[Arrival] = []
    t = 0.0
    for uid in range(spec.n_requests):
        t += float(rng.exponential(1.0 / spec.rate))
        plen = int(rng.choice(spec.prompt_lens))
        budget = int(rng.choice(spec.new_tokens))
        suffix = rng.integers(0, vocab_size, size=plen).astype(np.int32)
        arrivals.append(Arrival(t=t, request=Request(
            uid=uid, prompt=np.concatenate([prefix, suffix]),
            max_new_tokens=budget)))
    return arrivals


def replay(engine: ContinuousBatchingServer, arrivals: Sequence[Arrival],
           realtime: bool = True, speed: float = 1.0,
           idle_timeout_s: float = 30.0
           ) -> Tuple[List[RequestTicket], Dict[str, Any]]:
    """Drive ``arrivals`` through the engine; returns (tickets, metrics).

    ``realtime=True`` submits from a producer thread that sleeps to each
    (speed-scaled) arrival time while the caller's thread runs the decode
    loop — requests genuinely join mid-decode.  ``realtime=False`` submits
    everything up front (arrival order preserved, zero wall-clock gaps):
    fully deterministic scheduling, used by tests and count parity.
    """
    if not realtime:
        # everything is already queued: drain and exit as soon as idle
        tickets = [engine.submit(a.request) for a in arrivals]
        metrics = engine.run(idle_timeout_s=0.0)
        return tickets, metrics

    tickets: List[RequestTicket] = []

    def producer() -> None:
        t0 = time.perf_counter()
        for a in arrivals:
            delay = a.t / speed - (time.perf_counter() - t0)
            if delay > 0:
                time.sleep(delay)
            tickets.append(engine.submit(a.request))
        engine.close_intake()

    thread = threading.Thread(target=producer, name="traffic", daemon=True)
    thread.start()
    metrics = engine.run(idle_timeout_s=idle_timeout_s)
    thread.join()
    return tickets, metrics
