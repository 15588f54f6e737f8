"""The port's progress trackers and heartbeats (``repro_torch.core.semaphore``)
against the JAX reference's (``repro.core.semaphore``), on the CPU.

On a card a release also records a CUDA event and ``elapsed`` is the device
time between two events; ``chip_smoke.py`` phase D2 holds those brackets
against torch.profiler.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Heartbeat as JaxHeartbeat
from repro.core import ProgressTracker as JaxProgressTracker
from repro_torch.core import Heartbeat, ProgressTracker, TraceSession


def test_release_wait_elapsed():
    pt = ProgressTracker()
    a = pt.release(torch.ones(8) * 3)
    b = pt.release(torch.ones(8) * 4)
    assert not a.completed and a.event is None      # CPU: no device clock
    dt = pt.elapsed(a, b)
    assert a.completed and b.completed
    assert dt == abs(b.t_complete - a.t_complete) >= 0
    assert a.payload != b.payload


def test_payload_ordering_matches_reference():
    ours, theirs = ProgressTracker(), JaxProgressTracker()
    toks = [ours.release(torch.zeros(2)) for _ in range(5)]
    ref = [theirs.release(jnp.zeros(2)) for _ in range(5)]
    assert [t.payload for t in toks] == [t.payload for t in ref] == [1, 2, 3,
                                                                    4, 5]
    for t, r in zip(toks, ref):
        assert int(t.fence) == int(r.fence) == t.payload
        assert t.fence.dtype == torch.int32


@pytest.mark.parametrize("tied_to", [
    torch.arange(6, dtype=torch.int8).reshape(2, 3),
    {"a": [None, torch.full((3,), 7.0, dtype=torch.bfloat16)]},
    (np.arange(4, dtype=np.float32),),
    torch.zeros(0),
    "no tensors",
], ids=["int8", "nested", "numpy", "empty", "no_leaf"])
def test_fence_carries_the_payload(tied_to):
    pt = ProgressTracker()
    pt.release(torch.ones(1))
    tok = pt.release(tied_to)
    assert pt.wait(tok) == tok.t_complete and int(tok.fence) == 2


def test_wait_raises_on_payload_mismatch():
    pt = ProgressTracker()
    tok = pt.release(torch.ones(2))
    tok.fence = tok.fence + 1              # a semaphore that never landed
    with pytest.raises(RuntimeError, match="payload mismatch"):
        pt.wait(tok)
    assert not tok.completed


def test_release_and_wait_events_on_session():
    with TraceSession("progress") as sess:
        pt = ProgressTracker()
        tok = pt.release(torch.ones(3))
        pt.wait(tok)
    evs = sess.timeline(kinds="progress")
    assert [(e.name, e.meta["payload"]) for e in evs] == [("release", 1),
                                                          ("wait", 1)]
    assert evs[1].complete_s >= 0


def _beats(hb, schedule):
    for worker, t in schedule:
        hb.beat(worker, t)


# (n_workers, factor, beats, now): workers 0 and 1 beat every second, worker
# 2 stops at t=3; a worker that never beats; irregular intervals
SCENARIOS = [
    (3, 3.0, [(w, float(t)) for t in range(10) for w in (0, 1)]
     + [(2, float(t)) for t in range(4)], 9.5),
    (4, 2.0, [(w, 0.5 * t) for t in range(6) for w in (0, 2)]
     + [(1, 0.0), (1, 2.0)], 3.0),
    (2, 1.5, [(0, 0.0), (0, 0.3), (0, 1.9), (1, 0.0), (1, 1.0)], 2.5),
    (2, 3.0, [], 1.0),
]


@pytest.mark.parametrize("n,factor,beats,now", SCENARIOS)
def test_heartbeat_matches_reference(n, factor, beats, now):
    ours, theirs = Heartbeat(n, factor=factor), JaxHeartbeat(n, factor=factor)
    _beats(ours, beats)
    _beats(theirs, beats)
    assert ours.stragglers(now=now) == theirs.stragglers(now=now)
    for timeout in (0.5, 1.0, 2.5, 10.0):
        assert ours.dead(timeout, now=now) == theirs.dead(timeout, now=now)
    assert ours.intervals == theirs.intervals


def test_heartbeat_straggler_detection():
    hb = Heartbeat(3, factor=3.0)
    _beats(hb, SCENARIOS[0][2])
    assert hb.stragglers(now=9.5) == [2]
    assert hb.dead(timeout_s=5.0, now=9.5) == [2]
