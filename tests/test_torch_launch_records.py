"""The continuous engine's launch records: every graph launch timed from
inside the program and tied to the requests it served.

``benchmarks/bench_loadtest.py``'s spec (the C1 spec of
``tests/test_torch_continuous.py``) through the engine on gemma-2b and the
qwen2-moe smoke model, at T=1 and T=4, on the dense, paged and chunked
backends.  On the CPU a step runs synchronously and its stamps are
``perf_counter`` readings at its head and tail, so each record lies inside
its doorbell's host interval, and the records of one engine never overlap.
"""
import collections

import numpy as np
import pytest
import torch

from repro_torch.configs import SMOKE_ARCHS
from repro_torch.core.session import SPAN_EVENT, TraceSession
from repro_torch.runtime.server import ContinuousBatchingServer, Request
from repro_torch.runtime.traffic import TrafficSpec, generate, replay

C1 = dict(n_requests=32, rate=200.0, prompt_lens=(4, 8), new_tokens=(5, 9),
          seed=0)
C1_ENGINE = dict(batch_size=4, max_seq=64)
BACKENDS = {"dense": dict(kv="dense"),
            "paged": dict(kv="paged", kv_page_tokens=8),
            "chunked": dict(kv="dense", prefill_chunk=4)}
# the doorbell each graph rings
DOORBELL = {"prefill": "prefill S=", "prefill_extend": "extend C=",
            "decode_slots": "decode T="}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def records(tickets):
    """Every ticket's launch records, a shared one once, in launch order."""
    got = {id(r): r for t in tickets for r in t.launches}
    return sorted(got.values(), key=lambda r: r.t_enqueue)


def spans(session, name):
    return [e for e in session.timeline()
            if e.name == SPAN_EVENT and e.meta.get("span") == name]


@pytest.fixture(scope="module", params=[
    (arch, T, backend) for arch in ("gemma-2b", "qwen2-moe-a2.7b")
    for T in (1, 4) for backend in BACKENDS],
    ids=lambda p: "-".join(map(str, p)))
def served(request):
    arch, T, backend = request.param
    cfg = SMOKE_ARCHS[arch]
    eng = ContinuousBatchingServer(
        cfg, tokens_per_launch=T, device="cpu",
        session=TraceSession(name="launch_records", ring_size=1 << 14),
        **C1_ENGINE, **BACKENDS[backend])
    tickets, out = replay(eng, generate(TrafficSpec(**C1), cfg.vocab_size),
                          realtime=False)
    assert out["completed"] == C1["n_requests"]
    return eng, tickets, out


def test_one_record_per_launch(served):
    eng, tickets, out = served
    for t in tickets:
        assert sum(not r.decode for r in t.launches) == t.n_prefill_launches
        assert sum(r.decode for r in t.launches) == t.n_launches
        for r in t.launches:
            if not r.decode:
                assert r.uid == t.uid and r.tokens > 0
    pre = [r for r in records(tickets) if not r.decode]
    assert sum(r.tokens for r in pre) == out["kv"]["prefill_tokens"]
    assert len(records(tickets)) == out["doorbells"]


def test_riders_share_one_record(served):
    _, tickets, _ = served
    holders = collections.defaultdict(list)
    for t in tickets:
        for r in t.launches:
            holders[id(r)].append(t.uid)
    for r in records(tickets):
        if r.decode:
            assert sorted(holders[id(r)]) == sorted(r.uids)
            assert len(set(r.uids)) == len(r.uids) == len(r.lengths)
        else:
            assert holders[id(r)] == [r.uid]


def test_records_in_order_inside_their_doorbells(served):
    eng, tickets, _ = served
    recs = records(tickets)
    bells = eng.session.timeline(kinds="dispatch")
    assert len(bells) == len(recs)
    eps = 1e-9                      # one rebasing onto the session's clock
    for e, r in zip(bells, recs):
        assert r.graph.startswith(DOORBELL[e.name])
        t0 = eng.session.t0 + e.t
        assert t0 - eps <= r.t_enqueue <= r.t_start <= r.t_end \
            <= r.t_return <= t0 + e.dur_s + eps
    for a, b in zip(recs, recs[1:]):
        assert a.t_end <= b.t_start
    events = eng.session.timeline(kinds="graph_launch")
    assert [(e.name, e.meta["device_s"]) for e in events] == \
        [(r.graph, r.device_s) for r in recs]
    for e, r in zip(events, recs):
        assert eng.session.t0 + e.meta["device_start"] == \
            pytest.approx(r.t_start, abs=eps)


def test_decode_iter_carries_riders_and_lengths(served):
    eng, tickets, _ = served
    T = eng.T
    decodes = [r for r in records(tickets) if r.decode]
    iters = spans(eng.session, "serve.decode_iter")
    assert len(iters) == len(decodes)
    for e, r in zip(iters, decodes):
        assert e.meta["slots"] == len(r.uids)
        assert e.meta["kv_tokens"] == sum(r.lengths)
        assert e.meta["device_s"] == r.device_s > 0
        assert e.meta["launch_latency_s"] == r.launch_latency_s >= 0
    # a rider's k-th decode reads its prompt and the 1 + k T tokens before
    for t in tickets:
        rode = [r for r in t.launches if r.decode]
        got = [r.lengths[r.uids.index(t.uid)] for r in rode]
        plen = len(t.request.prompt)
        assert got == [plen + k * T for k in range(len(rode))]


def test_request_span_carries_device_time(served):
    eng, tickets, _ = served
    by_uid = {t.uid: t for t in tickets}
    closed = spans(eng.session, "serve.request")
    assert len(closed) == len(tickets)
    for e in closed:
        t = by_uid[e.meta["uid"]]
        assert e.meta["prefill_device_s"] == pytest.approx(
            sum(r.device_s for r in t.launches if not r.decode))
        assert e.meta["decode_device_s"] == pytest.approx(
            sum(r.device_s for r in t.launches if r.decode))
        assert e.meta["prefill_device_s"] > 0 and e.meta["decode_device_s"] > 0


def test_chunks_with_nothing_decoding_are_read_before_the_next_replay():
    """One 12-token prompt in chunks of 4 and nothing else: the extend
    graph replays with its stamps unread (no host sync between the chunks),
    and each chunk's record is read first, in order, without overlap."""
    cfg = SMOKE_ARCHS["gemma-2b"]
    eng = ContinuousBatchingServer(cfg, tokens_per_launch=2, device="cpu",
                                   prefill_chunk=4, **C1_ENGINE)
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=12).astype(np.int32)
    t = eng.submit(Request(0, prompt, max_new_tokens=3))
    eng.run(idle_timeout_s=0.0)
    assert t.status == "done"
    assert [r.graph for r in t.launches] == ["extend C=4"] * 3 + \
        ["decode T=2"]
    assert [r.tokens for r in t.launches[:3]] == [4, 4, 4]
    for a, b in zip(t.launches, t.launches[1:]):
        assert a.t_enqueue <= a.t_start <= a.t_end <= b.t_start
    assert len(eng.session.timeline(kinds="graph_launch")) == 4


def test_device_time_of_a_cpu_stamp_and_without_an_anchor():
    sess = TraceSession(name="clock")
    assert sess.device_time(12.5) == 12.5
    sess.anchor(torch.device("cpu"))            # nothing to tie on the CPU
    with pytest.raises(RuntimeError):
        sess.device_time(object())
