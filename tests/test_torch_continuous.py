"""The port's continuous-batching engine against the JAX reference's.

``ContinuousBatchingServer`` on ``DenseKV``: the per-slot decode attention
against the reference's ``jax.vmap`` of its batch-1 ``decode_attention``;
the engine against the reference engine on ``benchmarks/bench_loadtest.py``'s
spec (tokens per request, counts, doorbells and their payload bytes, the
requests' declared attribution); then the reference's engine, scheduler and
KV tests (``tests/test_serve_engine.py``, the DenseKV and scheduler cases of
``tests/test_kv.py``) on the port, and the two CLIs.

Every wall-clock wait has a timeout of its own; no test paces itself on
wall time.
"""
import dataclasses
import functools
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as REF_SMOKE
from repro.models.attention import decode_attention as ref_decode_attention
from repro.models.transformer import TransformerLM as RefLM
from repro.obs.profile import SpanProfile as RefSpanProfile
from repro.runtime import scheduler as ref_scheduler
from repro.runtime.server import ContinuousBatchingServer as RefEngine
from repro.runtime.server import Request as RefRequest
from repro.runtime.traffic import TrafficSpec as RefSpec
from repro.runtime.traffic import generate as ref_generate
from repro.runtime.traffic import replay as ref_replay
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.launch import loadtest, serve
from repro_torch.models.attention import decode_attention, decode_positions
from repro_torch.models.layers import layer_params
from repro_torch.obs.profile import SpanProfile
from repro_torch.runtime.kv import KV_BACKENDS, DenseKV, make_kv
from repro_torch.runtime.scheduler import (AdmissionQueue, FairSharePolicy,
                                           PriorityPolicy, RequestTicket,
                                           make_policy, percentile)
from repro_torch.runtime.server import (ContinuousBatchingServer, Request,
                                        Server)
from repro_torch.runtime.traffic import TrafficSpec, generate, replay
from repro_torch.weights import params_from_jax

CFG = SMOKE_ARCHS["gemma-2b"]
# benchmarks/bench_loadtest.py's traffic and engine
C1 = dict(n_requests=32, rate=200.0, prompt_lens=(4, 8), new_tokens=(5, 9),
          seed=0)
C1_ENGINE = dict(batch_size=4, max_seq=64)
DOORBELLS = {1: 84, 4: 45, 8: 40}          # BENCH_10's loadtest rows
COUNTS = ("requests", "completed", "evicted", "rejected", "new_tokens",
          "doorbells", "tokens_per_doorbell")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke models' ops are small: one intra-op thread a worker keeps
    this file from crowding the suite's other workers (some of whose tests
    pace themselves on wall time)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mk_request(uid, plen, budget, seed=7, **kw):
    rng = np.random.default_rng(seed + uid)
    return Request(uid, rng.integers(0, CFG.vocab_size,
                                     size=plen).astype(np.int32),
                   max_new_tokens=budget, **kw)


# -- per-slot decode attention ---------------------------------------------

@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-8b"])
def test_per_slot_decode_attention_matches_vmapped_reference(arch):
    """Ragged per-slot lengths, one slot at S-1 and one past it (its write
    clamps to S-1, and every position is valid): out and both caches equal
    the reference's vmap of its batch-1 decode_attention in fp32."""
    cfg = dataclasses.replace(SMOKE_ARCHS[arch], param_dtype="float32")
    ref_cfg = dataclasses.replace(REF_SMOKE[arch], param_dtype="float32")
    ref_params = RefLM(ref_cfg).init_params(jax.random.PRNGKey(0))
    p_ref = jax.tree_util.tree_map(lambda a: a[0],
                                   ref_params["layers"]["attn"])
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params),
                             cfg, "cpu")
    p = layer_params(params["layers"], 0)["attn"]
    B, S = 5, 12
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    shape = (B, S, cfg.n_kv_heads, cfg.hd)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    length = np.array([0, 3, 7, S - 1, S + 4], np.int32)

    def one(x1, k1, v1, n):
        return ref_decode_attention(p_ref, ref_cfg, x1[None], k1[None],
                                    v1[None], n)
    want, want_k, want_v = jax.vmap(one)(x, k, v, length)
    kt, vt = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    got = decode_attention(p, cfg, torch.from_numpy(x), kt, vt,
                           decode_positions(cfg, torch.from_numpy(length),
                                            B, S))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(kt.numpy(), np.asarray(want_k)[:, 0],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(vt.numpy(), np.asarray(want_v)[:, 0],
                               rtol=1e-5, atol=1e-5)
    # the write past the end landed at S-1 and nowhere else
    assert not np.array_equal(kt.numpy()[4, S - 1], k[4, S - 1])
    np.testing.assert_array_equal(kt.numpy()[4, :S - 1], k[4, :S - 1])


# -- engine parity on bench_loadtest's spec --------------------------------

@functools.lru_cache(maxsize=None)
def reference_run(arch, dtype, T):
    cfg = dataclasses.replace(REF_SMOKE[arch], param_dtype=dtype)
    eng = RefEngine(cfg, tokens_per_launch=T, seed=0, **C1_ENGINE)
    tickets, metrics = ref_replay(eng, ref_generate(RefSpec(**C1),
                                                    cfg.vocab_size),
                                  realtime=False)
    return eng, tickets, metrics


def port_run(arch, dtype, T):
    ref, _, _ = reference_run(arch, dtype, T)
    cfg = dataclasses.replace(SMOKE_ARCHS[arch], param_dtype=dtype)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref.params),
                             cfg, "cpu")
    eng = ContinuousBatchingServer(cfg, tokens_per_launch=T, device="cpu",
                                   params=params, **C1_ENGINE)
    tickets, metrics = replay(eng, generate(TrafficSpec(**C1),
                                            cfg.vocab_size), realtime=False)
    return eng, tickets, metrics


def payload_by_name(session):
    out = {}
    for e in session.timeline(kinds="dispatch"):
        n, b = out.get(e.name, (0, 0))
        out[e.name] = (n + 1, b + e.payload_bytes)
    return out


def request_attribution(profile):
    req = profile.snapshot()["spans"]["serve.request"]
    return {k: req[k] for k in ("spans", "doorbells", "payload_bytes",
                                "graph_launches")}


@pytest.mark.parametrize("T", [1, 4, 8])
@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-780m"])
def test_engine_matches_reference_fp32(arch, T):
    ref, ref_tix, want = reference_run(arch, "float32", T)
    eng, tix, got = port_run(arch, "float32", T)
    assert [t.tokens for t in tix] == [t.tokens for t in ref_tix]
    assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}
    assert (got["new_tokens"], got["doorbells"]) == (224, DOORBELLS[T])
    assert payload_by_name(eng.session) == payload_by_name(ref.session)
    assert set(payload_by_name(eng.session)) == {"prefill", "decode_slots"}
    assert got["kv"] == want["kv"]
    assert request_attribution(SpanProfile.from_events(
        eng.session.timeline())) == request_attribution(
            RefSpanProfile.from_events(ref.session.timeline()))


def bf16_step(x):
    """One bf16 step (unit in the last place) at magnitude |x|."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


@pytest.mark.parametrize("T", [1, 4, 8])
def test_engine_bf16_counts_equal_and_tokens_up_to_near_ties(T):
    """bf16 gemma-smoke: counts and payloads equal; a request whose tokens
    differ must first differ where the reference's one-shot logits hold a
    near-tie (top-2 gap below one bf16 step of the top logit)."""
    ref, ref_tix, want = reference_run("gemma-2b", "bfloat16", T)
    eng, tix, got = port_run("gemma-2b", "bfloat16", T)
    assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}
    assert payload_by_name(eng.session) == payload_by_name(ref.session)
    model = RefLM(dataclasses.replace(REF_SMOKE["gemma-2b"],
                                      param_dtype="bfloat16"))
    for mine, theirs in zip(tix, ref_tix):
        if mine.tokens == theirs.tokens:
            continue
        j = next(i for i, (a, b) in enumerate(zip(mine.tokens,
                                                  theirs.tokens)) if a != b)
        state, logits = model.prefill(ref.params, jnp.asarray(
            theirs.request.prompt[None]), C1_ENGINE["max_seq"])
        for t in theirs.tokens[:j]:
            state, logits = model.decode_step(ref.params, state,
                                              jnp.asarray([[t]], jnp.int32))
        top = np.sort(np.asarray(logits[0, -1], np.float32))[-2:]
        assert top[1] - top[0] < bf16_step(top[1]), (mine.uid, j, top)


# -- the reference's engine tests on the port -------------------------------

@pytest.fixture(scope="module")
def engine():
    return ContinuousBatchingServer(CFG, batch_size=2, max_seq=32,
                                    tokens_per_launch=3, seed=1,
                                    max_pending=8, device="cpu")


@pytest.fixture(scope="module")
def solo(engine):
    """One-shot single-request decoder on the engine's params."""
    return Server(CFG, batch_size=1, max_seq=32, tokens_per_launch=1,
                  device="cpu", params=engine.params)


def test_continuous_tokens_equal_oneshot_per_request(engine, solo):
    """5 requests through 2 slots: joins/leaves mid-decode, heterogeneous
    prompt lengths and budgets — every token stream identical to a solo
    one-shot serve of the same request."""
    shapes = [(3, 4), (5, 7), (8, 5), (3, 7), (5, 4)]
    reqs = [mk_request(i, p, b) for i, (p, b) in enumerate(shapes)]
    tickets = [engine.submit(r) for r in reqs]
    out = engine.run(idle_timeout_s=0.0)
    assert out["completed"] == 5 and out["evicted"] == 0
    assert out["new_tokens"] == sum(b for _, b in shapes)
    assert out["tokens_per_doorbell"] == pytest.approx(
        out["new_tokens"] / out["doorbells"])
    for r, t in zip(reqs, tickets):
        assert t.status == "done" and len(t.tokens) == r.max_new_tokens
        ref = Request(r.uid, r.prompt, max_new_tokens=r.max_new_tokens)
        solo.serve([ref])
        assert t.tokens == ref.tokens, f"uid={r.uid} diverged"
        assert r.tokens == t.tokens          # mirrored onto the Request


def test_continuous_decode_captured_once_across_churn(engine):
    """Join/leave churn never makes another decode step: the engine's one
    decode step survives, and prefill steps number the distinct prompt
    lengths, none per slot."""
    decode = engine.graphs()["decode T=3"]
    tix = [engine.submit(mk_request(100 + i, 3 + i % 2, 2)) for i in range(5)]
    engine.run(idle_timeout_s=0.0)
    assert all(t.status == "done" for t in tix)
    assert engine.graphs()["decode T=3"] is decode
    lens = {len(t.request.prompt) for t in engine.tickets
            if t.status == "done"}
    assert sorted(k for k in engine.graphs() if k.startswith("prefill")) == \
        sorted(f"prefill S={n}" for n in lens)


def test_admission_rejects_when_queue_full(engine):
    tix = [engine.submit(mk_request(200 + i, 3, 2)) for i in range(11)]
    rejected = [t for t in tix if t.status == "rejected"]
    assert len(rejected) == 3
    assert all(t.reason == "queue_full" for t in rejected)
    out = engine.run(idle_timeout_s=0.0)
    assert out["completed"] == 8
    assert all(t.status in ("done", "rejected") for t in tix)


def test_admission_rejects_prompt_longer_than_max_seq(engine):
    t = engine.submit(mk_request(300, 33, 2))        # max_seq is 32
    assert t.status == "rejected" and t.reason == "prompt_exceeds_max_seq"
    assert engine.run(idle_timeout_s=0.0)["requests"] == 0


def test_eviction_on_kv_overrun_truncates_to_capacity():
    eng = ContinuousBatchingServer(CFG, batch_size=2, max_seq=8,
                                   tokens_per_launch=2, seed=1, device="cpu")
    ok = eng.submit(mk_request(0, 4, 3))             # fits: cap=5
    greedy = eng.submit(mk_request(1, 6, 10))        # cap = 8-6+1 = 3
    out = eng.run(idle_timeout_s=0.0)
    assert ok.status == "done" and len(ok.tokens) == 3
    assert greedy.status == "evicted" and greedy.reason == "kv_overrun"
    assert len(greedy.tokens) == 3
    assert out["completed"] == 1 and out["evicted"] == 1
    solo = Server(CFG, batch_size=1, max_seq=8, tokens_per_launch=1,
                  device="cpu", params=eng.params)
    ref = Request(1, greedy.request.prompt, max_new_tokens=3)
    solo.serve([ref])
    assert greedy.tokens == ref.tokens


def test_threaded_replay_requests_join_running_decode():
    """Realtime replay: a producer thread submits arrivals while the decode
    loop runs; everything lands on one session timeline."""
    eng = ContinuousBatchingServer(CFG, batch_size=2, max_seq=16,
                                   tokens_per_launch=2, seed=1, device="cpu")
    spec = TrafficSpec(n_requests=8, rate=400.0, prompt_lens=(4,),
                       new_tokens=(3, 5), seed=3)
    tickets, out = replay(eng, generate(spec, CFG.vocab_size),
                          realtime=True, idle_timeout_s=10.0)
    assert len(tickets) == 8 and out["completed"] == 8
    assert out["latency_p99_s"] >= out["latency_p50_s"] >= 0.0
    names = {e.name for e in eng.session.timeline(kinds="progress")}
    assert {"serve.submit", "serve.admit", "serve.finish"} <= names
    assert eng.queue.closed


def test_engine_live_summary_reflects_run():
    eng = ContinuousBatchingServer(CFG, batch_size=2, max_seq=32,
                                   tokens_per_launch=2, device="cpu")
    assert eng.live_summary()["engine"]["active"] == 0
    rng = np.random.default_rng(0)
    for uid in range(3):
        eng.submit(Request(uid, rng.integers(
            0, CFG.vocab_size, size=4).astype(np.int32), max_new_tokens=4))
    eng.close_intake()
    eng.run()
    after = eng.live_summary()
    assert after["engine"]["tickets"]["done"] == 3
    assert after["engine"]["active"] == 0
    assert after["engine"]["tokens_emitted"] == 12
    assert after["by_kind"]["dispatch"] >= 1
    assert after["events"] == eng.session.summary()["events"]


def test_live_endpoint_serves_engine_state():
    import urllib.request
    eng = ContinuousBatchingServer(CFG, batch_size=1, max_seq=16,
                                   tokens_per_launch=1, device="cpu")
    eng.submit(mk_request(0, 4, 2))
    eng.run(idle_timeout_s=0.0)
    try:
        srv = eng.start_live_endpoint()
    except OSError:
        pytest.skip("cannot bind localhost in this environment")
    try:
        with urllib.request.urlopen(f"{srv.url}/summary", timeout=10) as r:
            got = json.loads(r.read())
    finally:
        eng.stop_live_endpoint()
    assert got["engine"]["tickets"]["done"] == 1
    assert got["by_name"]["serve.finish"]["payload_bytes"] == 8


@pytest.mark.parametrize("sched", ["priority", "fair"])
def test_engine_scheduling_end_to_end(sched):
    """One slot, everything queued before the loop starts: priority admits
    the highest first; fair share admits the least-served user next."""
    eng = ContinuousBatchingServer(CFG, batch_size=1, max_seq=32,
                                   tokens_per_launch=2, seed=0, sched=sched,
                                   device="cpu")
    if sched == "priority":
        reqs = [mk_request(i, 4, 3, priority=i) for i in range(4)]
        want = [3, 2, 1, 0]
    else:
        users = ["a", "a", "b", "b"]
        budgets = [9, 9, 2, 2]
        reqs = [mk_request(i, 4, budgets[i], user=users[i]) for i in range(4)]
        want = [0, 2, 3, 1]
    tix = [eng.submit(r) for r in reqs]
    eng.run(idle_timeout_s=0.0)
    assert [t.uid for t in sorted(tix, key=lambda t: t.t_admit)] == want


def test_make_kv_rejects_unknown_paged_and_chunked():
    """An unknown backend is refused; the paged backend and a chunked
    dense one build on an engine (tests/test_torch_kv.py serves them)."""
    with pytest.raises(ValueError, match="backend"):
        make_kv(object.__new__(ContinuousBatchingServer), "compressed")
    eng = ContinuousBatchingServer(CFG, batch_size=2, max_seq=16,
                                   prefill_chunk=4, device="cpu")
    assert isinstance(eng.kv, DenseKV) and eng.kv.chunk == 4
    paged = make_kv(eng, "paged", page_tokens=8)
    assert paged.name == "paged" and paged.stats()["pages_total"] == 4
    assert DenseKV(eng, prefill_chunk=8).stats() == {
        "backend": "dense", "prefill_chunk": 8, "prefill_launches": 0,
        "prefill_chunk_launches": 0, "prefill_tokens": 0,
        "prefill_payload_bytes": 0, "chunked_prompts": 0}
    assert KV_BACKENDS == ("dense", "paged")


def test_engine_refuses_another_param_tree():
    eng = ContinuousBatchingServer(CFG, batch_size=1, max_seq=8,
                                   device="cpu")
    other = Server(CFG, batch_size=1, max_seq=8, device="cpu", seed=1).params
    with pytest.raises(ValueError, match="own params"):
        eng.kv._decode_slots(other, eng.kv.slots, eng.kv._nxt)


# -- scheduler (host code) --------------------------------------------------

def _tickets(*specs, ref=False):
    """(uid, priority, user, budget) -> tickets of the port, or of the
    reference with ``ref``."""
    request, ticket = ((RefRequest, ref_scheduler.RequestTicket) if ref
                       else (Request, RequestTicket))
    return [ticket(request=request(uid=uid, prompt=np.zeros(4, np.int32),
                                   max_new_tokens=budget, priority=prio,
                                   user=user))
            for uid, prio, user, budget in specs]


def test_admission_queue_drop_oldest_policy():
    q = AdmissionQueue(max_pending=2, policy="drop_oldest")
    t = [RequestTicket(request=mk_request(i, 2, 1)) for i in range(3)]
    assert q.submit(t[0]) == (True, None)
    assert q.submit(t[1]) == (True, None)
    accepted, dropped = q.submit(t[2])
    assert accepted and dropped is t[0]
    assert q.pop() is t[1] and q.pop() is t[2] and q.pop() is None
    assert q.n_dropped == 1


def test_admission_queue_close_refuses_and_unknown_policy_raises():
    q = AdmissionQueue(max_pending=2, policy="reject")
    q.close()
    assert q.submit(RequestTicket(request=mk_request(0, 2, 1))) == (False,
                                                                    None)
    assert q.n_refused == 1
    with pytest.raises(ValueError, match="policy"):
        AdmissionQueue(policy="lifo")


def test_percentile_interpolation_matches_reference():
    for xs in ([0.0, 1.0, 2.0, 3.0], [5.0], [], [-1.0, 2.0],
               list(np.random.default_rng(1).exponential(size=101))):
        for p in (50.0, 90.0, 99.0):
            assert percentile(xs, p) == ref_scheduler.percentile(xs, p)
    assert percentile([0.0, 1.0, 2.0, 3.0], 99.0) == pytest.approx(2.97)


SPECS = [(0, 0, "a", 100), (1, 5, "a", 100), (2, 5, "b", 1),
         (3, 1, "b", 1), (4, 7, "c", 3), (5, 0, "a", 2)]


@pytest.mark.parametrize("policy", ["fifo", "priority", "fair"])
def test_policy_admission_order_matches_reference(policy):
    orders = []
    for ref in (False, True):
        queue, policy_of = ((ref_scheduler.AdmissionQueue,
                             ref_scheduler.make_policy) if ref
                            else (AdmissionQueue, make_policy))
        q = queue(max_pending=8)
        for t in _tickets(*SPECS, ref=ref):
            q.submit(t)
        pol = policy_of(policy)
        orders.append([q.pop(pol).uid for _ in SPECS])
    assert orders[0] == orders[1]
    if policy == "priority":
        assert orders[0][:3] == [4, 1, 2]      # FIFO among equals


def test_fair_share_reconciles_actual_tokens_on_finish():
    pol = FairSharePolicy()
    (t,) = _tickets((0, 0, "a", 100))
    pol.note_admitted(t)
    assert pol._served["a"] == 100
    t.tokens = [7, 7, 7]
    pol.note_finished(t)
    assert pol._served["a"] == 3
    (u,) = _tickets((1, 0, "b", 5))
    pol.note_finished(u)                # never admitted: no-op
    assert "b" not in pol._served


def test_fair_share_ledger_bounded():
    pol = FairSharePolicy(max_users=2)
    for t in _tickets(*[(i, 0, f"u{i}", 1) for i in range(5)]):
        pol.note_admitted(t)
        t.tokens = [1]
        pol.note_finished(t)
    assert len(pol._served) <= 2
    assert not pol._inflight


def test_make_policy_names_and_unknown():
    for name in ("fifo", "priority", "fair"):
        assert make_policy(name).name == name
    with pytest.raises(ValueError, match="policy"):
        make_policy("sjf")


def test_peek_matches_pop_and_pop_keeps_drop_oldest():
    q = AdmissionQueue(max_pending=8)
    for t in _tickets((0, 0, "", 4), (1, 7, "", 4)):
        q.submit(t)
    pol = PriorityPolicy()
    assert q.peek(pol).uid == 1 and len(q) == 2
    assert q.pop(pol).uid == 1
    assert q.peek().uid == 0
    q = AdmissionQueue(max_pending=2, policy="drop_oldest")
    ts = _tickets((0, 9, "", 4), (1, 0, "", 4), (2, 0, "", 4))
    q.submit(ts[0])
    q.submit(ts[1])
    ok, dropped = q.submit(ts[2])
    assert ok and dropped is ts[0] and q.n_dropped == 1
    assert q.pop(PriorityPolicy()).uid == 1


def _wake(q, action):
    def late():
        time.sleep(0.05)
        action()
    threading.Thread(target=late, daemon=True).start()
    t0 = time.perf_counter()
    assert q.wait_for_work(timeout=5.0)
    return time.perf_counter() - t0


def test_wait_for_work_wakes_on_submit_and_close():
    q = AdmissionQueue(max_pending=4)
    (t,) = _tickets((0, 0, "", 4))
    assert _wake(q, lambda: q.submit(t)) < 2.0   # on notify, not timeout
    q = AdmissionQueue(max_pending=4)
    assert _wake(q, q.close) < 2.0
    assert q.closed


def test_wait_for_work_times_out_empty():
    q = AdmissionQueue(max_pending=4)
    t0 = time.perf_counter()
    assert not q.wait_for_work(timeout=0.05)
    assert time.perf_counter() - t0 >= 0.04


def test_traffic_equals_reference_and_is_deterministic():
    spec = dict(n_requests=32, rate=100.0, prompt_lens=(4, 8),
                new_tokens=(2, 6), seed=11, prefix_len=3)
    a = generate(TrafficSpec(**spec), CFG.vocab_size)
    b = ref_generate(RefSpec(**spec), CFG.vocab_size)
    assert [x.t for x in a] == [x.t for x in b]
    assert all(np.array_equal(x.request.prompt, y.request.prompt)
               for x, y in zip(a, b))
    assert [x.request.max_new_tokens for x in a] == \
        [y.request.max_new_tokens for y in b]
    c = generate(TrafficSpec(**{**spec, "seed": 12}), CFG.vocab_size)
    assert [x.t for x in a] != [x.t for x in c]
    assert TrafficSpec(**spec).to_dict() == RefSpec(**spec).to_dict()


# -- the CLIs ---------------------------------------------------------------

def test_loadtest_cli_quick_verifies_on_cpu(tmp_path, capsys):
    out = tmp_path / "lt.json"
    assert loadtest.main(["--quick", "--device", "cpu", "--verify", "4",
                          "--json", str(out)]) == 0
    assert "equivalence: OK" in capsys.readouterr().out
    record = json.loads(out.read_text())
    assert record["verified"] == {"n": 4, "ok": True}
    assert record["metrics"]["completed"] == 16
    assert record["span_profile"]["spans"]["serve.request"]["spans"] == 16


def test_loadtest_cli_refuses_paged_and_chunked(capsys):
    """Paged and chunked serving were refused until they were ported; now
    the quick replay runs them with a shared prefix and verifies against
    the one-shot server."""
    assert loadtest.main(["--quick", "--device", "cpu", "--kv", "paged",
                          "--prefill-chunk", "4", "--prefix-len", "8",
                          "--verify", "4"]) == 0
    text = capsys.readouterr().out
    assert "equivalence: OK" in text
    assert "kv=paged chunk=4" in text and "kv[paged]" in text


def test_serve_cli_continuous_on_cpu(tmp_path, capsys):
    trace = tmp_path / "serve.jsonl"
    serve.main(["--smoke", "--continuous", "--device", "cpu", "--requests",
                "5", "--profile", "--trace", str(trace)])
    text = capsys.readouterr().out
    assert "'completed': 5" in text and "SPAN PROFILE serve" in text
    assert trace.exists()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-780m"])
def test_engine_on_card_equals_cpu_counts(arch):
    """On a card: bench_loadtest's spec gives the reference's counts, and
    the decode graph is the one captured when the engine was built."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = SMOKE_ARCHS[arch]
    eng = ContinuousBatchingServer(cfg, tokens_per_launch=4, device="cuda",
                                   **C1_ENGINE)
    graph = eng.graphs()["decode T=4"].graph
    _, m = replay(eng, generate(TrafficSpec(**C1), cfg.vocab_size),
                  realtime=False)
    assert (m["completed"], m["new_tokens"], m["doorbells"]) == (32, 224, 45)
    assert eng.graphs()["decode T=4"].graph is graph is not None
