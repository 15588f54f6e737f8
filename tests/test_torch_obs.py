"""The port's observability plane (``repro_torch.obs``) against ``repro.obs``.

Case for case after ``tests/test_obs.py``, ``test_obs_property.py``,
``test_profile.py`` and ``test_trajectory.py``: each case runs its scenario
through both packages on the same seeded input — the same emitted events,
the same event stream replayed from its dicts, the same shard files, the
same BENCH artifacts — and holds the port's result to the reference's (and
to the reference test's own checks).  Where the result depends on thread
timing (an overrun async queue), both are held to the same invariants.
"""
import importlib
import json
import math
import os
import random
import threading
import time
import types

import pytest

import repro.core as ref_core
import repro.obs as ref_obs
import repro_torch.core as core
import repro_torch.obs as obs

# the modules (``obs.aggregate`` is also the name of a function)
ref_aggregate, ref_export, ref_store, ref_trajectory = (
    importlib.import_module(f"repro.obs.{m}")
    for m in ("aggregate", "export", "store", "trajectory"))
aggregate_mod, export_mod, store_mod, trajectory_mod = (
    importlib.import_module(f"repro_torch.obs.{m}")
    for m in ("aggregate", "export", "store", "trajectory"))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = types.SimpleNamespace(core=core, obs=obs, aggregate=aggregate_mod,
                             export=export_mod, store=store_mod,
                             trajectory=trajectory_mod)
REF = types.SimpleNamespace(core=ref_core, obs=ref_obs,
                            aggregate=ref_aggregate, export=ref_export,
                            store=ref_store, trajectory=ref_trajectory)
BOTH = [PORT, REF]


def dicts(events):
    return [e.to_dict() for e in events]


def replayed(pkg, event_dicts):
    """The same event stream as ``pkg``'s TraceEvents."""
    return [pkg.core.TraceEvent.from_dict(d) for d in event_dicts]


# -- AsyncSink ---------------------------------------------------------------

def _async_forward(pkg):
    ring = pkg.core.RingBufferSink(maxlen=100000)
    a = pkg.obs.AsyncSink(ring, maxsize=100000)
    sess = pkg.core.TraceSession("async", sinks=[a])
    for i in range(500):
        sess.emit("dispatch", f"d{i}", payload_bytes=1)
    a.close()
    return a.stats(), [e.name for e in ring.events()]


def test_async_sink_forwards_everything_when_not_overrun():
    (st, names), want = (_async_forward(p) for p in BOTH)
    assert (st, names) == want
    assert st["offered"] == st["forwarded"] == st["enqueued"] == 500
    assert st["dropped"] == 0 and names[:3] == ["d0", "d1", "d2"]


@pytest.mark.parametrize("pkg", BOTH, ids=["port", "ref"])
def test_async_sink_threaded_storm_exact_accounting(pkg):
    """A threaded storm into a tiny queue: what drops depends on thread
    timing, so each package is held to the same exact invariants."""
    ring = pkg.core.RingBufferSink(maxlen=1 << 20)
    a = pkg.obs.AsyncSink(ring, maxsize=64)
    sess = pkg.core.TraceSession("storm", sinks=[a])
    n_threads, per_thread = 8, 500
    barrier = threading.Barrier(n_threads)

    def worker(tid):
        barrier.wait()
        for _ in range(per_thread):
            sess.emit("progress", f"w{tid}")

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    a.close(timeout_s=30)
    st = a.stats()
    total = n_threads * per_thread
    assert st["offered"] == total
    assert st["enqueued"] + st["dropped"] == total
    assert st["forwarded"] == st["enqueued"] and st["pending"] == 0
    assert ring.stats()["emitted"] == st["forwarded"]
    assert sess.n_events == total


def _async_flush(pkg, tmp_path):
    path = str(tmp_path / f"{pkg.core.__name__}.jsonl")
    a = pkg.obs.AsyncSink(pkg.core.JsonlSink(path), maxsize=1024)
    sess = pkg.core.TraceSession("fl", sinks=[a])
    for _ in range(50):
        sess.emit("dispatch", "d")
    drained = a.flush(timeout_s=30)
    on_disk = len(ref_core.JsonlSink.load(path))     # the reference's loader
    a.close()
    sess.emit("dispatch", "late")
    st = a.stats()
    st["inner"].pop("path")
    return drained, on_disk, st, len(ref_core.JsonlSink.load(path))


def test_async_sink_flush_drains_and_emit_after_close_is_counted(tmp_path):
    got, want = (_async_flush(p, tmp_path) for p in BOTH)
    assert got == want
    drained, on_disk, st, after = got
    assert drained and on_disk == after == 50
    assert st["offered"] == 51 and st["dropped"] == 1


def _async_broken(pkg):
    class Broken:
        def emit(self, e):
            raise IOError("disk full")

    a = pkg.obs.AsyncSink(Broken(), maxsize=16)
    sess = pkg.core.TraceSession("broken", sinks=[a])
    for _ in range(5):
        sess.emit("dispatch", "d")
    a.close()
    return a.stats()


def test_async_sink_swallows_backend_errors():
    st, want = (_async_broken(p) for p in BOTH)
    assert st == want
    assert st["write_errors"] == 5 and st["forwarded"] == st["enqueued"]


# -- SamplingSink ------------------------------------------------------------

def _sampling(pkg, barrier):
    ring = pkg.core.RingBufferSink()
    every = {"progress": 1000} if barrier else {"dispatch": 10, "progress": 3}
    s = pkg.obs.SamplingSink(ring, every=every)
    sess = pkg.core.TraceSession("samp", sinks=[s])
    if barrier:
        for _ in range(5):
            sess.emit("progress", "noise")
        sess.barrier("sync")
    else:
        for i in range(100):
            sess.emit("dispatch", f"d{i}")
        for i in range(10):
            sess.emit("progress", f"p{i}")
        sess.emit("transfer", "t")
    return s.stats(), [(e.kind, e.name) for e in ring.events()]


@pytest.mark.parametrize("barrier", [False, True],
                         ids=["per_kind_counts", "barriers_kept"])
def test_sampling_sink_matches_reference(barrier):
    (st, kept), want = (_sampling(p, barrier) for p in BOTH)
    assert (st, kept) == want
    if barrier:
        assert ("progress", "obs.barrier") in kept
        assert st["kept"]["progress"] == 2
    else:
        assert st["sampled_away"] == {"dispatch": 90, "progress": 6,
                                      "transfer": 0}
        assert [n for k, n in kept if k == "dispatch"] == \
            [f"d{i}" for i in range(0, 100, 10)]


# -- aggregation -------------------------------------------------------------

def _make_shards(tmp_path, n_shards=3, events_per=20, pkg=PORT):
    """n tagged shards, written by ``pkg``'s session, with one shared
    barrier and skewed clocks."""
    paths = []
    for p in range(n_shards):
        path = str(tmp_path / f"shard{p}.jsonl")
        with pkg.core.TraceSession(f"w{p}", jsonl_path=path,
                                   tags={"host": "hostA", "process": p}) as s:
            s.barrier("start")
            for _ in range(events_per):
                s.emit("dispatch", f"step{p}", dur_s=1e-4, payload_bytes=8)
            s.emit("transfer", f"mv{p}", payload_bytes=100 * (p + 1))
        paths.append(path)
        time.sleep(0.002)
    return paths


def merged_view(merged):
    return (dicts(merged.events),
            [(s.shard_id, s.offset_s, s.align_mode) for s in merged.shards],
            merged.summary())


@pytest.mark.parametrize("writer", [PORT, REF], ids=["port_shards",
                                                     "ref_shards"])
def test_aggregate_merge_equals_reference(tmp_path, writer):
    """Shards written by either package merge the same in both."""
    paths = _make_shards(tmp_path, pkg=writer)
    got, want = (merged_view(p.aggregate.aggregate(paths)) for p in BOTH)
    assert got == want


def test_aggregate_summary_is_elementwise_sum_of_shards(tmp_path):
    merged = obs.aggregate(_make_shards(tmp_path))
    ms = merged.summary()
    shard_sums = [obs.summarize(sh.events) for sh in merged.shards]
    assert ms["events"] == sum(s["events"] for s in shard_sums)
    for kind in ("dispatch", "transfer", "progress"):
        assert ms["by_kind"].get(kind, 0) == \
            sum(s["by_kind"].get(kind, 0) for s in shard_sums)
        assert ms["payload_by_kind"].get(kind, 0) == \
            sum(s["payload_by_kind"].get(kind, 0) for s in shard_sums)
    assert ms["total_payload_bytes"] == \
        sum(s["total_payload_bytes"] for s in shard_sums)
    assert [ref_aggregate.summarize(replayed(REF, dicts(sh.events)))
            for sh in merged.shards] == shard_sums


def test_aggregate_orders_by_aligned_clock_and_tags_provenance(tmp_path):
    merged = obs.aggregate(_make_shards(tmp_path, n_shards=2, events_per=5))
    ts = [e.t for e in merged.events]
    assert ts == sorted(ts)
    assert [e.seq for e in merged.events] == list(range(len(merged.events)))
    assert {e.meta["shard"] for e in merged.events} == {"hostA/p0",
                                                        "hostA/p1"}
    modes = {sh.shard_id: sh.align_mode for sh in merged.shards}
    assert modes == {"hostA/p0": "reference", "hostA/p1": "barrier"}
    barriers = [e for e in merged.events if e.name == "obs.barrier"]
    assert len(barriers) == 2 and abs(barriers[0].t - barriers[1].t) < 1e-6


def test_aggregate_is_stable_under_remerge(tmp_path):
    merged = obs.aggregate(_make_shards(tmp_path, n_shards=2, events_per=8))
    out = str(tmp_path / "merged.jsonl")
    merged.save(out)
    again, ref_again = (p.aggregate.aggregate([out]) for p in BOTH)
    assert dicts(again.events) == dicts(ref_again.events)
    assert [(e.seq, e.name, e.kind) for e in again.events] == \
        [(e.seq, e.name, e.kind) for e in merged.events]
    assert [e.t for e in again.events] == \
        pytest.approx([e.t for e in merged.events])


def test_aggregate_shuffled_shard_files_resorted_by_seq(tmp_path):
    paths = _make_shards(tmp_path, n_shards=2, events_per=10)
    with open(paths[1]) as f:
        lines = f.readlines()
    random.Random(0).shuffle(lines)
    with open(paths[1], "w") as f:
        f.writelines(lines)
    got, want = (merged_view(p.aggregate.aggregate(paths)) for p in BOTH)
    assert got == want
    p1 = [d["meta"]["src_seq"] for d in got[0]
          if d["meta"]["shard"] == "hostA/p1"]
    assert p1 == sorted(p1)


@pytest.mark.parametrize("seed", range(4))
def test_aggregate_arbitrary_skew_matches_reference(tmp_path, seed):
    """The property test's construction (two shards, arbitrary clock skews,
    shuffled files) on seeded draws: a merge monotonic in the aligned
    clock, barriers together, a fixed point under re-merge, and equal to
    the reference's."""
    rng = random.Random(seed)
    n = rng.randint(1, 40)
    true_times = sorted(rng.uniform(0.001, 100.0) for _ in range(n))
    assign = [rng.randint(0, 1) for _ in range(n)]
    skews = (rng.uniform(-50, 50), rng.uniform(-50, 50))
    paths = []
    for p in (0, 1):
        events = [core.TraceEvent(seq=0, kind="progress", name="obs.barrier",
                                  t=0.0 - skews[p],
                                  meta={"process": p, "barrier": "b0"})]
        events += [core.TraceEvent(seq=0, kind="dispatch", name=f"e{tt}",
                                   t=tt - skews[p], meta={"process": p})
                   for tt, a in zip(true_times, assign) if a == p]
        events.sort(key=lambda e: e.t)
        lines = [json.dumps(dict(e.to_dict(), seq=i)) + "\n"
                 for i, e in enumerate(events)]
        random.Random(seed + p).shuffle(lines)
        paths.append(str(tmp_path / f"s{p}.jsonl"))
        with open(paths[-1], "w") as f:
            f.writelines(lines)
    merged = obs.aggregate(paths)
    assert merged_view(merged) == merged_view(ref_obs.aggregate(paths))
    ts = [e.t for e in merged.events]
    assert ts == sorted(ts) and len(ts) == n + 2
    bs = [e.t for e in merged.events if e.name == "obs.barrier"]
    assert abs(bs[0] - bs[1]) < 1e-6
    out = str(tmp_path / "m.jsonl")
    merged.save(out)
    assert [(e.seq, e.name) for e in obs.aggregate([out]).events] == \
        [(e.seq, e.name) for e in merged.events]


def test_aggregate_cli_writes_merged_jsonl(tmp_path, capsys):
    paths = _make_shards(tmp_path, n_shards=2, events_per=3)
    outs = []
    for pkg in BOTH:
        out = str(tmp_path / f"fleet_{pkg.core.__name__}.jsonl")
        assert pkg.aggregate.main(paths + ["-o", out, "--report", "4",
                                           "--summary"]) == 0
        outs.append(out)
        assert "AGGREGATED TIMELINE (2 shards" in capsys.readouterr().out
    got, want = (dicts(ref_core.JsonlSink.load(o)) for o in outs)
    assert got == want
    assert len(got) == sum(len(ref_core.JsonlSink.load(p)) for p in paths)


# -- LiveSummary / LiveServer ------------------------------------------------

def _live(pkg, event_dicts):
    lv = pkg.obs.LiveSummary("live")
    empty = lv.snapshot()
    for e in replayed(pkg, event_dicts):
        lv.emit(e)
    snaps = []
    for s in (empty, lv.snapshot()):
        s.pop("wall_s")
        snaps.append(s)
    return snaps


def _seeded_stream(n=200, seed=0):
    """A seeded stream of every kind, with durations and payloads."""
    rng = random.Random(seed)
    sess = ref_core.TraceSession("seeded")
    for i in range(n):
        kind = rng.choice(ref_core.EVENT_KINDS)
        sess.emit(kind, f"{kind}{rng.randint(0, 4)}",
                  dur_s=rng.expovariate(1e3), payload_bytes=rng.randint(0, 64))
    return dicts(sess.timeline())


def test_live_summary_snapshot_matches_reference():
    stream = _seeded_stream()
    got, want = (_live(p, stream) for p in BOTH)
    assert got == want
    empty, full = got
    assert empty["events"] == 0 and set(empty["by_kind"]) == set(
        core.EVENT_KINDS)
    assert full["events"] == 200


def test_live_summary_matches_session_summary_schema():
    lv = obs.LiveSummary("live")
    sess = core.TraceSession("live", sinks=[lv])
    sess.emit("dispatch", "d", dur_s=0.25, payload_bytes=8)
    sess.emit("transfer", "mv", payload_bytes=100)
    snap, full = lv.snapshot(), sess.summary()
    for key in ("events", "by_kind", "dur_s_by_kind", "payload_by_kind",
                "by_name", "total_payload_bytes", "total_dispatch_s"):
        assert snap[key] == full[key], key


def test_live_server_poll_and_stream():
    import urllib.request

    lv = obs.LiveSummary("srv")
    sess = core.TraceSession("srv", sinks=[lv])
    sess.emit("dispatch", "d")
    try:
        server = obs.LiveServer(lv.snapshot).start()
    except OSError:
        pytest.skip("cannot bind localhost in this environment")
    try:
        url = server.url
        assert url.startswith("http://127.0.0.1:")
        got = json.loads(urllib.request.urlopen(
            f"{url}/summary", timeout=10).read())
        assert got["events"] == 1 and got["by_kind"]["dispatch"] == 1
        assert json.loads(urllib.request.urlopen(
            f"{url}/healthz", timeout=10).read()) == {"ok": True}
        lines = urllib.request.urlopen(
            f"{url}/stream?interval=0.01&max=3", timeout=10).read()
        snaps = [json.loads(x) for x in lines.splitlines()]
        assert len(snaps) == 3 and all(s["events"] == 1 for s in snaps)
    finally:
        server.stop()


# -- LogHistogram ------------------------------------------------------------

def _exact_percentile(xs, p):
    vals = sorted(xs)
    rank = max(1, min(len(vals), math.ceil(p / 100.0 * len(vals))))
    return vals[rank - 1]


def _histogram(pkg, xs, growth=1.15):
    h = pkg.obs.LogHistogram(growth)
    for x in xs:
        h.add(x)
    return h


def test_log_histogram_percentiles_match_reference_within_bound():
    rng = random.Random(7)
    xs = [math.exp(rng.uniform(math.log(1e-4), math.log(1e-1)))
          for _ in range(5000)]
    h, r = (_histogram(p, xs) for p in BOTH)
    assert h.to_dict() == r.to_dict()
    bound = math.sqrt(1.15) - 1.0 + 1e-9
    for p in (50.0, 90.0, 99.0):
        assert h.percentile(p) == r.percentile(p)
        exact = _exact_percentile(xs, p)
        assert abs(h.percentile(p) - exact) / exact <= bound
    assert (h.n, h.min, h.max) == (5000, min(xs), max(xs))
    assert h.mean == pytest.approx(sum(xs) / len(xs))


def test_log_histogram_zero_and_negative_bucket():
    h, r = (_histogram(p, (0.0, -1.0, 0.0)) for p in BOTH)
    assert h.percentile(50.0) == r.percentile(50.0) <= 0.0
    for x in (h, r):
        x.add(5.0)
    assert h.percentile(99.0) == r.percentile(99.0) == pytest.approx(
        5.0, rel=math.sqrt(1.15) - 1)
    assert _histogram(PORT, (0.0,)).percentile(50.0) == 0.0


def test_log_histogram_merge_equals_combined_feed():
    a, b, both = (obs.LogHistogram() for _ in range(3))
    for i in range(1, 200):
        v = 0.001 * i
        (a if i % 2 else b).add(v)
        both.add(v)
    a.merge(b)
    for p in (50.0, 90.0, 99.0):
        assert a.percentile(p) == both.percentile(p)
    assert a.n == both.n and a.total == pytest.approx(both.total)
    other = obs.LogHistogram(2.0)
    other.add(1.0)
    with pytest.raises(ValueError, match="growth"):
        a.merge(other)


def test_log_histogram_dict_round_trips_across_packages():
    h = _histogram(PORT, (0.0, 1e-4, 3.7, 3.7, 120.0))
    d = json.loads(json.dumps(h.to_dict()))
    for cls in (obs.LogHistogram, ref_obs.LogHistogram):
        h2 = cls.from_dict(d)
        assert (h2.n, h2.min, h2.max) == (h.n, h.min, h.max)
        for p in (50.0, 99.0):
            assert h2.percentile(p) == h.percentile(p)


# -- span stamping + SpanProfile --------------------------------------------

def _spanned_session(pkg=PORT, **session_kw):
    """request > decode_iter nesting with stamped + declared attribution."""
    sess = pkg.core.TraceSession("prof", **session_kw)
    with sess.span("request", uid=1):
        sess.emit("dispatch", "prefill", dur_s=1e-3, payload_bytes=100)
        with sess.span("decode_iter"):
            sess.emit("dispatch", "decode", dur_s=2e-3, payload_bytes=40)
            sess.emit("graph_launch", "g", dur_s=1e-4)
    h = sess.start_span("bg_request")
    sess.emit("transfer", "weights", payload_bytes=999)
    h.end(doorbells=3, payload=12)
    return sess


@pytest.fixture(scope="module")
def spanned_stream():
    return dicts(_spanned_session(REF).timeline())


def _profile(pkg, stream):
    return pkg.obs.SpanProfile.from_events(replayed(pkg, stream))


def test_span_profile_rollup_matches_reference(spanned_stream):
    prof, ref = (_profile(p, spanned_stream) for p in BOTH)
    assert prof.snapshot() == ref.snapshot()
    spans = prof.snapshot()["spans"]
    assert set(spans) == {"request", "request/decode_iter", "bg_request"}
    req = spans["request"]
    assert (req["doorbells"], req["graph_launches"],
            req["payload_bytes"]) == (2, 1, 140)
    bg = spans["bg_request"]
    assert (bg["doorbells"], bg["payload_bytes"], bg["events"]) == (3, 12, 0)


def test_span_profile_store_metrics_and_report_match_reference(
        spanned_stream):
    prof, ref = (_profile(p, spanned_stream) for p in BOTH)
    flat = prof.store_metrics()
    assert flat == ref.store_metrics()
    assert flat["request/doorbells"] == 2.0
    assert flat["request/decode_iter/payload_bytes"] == 40.0
    assert all(isinstance(v, float) for v in flat.values())
    assert prof.report() == ref.report()
    assert "request/decode_iter" in prof.report()


def test_span_profile_sink_equals_post_mortem():
    live = obs.SpanProfile()
    sess = core.TraceSession("prof", sinks=[live])
    with sess.span("step"):
        sess.emit("dispatch", "d", dur_s=1e-3)
    post = obs.SpanProfile.from_events(sess.timeline())
    assert live.snapshot()["spans"] == post.snapshot()["spans"]


def test_span_attribution_survives_jsonl_round_trip(tmp_path):
    path = os.path.join(tmp_path, "trace.jsonl")
    sess = _spanned_session(jsonl_path=path)
    sess.close()
    direct = obs.SpanProfile.from_events(sess.timeline()).snapshot()
    for pkg in BOTH:
        loaded = pkg.obs.SpanProfile.from_events(
            pkg.core.JsonlSink.load(path)).snapshot()
        assert loaded["spans"] == direct["spans"]


def test_span_attribution_survives_aggregate_merge(tmp_path):
    paths = []
    for p in range(2):
        path = os.path.join(tmp_path, f"trace.p{p}.jsonl")
        sess = core.TraceSession("fleet", jsonl_path=path,
                                 tags={"host": "h", "process": p})
        sess.barrier("sync")
        with sess.span("request", uid=p):
            sess.emit("dispatch", "d", dur_s=1e-3, payload_bytes=10 + p)
        sess.close()
        paths.append(path)
    got, want = (p.obs.SpanProfile.from_events(
        p.aggregate.aggregate(paths).events).snapshot() for p in BOTH)
    assert got == want
    req = got["spans"]["request"]
    assert (req["spans"], req["doorbells"], req["payload_bytes"]) == (2, 2, 21)


def test_span_nesting_stamps_path_and_ancestor_chain():
    sess = core.TraceSession("nest")
    with sess.span("a") as ha:
        with sess.span("b") as hb:
            e = sess.emit("dispatch", "d")
    assert e.meta["span_path"] == "a/b"
    assert e.meta["span_ids"] == [ha.span_id, hb.span_id]
    assert e.meta["parent_span_id"] == ha.span_id
    ends = [x for x in sess.timeline() if x.name == "obs.span"]
    assert [x.meta["span"] for x in ends] == ["b", "a"]
    assert all(x.dur_s >= 0.0 for x in ends)


def test_span_contextvar_isolated_across_threads():
    sess = core.TraceSession("threads")
    seen = {}
    go = threading.Barrier(2)

    def worker(name):
        go.wait()
        with sess.span(name):
            e = sess.emit("dispatch", f"d_{name}")
        seen[name] = e.meta

    ts = [threading.Thread(target=worker, args=(n,)) for n in ("t1", "t2")]
    with sess.span("main_only"):
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        e_main = sess.emit("dispatch", "d_main")
    assert e_main.meta["span_path"] == "main_only"
    assert (seen["t1"]["span_path"], seen["t2"]["span_path"]) == ("t1", "t2")
    assert seen["t1"]["span_id"] != seen["t2"]["span_id"]


# -- Chrome-trace / Perfetto export -----------------------------------------

def test_chrome_trace_matches_reference(spanned_stream):
    trace, ref = (p.export.to_chrome_trace(replayed(p, spanned_stream),
                                           trace_name="t") for p in BOTH)
    assert trace == ref
    evs = trace["traceEvents"]
    assert trace["displayTimeUnit"] == "ms"
    assert trace["otherData"]["trace"] == "t"
    assert {"M", "X", "b", "e"} <= {e["ph"] for e in evs}
    for e in evs:
        assert {"ph", "pid", "tid"} <= set(e)
        if e["ph"] == "X":
            assert e["dur"] >= 0.0
    by_name = {e["name"]: e for e in evs
               if e["ph"] == "X" and e.get("cat") == "span"}
    outer, inner = by_name["request"], by_name["decode_iter"]
    assert outer["tid"] == inner["tid"] and outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    assert {e["name"] for e in evs if e["ph"] in ("b", "e")} == {"bg_request"}


def test_chrome_trace_shards_become_processes(tmp_path):
    paths = []
    for p in range(2):
        path = os.path.join(tmp_path, f"s.p{p}.jsonl")
        sess = core.TraceSession("fleet", jsonl_path=path,
                                 tags={"host": "h", "process": p})
        sess.barrier("sync")
        with sess.span("request"):
            sess.emit("dispatch", "d")
        sess.close()
        paths.append(path)
    traces = [p.export.export(paths, os.path.join(tmp_path, f"{i}.json"),
                              trace_name="fleet")
              for i, p in enumerate(BOTH)]
    assert traces[0] == traces[1]
    trace = traces[0]
    assert len(trace["otherData"]["shards"]) == 2
    assert {e["pid"] for e in trace["traceEvents"]} == {0, 1}
    assert all(e["ts"] >= 0.0 for e in trace["traceEvents"] if "ts" in e)
    with open(os.path.join(tmp_path, "0.json")) as f:
        assert json.load(f)["traceEvents"]


def test_export_cli_single_shard(tmp_path, capsys):
    path = os.path.join(tmp_path, "t.jsonl")
    sess = core.TraceSession("cli", jsonl_path=path)
    with sess.span("request"):
        sess.emit("dispatch", "d", dur_s=1e-3)
    sess.close()
    outs = []
    for i, pkg in enumerate(BOTH):
        out = os.path.join(tmp_path, f"out{i}.json")
        assert pkg.export.main([path, "-o", out, "--name", "cli"]) == 0
        assert "perfetto" in capsys.readouterr().out
        with open(out) as f:
            outs.append(json.load(f))
    assert outs[0] == outs[1] and outs[0]["traceEvents"]


# -- MetricsStore ------------------------------------------------------------

def test_metrics_store_records_read_back_through_reference(tmp_path):
    """The port writes; the reference's store reads the same records (and
    the other way round)."""
    root = str(tmp_path / "m")
    store = obs.MetricsStore(root=root)
    store.append("bench", {"x": 1.0}, run_id="r1", ts=10.0)
    store.append("bench", {"x": 2.0}, run_id="r2", ts=20.0)
    store.append("other", {"y": 5}, run_id="r1", ts=15.0)
    ref = ref_obs.MetricsStore(root=root)
    ref.append("bench", {"x": 3.0}, run_id="r3", ts=30.0)
    for s in (store, ref):
        assert s.kinds() == ["bench", "other"]
        recs = s.records("bench")
        assert [r.run_id for r in recs] == ["r1", "r2", "r3"]
        assert recs[0].git_sha
        assert s.latest("bench").metrics == {"x": 3.0}
        assert [r.run_id for r in s.records("bench", since=15.0)] == \
            ["r2", "r3"]
        assert [r.run_id for r in s.records("bench", run_id="r1")] == ["r1"]
    assert [r.to_dict() for r in store.records("bench")] == \
        [r.to_dict() for r in ref.records("bench")]


def test_metrics_store_tolerates_truncated_trailing_line(tmp_path):
    store = obs.MetricsStore(root=str(tmp_path / "m"))
    store.append("bench", {"x": 1.0}, run_id="r1")
    with open(store._path("bench"), "a") as f:
        f.write('{"run_id": "r2", "ts": 1.0, "kin')
    for s in (store, ref_obs.MetricsStore(root=str(tmp_path / "m"))):
        assert [r.run_id for r in s.records("bench")] == ["r1"]
    with open(store._path("bench"), "a") as f:
        f.write("\n")
        f.write(json.dumps(store.append("bench", {"x": 3.0},
                                        run_id="r3").to_dict()) + "\n")
    with pytest.raises((json.JSONDecodeError, KeyError)):
        store.records("bench")


def test_metrics_store_trend_and_cli_match_reference(tmp_path, capsys):
    root = str(tmp_path / "m")
    store = obs.MetricsStore(root=root)
    store.append("loadtest", {"latency_p50_s": 0.2, "tokens_per_s": 500.0},
                 run_id="r1", ts=100.0)
    store.append("loadtest", {"latency_p50_s": 0.1, "tokens_per_s": 900.0},
                 run_id="r2", ts=200.0)
    ref = ref_obs.MetricsStore(root=root)
    for md in (False, True):
        assert store.trend("loadtest", markdown=md) == ref.trend(
            "loadtest", markdown=md)
    assert store.trend("loadtest", markdown=True).startswith("| run_id |")
    texts = []
    for pkg in BOTH:
        rcs = [pkg.store.main(["--root", root, "list"]),
               pkg.store.main(["--root", root, "trend", "--kind",
                               "loadtest"]),
               pkg.store.main(["--root", root, "show", "r1"]),
               pkg.store.main(["--root", root, "show", "nope"])]
        texts.append((rcs, capsys.readouterr().out))
    assert texts[0] == texts[1]
    assert texts[0][0] == [0, 0, 0, 1]
    assert "loadtest: 2 record(s)" in texts[0][1]


def test_new_run_id_and_git_sha_follow_the_environment(monkeypatch):
    monkeypatch.setenv("REPRO_RUN_ID", "pinned")
    assert store_mod.new_run_id() == ref_store.new_run_id() == "pinned"
    assert store_mod.default_root() == ref_store.default_root()


# -- trajectory --------------------------------------------------------------

def _artifact(pr, latency=10.0, tokens_per_s=500.0, dispatch_s=0.5,
              objective=7e-4, quick=True):
    return {
        "pr": pr, "quick": quick, "arch": "gemma-2b",
        "sections": {
            "dma": {"header": ["name", "nbytes", "latency_us",
                               "bandwidth_gib_s"],
                    "rows": [{"name": "inline", "nbytes": 256,
                              "latency_us": latency,
                              "bandwidth_gib_s": 1.0}]},
            "loadtest": {"header": ["mode", "requests", "tokens_per_s",
                                    "doorbells"],
                         "rows": [{"mode": "T4", "requests": 16,
                                   "tokens_per_s": tokens_per_s,
                                   "doorbells": 40}]},
        },
        "session_summary": {"events": 100, "total_dispatch_s": dispatch_s},
        "tuning": {"after": objective},
    }


def _write(tmp_path, name, art):
    p = str(tmp_path / name)
    with open(p, "w") as f:
        json.dump(art, f)
    return p


COLUMNS = ["latency_us", "ttft_p99_s", "doorbells", "doorbells_per_token",
           "score_s_per_token", "total_dispatch_s", "tokens_per_s",
           "tokens_per_doorbell", "bandwidth_gib_s", "steps_per_doorbell",
           "name", "nbytes", "chain_len", "steps", "requests", "tokens",
           "command_bytes_or_bw", "p50_ms", "footprint_bytes"]
METRICS = ["graphs/name=replay/doorbells", "serve.request/payload_bytes",
           "loadtest/mode=cb_T4/tok_per_doorbell", "loadtest/mode=cb_T4/p50_ms",
           "session/total_dispatch_s", "dma/name=inline/bandwidth_gib_s"]


def test_direction_and_count_metrics_match_reference():
    assert [trajectory_mod.direction(c) for c in COLUMNS] == \
        [ref_trajectory.direction(c) for c in COLUMNS]
    assert [trajectory_mod.is_count_metric(m) for m in METRICS] == \
        [ref_trajectory.is_count_metric(m) for m in METRICS] == \
        [True, True, True, False, False, False]
    assert trajectory_mod.direction("latency_us") == "lower"
    assert trajectory_mod.direction("tokens_per_s") == "higher"
    assert trajectory_mod.direction("nbytes") is None


def test_extract_and_diff_metrics_match_reference():
    base = trajectory_mod.extract_metrics(_artifact(7))
    assert base == ref_trajectory.extract_metrics(_artifact(7))
    assert base["dma/name=inline,nbytes=256/latency_us"] == (10.0, "lower")
    assert not any(k.endswith("/nbytes") for k in base)
    for cand in (_artifact(8, latency=20.0, tokens_per_s=1000.0),
                 _artifact(8, tokens_per_s=100.0)):
        got = trajectory_mod.diff_metrics(
            base, trajectory_mod.extract_metrics(cand), threshold=0.25)
        want = ref_trajectory.diff_metrics(
            base, ref_trajectory.extract_metrics(cand), threshold=0.25)
        assert [[r.describe() for r in rs] for rs in got[:2]] == \
            [[r.describe() for r in rs] for rs in want[:2]]
        assert got[2] == want[2]
    regs = trajectory_mod.diff_metrics(
        base, trajectory_mod.extract_metrics(
            _artifact(8, latency=20.0)), threshold=0.25)[0]
    assert [r.metric for r in regs] == \
        ["dma/name=inline,nbytes=256/latency_us"]
    assert regs[0].worsened == pytest.approx(1.0)


def _cli(tmp_path, capsys, files, argv):
    """Both packages' trajectory CLI on the same files: (rc, stdout)."""
    paths = {name: _write(tmp_path, name, art) for name, art in files}
    out = []
    for pkg in BOTH:
        args = [paths.get(a, a) for a in argv]
        rc = pkg.trajectory.main(args)
        out.append((rc, capsys.readouterr().out))
    assert out[0] == out[1]
    return out[0]


@pytest.mark.parametrize("case,argv,rc", [
    ("regression", ["B7", "B8"], 1),
    ("warn_only", ["--baseline", "B7", "--candidate", "B8", "--warn-only"], 0),
    ("clean", ["B7", "B9"], 0),
    ("zero_baseline", ["B7z", "B8z"], 0),
])
def test_cli_verdicts_match_reference(tmp_path, capsys, case, argv, rc):
    files = [("B7", _artifact(7)), ("B8", _artifact(8, latency=30.0)),
             ("B9", _artifact(9, latency=9.5, tokens_per_s=520.0)),
             ("B7z", _artifact(7, dispatch_s=0.0)),
             ("B8z", _artifact(8, dispatch_s=5.0))]
    got_rc, text = _cli(tmp_path, capsys, files, argv)
    assert got_rc == rc
    assert ("REGRESSION" in text) == (case in ("regression", "warn_only"))


def test_cli_orders_positional_artifacts_by_pr_number(tmp_path, capsys):
    files = [(f"BENCH_{pr}.json", _artifact(pr, latency=lat))
             for pr, lat in ((6, 10.0), (7, 30.0), (8, 31.0), (9, 90.0))]
    assert _cli(tmp_path, capsys, files, ["BENCH_8.json", "BENCH_6.json",
                                          "BENCH_7.json"])[0] == 0
    assert _cli(tmp_path, capsys, files, ["BENCH_9.json", "BENCH_6.json",
                                          "BENCH_8.json",
                                          "BENCH_7.json"])[0] == 1


def test_cli_writes_the_reference_report(tmp_path, capsys):
    b = _write(tmp_path, "BENCH_7.json", _artifact(7))
    c = _write(tmp_path, "BENCH_8.json",
               _artifact(8, latency=9.5, tokens_per_s=520.0))
    reports = []
    for i, pkg in enumerate(BOTH):
        report = str(tmp_path / f"TREND{i}.md")
        assert pkg.trajectory.main([b, c, "--report", report]) == 0
        capsys.readouterr()
        with open(report) as f:
            reports.append(f.read())
    assert reports[0] == reports[1]
    assert "# BENCH trajectory report" in reports[0]
    assert "pr 7 → pr 8" in reports[0]


def test_trend_report_flags_quick_full_mismatch():
    base = dict(_artifact(7, quick=False), _path="BENCH_7.json")
    cand = dict(_artifact(8, quick=True, latency=30.0), _path="BENCH_ci.json")
    md, regs = trajectory_mod.trend_report([base, cand], threshold=0.25)
    ref_md, ref_regs = ref_trajectory.trend_report([base, cand],
                                                   threshold=0.25)
    assert md == ref_md and "quick/full scale mismatch" in md
    assert [r.describe() for r in regs] == [r.describe() for r in ref_regs]
    assert regs


def test_unreadable_and_non_bench_artifacts_are_refused(tmp_path, capsys):
    bad = str(tmp_path / "BENCH_bad.json")
    with open(bad, "w") as f:
        f.write("{not json")
    ok = _write(tmp_path, "BENCH_7.json", _artifact(7))
    not_bench = _write(tmp_path, "BENCH_9.json", {"rows": []})
    for pkg in BOTH:
        assert pkg.trajectory.main([ok, bad]) == 2
        assert pkg.trajectory.main([ok, not_bench]) == 2
        with pytest.raises(ValueError):
            pkg.trajectory.load_artifact(not_bench)
    capsys.readouterr()


@pytest.mark.parametrize("pair", [("BENCH_6.json", "BENCH_9.json"),
                                  ("BENCH_9.json", "BENCH_10.json"),
                                  ("BENCH_6.json", "BENCH_10.json")])
def test_verdicts_on_committed_bench_artifacts_match_reference(pair,
                                                               monkeypatch):
    # the report's header stamps the wall clock; both packages read it
    # through time.strftime, so one fixed stamp makes the two comparable
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "2026-01-01T00:00:00")
    arts = [trajectory_mod.load_artifact(os.path.join(ROOT, p)) for p in pair]
    assert arts == [ref_trajectory.load_artifact(os.path.join(ROOT, p))
                    for p in pair]
    got = trajectory_mod.trend_report(arts, threshold=0.25)
    want = ref_trajectory.trend_report(arts, threshold=0.25)
    assert got[0] == want[0]
    assert [r.describe() for r in got[1]] == [r.describe() for r in want[1]]
    for flags in ([], ["--gate-counts", "--warn-only"]):
        paths = [os.path.join(ROOT, p) for p in pair]
        assert trajectory_mod.main(paths + flags) == \
            ref_trajectory.main(paths + flags)


def test_trajectory_gate_counts_enforces_under_warn_only(tmp_path, capsys):
    def bench(name, doorbells, us):
        art = {"pr": 1, "quick": True,
               "sections": {"graphs": {"title": "g", "header": [], "rows": [
                   {"name": "replay", "chain_len": 8, "doorbells": doorbells,
                    "launch_us": us}]}}}
        return (name, art)
    files = [bench("B1", 8, 100.0), bench("B2", 8, 500.0),
             bench("B3", 80, 100.0)]
    flags = ["--warn-only", "--gate-counts"]
    assert _cli(tmp_path, capsys, files, ["--baseline", "B1", "--candidate",
                                          "B2"] + flags)[0] == 0
    assert _cli(tmp_path, capsys, files, ["--baseline", "B1", "--candidate",
                                          "B3"] + flags)[0] == 1
    assert _cli(tmp_path, capsys, files, ["--baseline", "B1", "--candidate",
                                          "B3", "--warn-only"])[0] == 0


def test_trajectory_store_mode(tmp_path, capsys):
    root = str(tmp_path / "m")
    store = obs.MetricsStore(root=root)
    store.append("loadtest", {"doorbells": 10, "latency_p50_s": 0.1},
                 run_id="old")
    store.append("loadtest", {"doorbells": 30, "latency_p50_s": 0.1},
                 run_id="new")
    outs = []
    for pkg in BOTH:
        rcs = [pkg.trajectory.main(["--store", "loadtest", "--store-root",
                                    root]),
               pkg.trajectory.main(["--store", "loadtest", "--store-root",
                                    root, "--warn-only"]),
               pkg.trajectory.main(["--store", "missing", "--store-root",
                                    root])]
        outs.append((rcs, capsys.readouterr().out))
    assert outs[0] == outs[1]
    assert outs[0][0] == [1, 0, 2]
    assert "COUNT REGRESSION" in outs[0][1] and "doorbells" in outs[0][1]
