"""The readers of the engine's launch records (``prefill_ms_per_ktok.*``,
``launch_latency_p95_ms.chat``, ``engine_idle_pct.*``): their arithmetic on
hand-built windows, all five on a smoke run of each cell, and the decode
records' riders against the window's own view of each step."""
from __future__ import annotations

import time
import types

import pytest
import torch

import bench_smoke
from bench import drive as bdrive
from bench import registry
from bench import run as brun
from repro_torch.runtime.scheduler import LaunchRecord

NEW = {"qwen2moe.chat": ("prefill_ms_per_ktok.chat",
                         "launch_latency_p95_ms.chat", "engine_idle_pct.chat"),
       "deepseek7b.chat": ("prefill_ms_per_ktok.chat",
                           "launch_latency_p95_ms.chat",
                           "engine_idle_pct.chat"),
       "deepseek7b.longctx": ("prefill_ms_per_ktok.longctx",
                              "engine_idle_pct.longctx")}
READERS = sorted({m for ms in NEW.values() for m in ms})


def read(name, run):
    return registry.reader(name).read(run)


def rec(graph, t_enqueue, t_start, t_end, **kw):
    return LaunchRecord(graph, t_enqueue, t_enqueue + 1e-4, t_start, t_end,
                        **kw)


def window_of(launches_by_req, t_open=0.0, t_close=10.0, sleeps=(),
              slice_open=None):
    reqs = [types.SimpleNamespace(ticket=types.SimpleNamespace(launches=ls))
            for ls in launches_by_req]
    w = types.SimpleNamespace(t_open=t_open, t_close=t_close, reqs=reqs,
                              sleeps=list(sleeps))
    return types.SimpleNamespace(window=w, slice_open=slice_open)


def test_prefill_cost_counts_prefill_and_extend_tokens_only():
    shared = rec("decode T=4", 2.0, 2.0, 2.5, uids=(1, 2), lengths=(9, 20))
    a = [rec("prefill S=100", 0.0, 0.001, 0.011, uid=1, tokens=100), shared]
    b = [rec("extend C=256", 1.0, 1.0, 1.012, uid=2, tokens=256),
         rec("extend C=44", 1.5, 1.5, 1.508, uid=2, tokens=44), shared]
    run = window_of([a, b])
    for name in ("prefill_ms_per_ktok.chat", "prefill_ms_per_ktok.longctx"):
        assert read(name, run) == pytest.approx(1e6 * 0.030 / 400)
    # the cut: a launch enqueued once the slice opened is left out
    late = [rec("prefill S=100", 6.5, 6.5, 6.6, uid=3, tokens=100)]
    assert read("prefill_ms_per_ktok.chat",
                window_of([a, b, late], slice_open=6.0)) == \
        pytest.approx(1e6 * 0.030 / 400)
    assert read("prefill_ms_per_ktok.chat", window_of([a, b, late])) == \
        pytest.approx(1e6 * 0.130 / 500)
    assert read("prefill_ms_per_ktok.chat", window_of([[shared]])) is None


def test_launch_latency_is_a_nearest_rank_p95_over_launches_once():
    """20 launches 1-20 ms from enqueue to device start: the p95 is the
    19th; the 20 ms launch rides two requests and still counts once."""
    ls = [rec("prefill S=8", float(i), i + 1e-3 * (i + 1), i + 0.5, uid=i,
              tokens=8) for i in range(19)]
    shared = rec("decode T=4", 19.0, 19.020, 19.5, uids=(0, 1),
                 lengths=(8, 8))
    run = window_of([ls[:10] + [shared], ls[10:] + [shared]],
                    t_close=30.0)
    assert read("launch_latency_p95_ms.chat", run) == pytest.approx(19.0)
    # the launches from the slice's opening on are left out
    cut = window_of([ls[:10] + [shared], ls[10:] + [shared]],
                    t_close=30.0, slice_open=10.0)
    assert read("launch_latency_p95_ms.chat", cut) == pytest.approx(10.0)


def test_engine_idle_leaves_out_arrival_waits_and_cuts_at_the_slice():
    shared = rec("decode T=4", 1.4, 1.5, 2.0, uids=(1, 2), lengths=(4, 4))
    a = [rec("prefill S=8", 0.0, 0.0, 1.0, uid=1, tokens=8), shared]
    b = [shared, rec("decode T=4", 2.9, 3.0, 8.0, uids=(2,), lengths=(12,))]
    sleeps = [(2.0, 3.0)]
    for name in ("engine_idle_pct.chat", "engine_idle_pct.longctx"):
        # busy 1 + 0.5 + 5 of the 10 s less the 1 s wait
        assert read(name, window_of([a, b], sleeps=sleeps)) == \
            pytest.approx(100 * (1 - 6.5 / 9))
        # to the slice's opening at 6 s: the last launch counts to there
        assert read(name, window_of([a, b], sleeps=sleeps,
                                    slice_open=6.0)) == \
            pytest.approx(100 * (1 - 4.5 / 5))


def test_none_where_nothing_is_read():
    """A program without launch records (the parent), and a window whose
    launches all fall after the slice's opening, read nothing."""
    bare = types.SimpleNamespace(
        window=types.SimpleNamespace(
            t_open=0.0, t_close=10.0, sleeps=[],
            reqs=[types.SimpleNamespace(ticket=types.SimpleNamespace())]),
        slice_open=None)
    late = window_of([[rec("decode T=4", 7.0, 7.0, 7.5, uids=(1,),
                           lengths=(5,))]], slice_open=6.0)
    for name in READERS:
        assert read(name, bare) is None
        assert read(name, late) is None


@pytest.mark.parametrize("cell", sorted(NEW))
def test_smoke_run_reads_every_new_metric(monkeypatch, cell):
    """A traced smoke run on the CPU (no profiler slice there: the records
    up to the close) reports the cell's new metrics, and each decode
    record's riders' cache lengths equal the window's own view of the step
    that made it (``Step.decoded``)."""
    windows = []
    drive = bdrive.drive
    monkeypatch.setattr(bdrive, "drive",
                        lambda *a, **k: windows.append(drive(*a, **k))
                        or windows[-1])
    s, pc = bench_smoke.spec(cell)
    monkeypatch.setattr(brun, "port_config", lambda name: pc)
    res, lines = brun.execute(s, 2 ** 31 + 11, 1.5, True,
                              torch.device("cpu"), time.perf_counter())
    assert res["correct"], lines
    for name in NEW[cell]:
        assert res["metrics"][name]["value"] is not None, name
    idle = res["metrics"][NEW[cell][-1]]["value"]
    assert 0.0 <= idle < 100.0
    (w,) = windows
    decodes = {id(x): x for r in w.reqs for x in r.ticket.launches
               if x.decode}
    assert decodes
    for step in w.steps:
        inside = [x for x in decodes.values()
                  if step.t0 <= x.t_enqueue <= step.t1]
        assert len(inside) == (1 if step.decoded else 0)
        if inside:
            assert sorted(inside[0].lengths) == sorted(step.decoded)
