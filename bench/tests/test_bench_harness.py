"""The benchmark's harness on the CPU: its files resolve by name, new ones
are found without an edit, the traffic is fixed by the seed, the
end-to-end arithmetic, the references against the port's CPU path, and
what may be imported where."""
from __future__ import annotations

import ast
import json
import re
import shutil
import types
from pathlib import Path

import numpy as np
import pytest

import bench_smoke
from bench import registry, stats, traffic
from bench.costs.kernels import flash_attention_cost, rms_norm_cost
from bench.weights import param_bytes

ROOT = bench_smoke.ROOT
BENCH = ROOT / "bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _spec():
    return registry.benchmark(ROOT)


def test_benchmark_json_resolves_by_name():
    b = _spec()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench"] and b["command"][1] == "bench/run.py"
    names = [c["name"] for c in b["configs"]]
    for c in b["configs"]:
        assert NAME.match(c["name"]) and len(c["why"]) <= 200
        f = registry.config(c["name"])
        assert Path(ROOT / c["file"]) == BENCH / "configs" / f"{c['name']}.json"
        assert f["source"].startswith(c["source"]) and f["name"] == c["name"]
        assert sorted(f["reduced"]) == sorted(c["reduced"])
        assert registry.reference(f["family"]).logits
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["config"] in names and w["chips"] == 1
        r = registry.resolve(w["name"])
        assert (r["config"], r["traffic"]) == (w["config"], w["traffic"])
        assert r["mix_spec"]["name"] == w["traffic"]
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and hasattr(
            registry.reader(m["name"]), "read")
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in b["workloads"]}
    for m in b["per_layer"]:
        e2e = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(e2e.get("workloads",
                                                  m["workloads"]))
    assert all(e["bound"] <= 0.25 for e in b["end_to_end"])
    assert len(json.dumps(b)) < 64 * 1024


def test_new_files_are_found_without_an_edit(tmp_path):
    base = tmp_path / "bench"
    shutil.copytree(BENCH, base, ignore=shutil.ignore_patterns("__pycache__"))
    b = _spec()
    b["workloads"].append({"name": "deepseek7b.burst", "config": "deepseek-7b",
                           "traffic": "burst", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "slots_used.burst", "unit": "slots",
                           "better": "higher", "source": "program_counter",
                           "layer": "engine", "moves": "ttft_p95_ms",
                           "workloads": ["deepseek7b.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    mix = dict(registry.mix("chat"), name="burst", block=10)
    (base / "traffic" / "burst.json").write_text(json.dumps(mix))
    cell = dict(registry.cell("deepseek7b.chat"), name="deepseek7b.burst",
                traffic="burst")
    (base / "cells" / "deepseek7b.burst.json").write_text(json.dumps(cell))
    (base / "metrics" / "slots_used.burst.py").write_text(
        "def read(run):\n    return 7.0\n")
    r = registry.resolve("deepseek7b.burst", base)
    assert r["mix_spec"]["block"] == 10 and r["config_spec"]["family"] == "dense"
    got = [m["name"] for m in registry.metrics_of("deepseek7b.burst", True,
                                                  tmp_path)]
    assert got == ["slots_used.burst"]
    assert registry.reader("slots_used.burst", base).read(None) == 7.0


@pytest.mark.parametrize("name", ["chat", "longctx"])
def test_traffic_is_fixed_by_the_seed(name):
    mix = registry.mix(name)
    a = traffic.generate(mix, 2 ** 31 + 17, 1000, rate=4.0, horizon_s=40)
    b = traffic.generate(mix, 2 ** 31 + 17, 1000, rate=4.0, horizon_s=40)
    c = traffic.generate(mix, 5, 1000, rate=4.0, horizon_s=40)
    assert [(x.t, x.max_new_tokens, x.prompt.tolist()) for x in a] == \
        [(x.t, x.max_new_tokens, x.prompt.tolist()) for x in b]
    assert [x.prompt.tolist() for x in a] != [x.prompt.tolist() for x in c]
    # every seed offers the same work, in another order
    assert sorted(len(x.prompt) for x in a) == sorted(len(x.prompt) for x in c)
    assert sorted(x.max_new_tokens for x in a) == \
        sorted(x.max_new_tokens for x in c)
    if mix["loop"] == "offline":
        key = lambda xs: sorted((len(x.prompt), x.max_new_tokens)
                                for x in xs)
        assert len(a) == mix["queue"] and all(x.t == 0 for x in a)
        assert key(a) == key(c)
    else:
        assert len(a) == 160 and all(0 <= x.t < 40 for x in a)
        assert [x.t for x in a] != [x.t for x in c]


def test_open_loop_is_poisson():
    """Held to its mean count, the arrivals lie as a Poisson process's do:
    over many seeds the arrivals in a second vary about as much as their
    mean (no block fixes them), and the gaps are exponential at the rate
    (their spread equals their mean)."""
    mix = registry.mix("chat")
    per_s, gaps = [], []
    for seed in range(2 ** 31, 2 ** 31 + 40):
        arr = traffic.generate(mix, seed, 1000, rate=3.0, horizon_s=50)
        assert len(arr) == 150
        t = np.asarray([x.t for x in arr])
        assert np.all(np.diff(t) >= 0)
        per_s += np.bincount(t.astype(int), minlength=50).tolist()
        gaps += np.diff(t).tolist()
    per_s, gaps = np.asarray(per_s, float), np.asarray(gaps)
    assert per_s.mean() == pytest.approx(3.0)
    assert 0.85 < per_s.var() / per_s.mean() < 1.15
    assert gaps.mean() == pytest.approx(1 / 3.0, rel=0.05)
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, abs=0.1)


def test_weighted_counts():
    assert traffic.counts([0.35, 0.30, 0.20, 0.15], 20) == [7, 6, 4, 3]
    assert traffic.counts([0.30, 0.30, 0.25, 0.15], 20) == [6, 6, 5, 3]
    assert traffic.counts([1, 1, 1], 6) == [2, 2, 2]


def test_the_port_runs_as_the_file_states(monkeypatch):
    """The file's RoPE base goes to the port; a size that differs stops the
    run; the reference takes a departure's value over the file's."""
    from bench import run as brun
    from bench.reference import moe
    cfg = registry.config("qwen2-moe-a2.7b")
    assert cfg["reduced"] == [] and cfg["rope_theta"] == 1e6
    assert cfg["norm_topk_prob"] is False
    assert cfg["departures"]["norm_topk_prob"] is True
    pc = brun.port_model(cfg)
    assert pc.rope_theta == 1e6 and pc.n_experts == 60 and pc.top_k == 4
    with pytest.raises(ValueError):
        brun.port_model(dict(cfg, num_experts=64))
    import torch
    probs = torch.tensor([[0.4, 0.3, 0.2, 0.1]])
    assert float(moe.route(probs, 2, True)[0].sum()) == pytest.approx(1.0)
    assert float(moe.route(probs, 2, False)[0].sum()) == pytest.approx(0.7)


def _req(due, first=-1.0, done=-1.0, admit=-1.0, n=0, want=4,
         status="done"):
    tix = types.SimpleNamespace(t_first=first, t_done=done, t_admit=admit,
                                tokens=[0] * n, status=status)
    arr = types.SimpleNamespace(max_new_tokens=want)
    return types.SimpleNamespace(due=due, ticket=tix, arrival=arr)


def test_failed_requests_are_infinite_in_a_tail():
    reqs = [_req(0.0, first=0.1 * (i + 1), done=1.0 + i, admit=0.05, n=4)
            for i in range(19)]
    reqs.append(_req(0.0, status="active", n=2))        # never finished
    ttft = [stats.ttft_s(r) for r in reqs]
    assert stats.percentile(ttft, 95) == pytest.approx(1.9)
    assert stats.percentile(ttft, 100) == stats.INF
    tpot = [stats.tpot_s(r) for r in reqs]
    assert stats.percentile(tpot, 100) == stats.INF
    reqs.append(_req(0.0, status="evicted"))
    assert stats.percentile([stats.ttft_s(r) for r in reqs], 95) == stats.INF
    assert stats.percentile([stats.queue_wait_s(r) for r in reqs], 95) == \
        stats.INF
    w = types.SimpleNamespace(reqs=reqs)
    assert len(stats.failed(w, offline=False)) == 2
    assert stats.tpot_s(reqs[0]) == pytest.approx((1.0 - 0.1) / 3)


def test_tokens_in_the_window_only():
    steps = [types.SimpleNamespace(t0=t - 1.0, t1=t, tokens=k, doorbells=d)
             for t, k, d in ((1.0, 10, 3), (2.0, 30, 5), (3.5, 50, 8))]
    w = types.SimpleNamespace(t_close=3.0, doorbells_open=1,
                              in_window=lambda: [s for s in steps
                                                 if s.t1 <= 3.0])
    assert stats.window_tokens(w) == 30
    assert stats.window_doorbells(w) == 4
    mod = registry.reader("out_tokens_per_s")
    w.seconds = 3.0
    w.steps = steps
    # the step in flight at the close (2.5-3.5 s) adds half its 20 tokens
    assert stats.window_work(w) == pytest.approx(40.0)
    run = types.SimpleNamespace(window=w)
    assert mod.read(run) == pytest.approx(40.0 / 3.0)


def test_costs():
    ops, nb = flash_attention_cost(1, 4, 4, 2, 1, 8, 2)
    assert ops == 4 * 2 * 8 * 10 and nb == (4 * 2 * 8 + 2 * 4 * 8) * 2 + 64 * 2
    assert rms_norm_cost(3, 16, 2) == (0, 3 * 16 * 2 * 2 + 32)
    gib = 1 << 30
    assert 26.0 < param_bytes(registry.config("qwen2-moe-a2.7b")) / gib < 27.0
    assert 12.5 < param_bytes(registry.config("deepseek-7b")) / gib < 13.1


@pytest.mark.parametrize("cell", sorted(bench_smoke.CELLS))
def test_reference_agrees_with_the_port_on_the_cpu(monkeypatch, cell):
    """float32 at smoke size: every served token is the reference's best
    (MoE with the prefill's capacity drops)."""
    res, lines = bench_smoke.execute(monkeypatch, cell, 2 ** 31 + 3)
    assert bench_smoke.reading(lines, "max_logit_gap") < 1e-4, lines
    assert res["correct"] and res["failed"] == 0
    assert set(res["metrics"]) >= {"setup_s"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    files = list(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = set(_imports(f)) & {"jax", "jaxlib", "flax", "repro"}
        assert not bad, f"{f} imports {bad}"
    for f in (BENCH / "reference").rglob("*.py"):
        assert "repro_torch" not in set(_imports(f)), f
        assert "repro_torch" not in f.read_text(), f
