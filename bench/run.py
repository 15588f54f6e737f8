"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up: the cell's weights drawn on the card from the seed
(``bench/weights.py``), ``repro_torch``'s ``ContinuousBatchingServer`` with
every knob from the cell file, and a warm-up that captures the decode graph
and one prefill graph for each prompt length of the mix.  Then the window
(``bench/drive.py``), its metrics (``bench/metrics/<name>.py``, the ones
``BENCHMARK.json`` gives the cell: end-to-end ones without tracing,
per-layer ones with it), and, with the engine freed, the check of the
served tokens against the plain reference (``bench/check.py``).  The last
line of standard output is the result; the numbers compared, each beside
its limit, close standard error.

Build and kernel caches stay inside the checkout (``build/``).  Without a
card, or with fewer than the cell asks for, it prints no result and exits 2.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Any, Dict, List, Optional, Tuple  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

#: top-level modules that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: warm-up prompts come from this seed on every run: set-up is the same work
WARM_SEED = 20260101


def _env() -> None:
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["REPRO_POLICY_DISABLE"] = "1"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def port_config(name: str) -> Any:
    from repro_torch.configs import ARCHS, SMOKE_ARCHS
    for c in list(ARCHS.values()) + list(SMOKE_ARCHS.values()):
        if c.name == name:
            return c
    raise KeyError(f"the port has no configuration {name!r}")


def port_model(cfg: Dict[str, Any]) -> Any:
    """The port's configuration for a configuration file, with the file's
    RoPE base (a setting the port takes), held to the file's sizes: where
    the port cannot run as the file states, the file's ``departures`` say
    what it runs instead, or the run stops."""
    import dataclasses
    from bench.weights import sizes
    pc = dataclasses.replace(port_config(cfg["port_config"]),
                             rope_theta=float(cfg["rope_theta"]))
    s = sizes(cfg)
    want = {"n_layers": s["L"], "d_model": s["d"], "n_heads": s["H"],
            "n_kv_heads": s["Hkv"], "hd": s["hd"], "vocab_size": s["V"],
            "d_ff": s["ff"], "param_dtype": cfg["torch_dtype"],
            "n_experts": s.get("E", 0)}
    if cfg["family"] == "moe":
        want.update(top_k=s["k"], n_shared_experts=s["Es"],
                    capacity_factor=float(
                        cfg["departures"]["prefill_capacity_factor"]))
    got = {k: getattr(pc, k) for k in want}
    if got != want or pc.family != cfg["family"] or pc.qk_norm \
            or pc.tie_embeddings or pc.embed_scale:
        raise ValueError(f"{cfg['name']}: the port's {pc.name} runs {got}, "
                         f"the configuration file says {want}")
    return pc


def build_engine(spec: Dict[str, Any], weights: Any, device: Any) -> Any:
    from repro_torch.runtime.server import ContinuousBatchingServer
    k = spec["engine"]
    return ContinuousBatchingServer(
        port_model(spec["config_spec"]), batch_size=k["batch_size"],
        max_seq=k["max_seq"], tokens_per_launch=k["tokens_per_launch"],
        kv=k["kv"], prefill_chunk=k["prefill_chunk"],
        max_pending=k["max_pending"], admission="reject", device=device,
        params=weights)


def warm(engine: Any, mix: Dict[str, Any], vocab: int) -> None:
    """One request of each prompt length of the mix through the engine:
    each prefill graph is captured and the decode graph replayed."""
    import numpy as np
    from repro_torch.runtime.server import Request
    rng = np.random.default_rng(WARM_SEED)
    for i, S in enumerate(sorted(mix["prompt_lens"])):
        engine.submit(Request(uid=-1 - i, max_new_tokens=engine.T + 1,
                              prompt=rng.integers(0, vocab, S).astype(
                                  np.int32)))
    while engine.step():
        pass


def request_of(a: Any) -> Any:
    from repro_torch.runtime.server import Request
    return Request(uid=a.uid, prompt=a.prompt,
                   max_new_tokens=a.max_new_tokens)


def execute(spec: Dict[str, Any], seed: int, seconds: float, trace: bool,
            device: Any, t_start: float, root: Path = ROOT,
            marks: Optional[List[Tuple[str, float]]] = None,
            control: bool = False
            ) -> Tuple[Optional[Dict[str, Any]], List[str]]:
    """One run of a resolved cell; returns (result, the lines compared) or
    (None, why) where a forbidden module was loaded.  ``marks`` are the
    set-up's earlier stages, (name, end); with ``control`` the float8
    reference stands in the program's place at the check (never in a
    benchmark run: the tests and ``bench/calibrate.py`` use it)."""
    import torch
    from bench import check, drive, registry, stats, traffic
    from bench.costs.model import Shapes
    from bench.trace import Slice, label_gaps
    from bench.weights import make

    cfg, mix = spec["config_spec"], spec["mix_spec"]
    offline = mix["loop"] == "offline"
    on_card = device.type == "cuda"
    marks = list(marks or [("start", t_start)])
    marks.append(("the benchmark's imports", time.perf_counter()))
    weights = make(cfg, seed, device)
    marks.append(("weights", time.perf_counter()))
    engine = build_engine(spec, weights, device)
    marks.append(("engine and decode graph", time.perf_counter()))
    spans = drive.SpanLog(engine.session, ("serve.decode_iter",
                                           "serve.prefill"))
    engine.session.add_sink(spans)
    warm(engine, mix, cfg["vocab_size"])
    marks.append(("prefill graphs", time.perf_counter()))
    arrivals = traffic.generate(mix, seed, cfg["vocab_size"],
                                rate=spec.get("rate"), horizon_s=seconds)
    tracer = None
    if trace and on_card:
        tracer = Slice(engine, **spec["trace"])
        tracer.prepare()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    window = drive.drive(engine, arrivals, seconds, offline,
                         float(mix.get("drain_s", 0.0)), request_of,
                         on_tick=tracer.tick if tracer else None,
                         replay_log=tracer.log if tracer else None)
    if tracer is not None:
        tracer.finish(window)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    bad = forbidden_modules()
    if bad:
        return None, [f"modules loaded in the run's process: {bad}"]

    run = SimpleNamespace(
        cell=spec, config=cfg, window=window, offline=offline,
        traced=tracer.result if tracer else None, shapes=Shapes(cfg),
        peaks=registry.peaks(torch.cuda.get_device_name(device)
                             if on_card else "NVIDIA H100 80GB HBM3",
                             root / "bench"),
        spans=spans.spans, setup_s=setup_s,
        slice_open=tracer.t0 if tracer and tracer.result else None)
    metrics: Dict[str, Any] = {}
    for m in registry.metrics_of(spec["name"], trace, root):
        v = registry.reader(m["name"], root / "bench").read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    attempted = stats.attempted(window, offline)
    failed = stats.failed(window, offline)
    dev: Dict[str, Any] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": 1, "memory_peak_bytes": int(peak)}
    result: Dict[str, Any] = {"correct": False, "attempted": len(attempted),
                              "failed": len(failed), "metrics": metrics,
                              "device": dev}
    setup = ", ".join(f"{n} {b - a:.3f} s"
                      for (_, a), (n, b) in zip(marks, marks[1:]))
    notes = [f"set-up: {setup}",
             f"window {window.seconds:.3f} s: {len(attempted)} attempted, "
             f"{len(failed)} failed, {sum(stats.ok(r) for r in attempted)} "
             f"done, {stats.window_tokens(window)} tokens in the window, "
             f"{len(window.steps)} steps; the generator ran at most "
             f"{1e3 * window.max_late_s:.3f} ms late; drain "
             f"{window.t_end - window.t_close:.3f} s"]
    if run.traced is not None:
        tr = run.traced
        notes.append(tracer.diag + f", {len(tr.launches)} graph launches "
                     f"attributed, {len(tr.steps)} steps")
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in tr.ops[:10]],
            "idle_gaps": label_gaps(tr, spans.spans, window.sleeps)}
        if not tr.matched:
            notes.append("traced slice: graph launches and logged replays "
                         "differ in number; no launch is attributed")

    # the program's state goes before the reference runs
    sample = check.sample(attempted, seed, int(spec["check"]["requests"]))
    del engine, tracer, spans
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    got = check.readings(weights, cfg, sample, control=control)
    checks, result["correct"] = check.judge(got, spec["check"]["limits"],
                                            len(failed))
    lines = list(notes) + [
        f"check: the reference took {time.perf_counter() - t_check:.3f} s"
    ] + [f"read (not compared) {n} {v!r}" for n, v in got.items()
         if n not in checks]
    result["checks"] = checks
    lines += [f"check {n} {c['value']!r} limit {c['limit']!r}"
              for n, c in checks.items()]
    return result, lines


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    import torch
    marks = [("start", T_START), ("python and torch", time.perf_counter())]
    from bench import registry
    spec = registry.resolve(args.workload)
    chips = next(w["chips"] for w in registry.benchmark()["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    dev = resolve_device("cuda")
    torch.zeros(1, device=dev)             # the context, apart from the rest
    marks.append(("CUDA", time.perf_counter()))
    result, lines = execute(spec, args.seed, args.seconds, bool(args.trace),
                            dev, T_START, marks=marks)
    if result is None:
        print(lines[0], file=sys.stderr)
        return 3
    for ln in lines:
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
