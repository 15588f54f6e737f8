"""Readings for a cell's limits, one set-up for many seeds (not part of a
benchmark run):

    python3 bench/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] --control <k>

For each seed the weights are drawn again in place (the engine's graphs
read the same buffers), the seed's traffic runs through a window of the
cell's load and drains, and the numbers of ``bench/check.py`` are read on
the cell's sample, as a run reads them; on the first ``k`` seeds also the
control's: the reference computed in float8, in the program's place, on
the same sequences, judged against the cell's limits as a run is.  With ``--rates``
it sweeps an open loop's rate instead (one window a rate, on the first
seed) and prints what the knee is read from.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def _quantiles(per_request):
    """p50, p90, p99, p99.9 and the share of gaps over 0.1 and 0.5."""
    import torch
    g = torch.cat(per_request)
    q = torch.quantile(g.double(), torch.tensor([0.5, 0.9, 0.99, 0.999],
                                                dtype=torch.float64))
    return [round(float(x), 5) for x in q] + [
        round(float((g > 0.1).double().mean()), 5),
        round(float((g > 0.5).double().mean()), 5)]


def _empty(engine) -> None:
    """Drop what is queued and finish what is active."""
    while engine.queue.pop(engine.sched_policy) is not None:
        pass
    while engine.n_active:
        engine.step()


def sweep(spec, engine, seed, seconds, rates, drain_s):
    from bench import drive, stats, traffic
    from bench.run import request_of
    cfg, mix = spec["config_spec"], spec["mix_spec"]
    for rate in rates:
        arr = traffic.generate(mix, seed, cfg["vocab_size"], rate=rate,
                               horizon_s=seconds)
        w = drive.drive(engine, arr, seconds, False, drain_s, request_of)
        att = w.reqs
        q = []
        for t in (w.t_open + seconds * f for f in (0.25, 0.5, 0.75, 1.0)):
            q.append(sum(1 for r in att if r.submitted <= t and
                         not (0 <= r.ticket.t_admit <= t)))
        print(json.dumps({
            "rate": rate, "attempted": len(att),
            "done_in_window": sum(1 for r in att if stats.ok(r)
                                  and r.ticket.t_done <= w.t_close),
            "admitted": sum(1 for r in att if r.ticket.t_admit >= 0),
            "queue_at_quarters": q,
            "ttft_p95_ms": 1e3 * stats.percentile(
                [stats.ttft_s(r) for r in att], 95),
            "tpot_p95_ms_done": 1e3 * stats.percentile(
                [stats.tpot_s(r) for r in att if stats.ok(r)] or [0.0], 95),
            "tokens_per_s": stats.window_tokens(w) / seconds,
            "late_ms": 1e3 * w.max_late_s}), flush=True)
        _empty(engine)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--rates", type=float, nargs="*")
    ap.add_argument("--drain", type=float, default=0.0)
    args = ap.parse_args()
    from bench import run as brun
    brun._env()
    import torch
    from bench import check, drive, registry, stats, traffic
    from bench.weights import Weights
    from repro_torch.device import resolve_device
    dev = resolve_device("cuda")
    spec = registry.resolve(args.workload)
    cfg, mix = spec["config_spec"], spec["mix_spec"]
    offline = mix["loop"] == "offline"
    w = Weights(cfg, dev).draw(args.seeds[0])
    engine = brun.build_engine(spec, w.tree, dev)
    brun.warm(engine, mix, cfg["vocab_size"])
    print(f"set-up {time.perf_counter() - T_START:.3f} s on "
          f"{torch.cuda.get_device_name(dev)}", flush=True)
    if args.rates:
        sweep(spec, engine, args.seeds[0], args.seconds, args.rates,
              args.drain)
        return 0
    for i, seed in enumerate(args.seeds):
        w.draw(seed)
        arr = traffic.generate(mix, seed, cfg["vocab_size"],
                               rate=spec.get("rate"), horizon_s=args.seconds)
        t0 = time.perf_counter()
        win = drive.drive(engine, arr, args.seconds, offline,
                          float(mix.get("drain_s", 0.0)), brun.request_of)
        att = stats.attempted(win, offline)
        sample = check.sample(att, seed, int(spec["check"]["requests"]))
        t1 = time.perf_counter()
        g = check.gaps(w.tree, cfg, sample)
        t2 = time.perf_counter()
        got = {**check.summary(g), "tokens": sum(len(x) for x in g),
               "requests": len(sample)}
        n_failed = len(stats.failed(win, offline))
        out = {"seed": seed, **got,
               "correct": check.judge(got, spec["check"]["limits"],
                                      n_failed)[1],
               "gap_quantiles": _quantiles(g),
               "attempted": len(att), "failed": n_failed,
               "window_s": t1 - t0, "reference_s": t2 - t1}
        if i < args.control:
            c = check.gaps(w.tree, cfg, sample, control=True)
            ctl = {**check.summary(c), "tokens": sum(len(x) for x in c)}
            out["control"] = ctl
            out["control_correct"] = check.judge(
                ctl, spec["check"]["limits"], 0)[1]
            out["control_quantiles"] = _quantiles(c)
            out["control_s"] = time.perf_counter() - t2
        print(json.dumps(out), flush=True)
        _empty(engine)
    return 0


if __name__ == "__main__":
    sys.exit(main())
