"""Hold the continuous engine's launch records to torch.profiler on the card,
and measure what the records cost.

    python3 scripts/launch_records_check.py --workload <cell> --seed <n>
        [--seconds 51] [--footprint] [--out PATH]

One ``--trace 1`` run of a benchmark cell through ``bench/run.py``'s
``execute``, with three hooks around it:

* the window (``bench.drive.drive``): a CUDA timing event and a
  ``perf_counter`` reading at its opening and after its drain, both after a
  synchronize, give how far the device's clock drifts from the host's over
  the window; with ``--footprint``, the decode graph's ``footprint()`` and
  that of the same decode captured without its two stamps;
* the traced slice (``bench.trace.Slice.finish``): the program's records of
  the launches enqueued in the slice, matched in launch order to the
  profiler's graph launches (names equal), against the profiler: each
  decode's ``device_s`` against the sum of its kernels' time under its
  correlation id, its device start against its first kernel's start on the
  ``perf_counter`` clock (``bench/trace.py``'s offset, from the slice's own
  span), and the records' idle share of the slice against the profiler's;
* the engine's stamping and reading (``runtime/kv.py``): the host time
  spent in ``_replay`` beyond the replay itself, in ``_read_stamps``,
  ``_prefilled`` and ``decoded``, over the launches.

Prints the run's stderr lines, then one JSON line (also written to
``--out``).  Needs the card.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, List  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def records(window: Any) -> List[Any]:
    got = {id(x): x for r in window.reqs for x in r.ticket.launches}
    return sorted(got.values(), key=lambda x: x.t_enqueue)


def busy_s(intervals: List[Any], lo: float, hi: float) -> float:
    busy, reached = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, reached), min(b, hi)
        if b > a:
            busy += b - a
        reached = max(reached, b)
    return busy


def quartiles(xs: List[float]) -> Dict[str, float]:
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
    return {"n": len(xs), "q1": q[0], "median": q[1], "q3": q[2],
            "min": min(xs), "max": max(xs)}


def against_profiler(tracer: Any, window: Any) -> Dict[str, Any]:
    """The slice's launches: the program's records against the profiler."""
    import torch
    from bench.trace import GRAPH_LAUNCH, SENTINEL, SLICE
    tr = tracer.result
    if tr is None or not tr.matched:
        return {"matched": False}
    cuda = torch.autograd.DeviceType.CUDA
    events = list(tracer.prof.profiler.kineto_results.events())
    spans = [e for e in events if e.name() == SLICE and e.device_type() != cuda]
    lo = max(spans, key=lambda e: e.duration_ns())
    lo, hi = lo.start_ns(), lo.start_ns() + lo.duration_ns()
    offset_ns = lo - tracer.t0 * 1e9
    host = sorted((e for e in events if e.device_type() != cuda),
                  key=lambda e: e.start_ns())
    api = [e for e in host
           if GRAPH_LAUNCH.match(e.name()) and lo <= e.start_ns() <= hi]
    corrs = [e.correlation_id() for e in api]
    first: Dict[int, int] = {}
    for e in events:
        if e.device_type() == cuda and SENTINEL not in e.name():
            c = e.correlation_id()
            first[c] = min(first.get(c, e.start_ns()), e.start_ns())
    recs = [x for x in records(window)
            if tracer.t0 <= x.t_enqueue <= tracer.t1]
    out: Dict[str, Any] = {
        "matched": True, "launches": len(tr.launches), "records": len(recs),
        "names_equal": [x.graph for x in recs] == [n for n, _ in
                                                   tr.launches]}
    if len(recs) != len(tr.launches) or not out["names_equal"]:
        return out
    for kind, pick in (("decode", lambda x: x.decode),
                       ("all", lambda x: True)):
        rows = [(x, tr.launches[i][1], corrs[i]) for i, x in enumerate(recs)
                if pick(x) and corrs[i] in first]
        if not rows:
            continue
        prog = [x.device_s for x, _, _ in rows]
        prof = [s for _, s, _ in rows]
        gaps = [1e6 * (x.t_start - (first[c] - offset_ns) / 1e9)
                for x, _, c in rows]
        out[kind] = {
            "n": len(rows),
            "program_device_ms_mean": 1e3 * statistics.fmean(prog),
            "profiler_kernel_ms_mean": 1e3 * statistics.fmean(prof),
            "ratio": statistics.fmean(prog) / statistics.fmean(prof),
            "start_gap_us": quartiles(gaps),
            "latency_us": quartiles([1e6 * x.launch_latency_s
                                     for x, _, _ in rows])}
    busy = busy_s([(x.t_start, x.t_end) for x in records(window)],
                  tracer.t0, tracer.t1)
    # launch by launch, us: the profiler's graph-launch call and first
    # kernel on the perf_counter clock, against the record
    out["rows"] = [
        [x.graph, round(1e6 * (x.t_enqueue - tracer.t0), 1),
         round(1e6 * ((e.start_ns() - offset_ns) / 1e9 - x.t_enqueue), 1),
         round(1e6 * x.launch_latency_s, 1),
         round(1e6 * (x.t_start - (first[e.correlation_id()] - offset_ns)
                      / 1e9), 1) if e.correlation_id() in first else None,
         round(1e6 * x.device_s, 1)]
        for x, e in zip(recs, api)]
    out["idle_pct_program"] = 100.0 * (1.0 - busy /
                                       (tracer.t1 - tracer.t0))
    out["idle_pct_profiler"] = 100.0 * (1.0 - tr.busy_s / tr.window_s)
    out["slice_s"] = [tracer.t1 - tracer.t0, tr.window_s]
    return out


def calibrate(engine: Any, n: int = 64) -> Dict[str, Any]:
    """After the window, on the idle card: where an anchor lies, and what
    the reads cost.  An event recorded after a synchronize and polled to
    completion lies between the readings before its record and at its
    completion; mapped from an earlier anchor it must fall there too.  Then
    each part of a launch's read, timed alone on freshly recorded stamps."""
    import torch
    sess, dev = engine.session, engine.device
    torch.cuda.synchronize()
    sess.anchor(dev)
    probe = torch.cuda.Event(enable_timing=True)
    before, after, done, mapped = [], [], [], []
    for _ in range(n):
        torch.cuda.synchronize()
        a = time.perf_counter()
        probe.record()
        b = time.perf_counter()
        while not probe.query():
            pass
        c = time.perf_counter()
        before.append(1e6 * (b - a))
        done.append(1e6 * (c - b))
        mapped.append(1e6 * (sess.device_time(probe) - b))
        after.append(c)
    stamped = engine.kv._stamps[f"decode T={engine.T}"]
    parts: "collections.Counter[str]" = collections.Counter()
    for _ in range(n):
        stamped.head.record()
        stamped.tail.record()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.device_time(stamped.head)
        t1 = time.perf_counter()
        sess.device_time(stamped.tail)
        t2 = time.perf_counter()
        sess.emit("graph_launch", "calibration", t=t0, dur_s=0.0,
                  device_start=0.0, device_s=0.0)
        t3 = time.perf_counter()
        sess.anchor(dev)
        t4 = time.perf_counter()
        for k, v in (("device_time", t1 - t0), ("device_time_2", t2 - t1),
                     ("emit", t3 - t2), ("anchor", t4 - t3)):
            parts[k] += 1e6 * v / n
    return {"record_call_us": quartiles(before),
            "record_to_complete_us": quartiles(done),
            "mapped_less_record_return_us": quartiles(mapped),
            "read_parts_us": dict(parts)}


def main(argv: Any = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--footprint", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from bench import run as brun
    brun._env()
    import torch
    marks = [("start", T_START), ("python and torch", time.perf_counter())]
    from bench import drive as bdrive
    from bench import registry
    from bench import trace as btrace
    from repro_torch.core.graphs import CapturedStep
    from repro_torch.device import resolve_device
    from repro_torch.runtime import kv as rkv
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    torch.zeros(1, device=dev)
    marks.append(("CUDA", time.perf_counter()))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out: Dict[str, Any] = {"workload": args.workload, "seed": args.seed,
                           "card": card.strip(), "torch": torch.__version__}

    drive = bdrive.drive

    def timed_drive(engine: Any, *a: Any, **k: Any) -> Any:
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()
        h0 = time.perf_counter()
        window = drive(engine, *a, **k)
        torch.cuda.synchronize()
        e1 = torch.cuda.Event(enable_timing=True)
        e1.record()
        h1 = time.perf_counter()
        torch.cuda.synchronize()
        host, device = h1 - h0, e0.elapsed_time(e1) / 1e3
        out["clock"] = {"host_s": host, "device_s": device,
                        "drift_us": 1e6 * (host - device),
                        "drift_ppm": 1e6 * (host - device) / host}
        out["anchor"] = calibrate(engine)
        if args.footprint:
            name = f"decode T={engine.T}"
            stamped = engine.graphs()[name].footprint()
            kvb = engine.kv
            bare = CapturedStep(lambda: rkv._decode_steps(
                engine, kvb.slots, kvb._nxt, kvb._block), engine.device)
            bare.capture()
            out["footprint"] = {"graph": name, "stamped": stamped,
                                "bare": bare.footprint()}
            del bare
            torch.cuda.empty_cache()
        return window

    bdrive.drive = timed_drive

    finish = btrace.Slice.finish

    def compared_finish(self: Any, window: Any) -> None:
        finish(self, window)
        out["slice"] = against_profiler(self, window)

    btrace.Slice.finish = compared_finish

    cost: "collections.Counter[str]" = collections.Counter()
    G = rkv._Graphed
    replay, read, prefilled, decoded = (G._replay, G._read_stamps,
                                        G._prefilled, G.decoded)

    def t_replay(self: Any, *a: Any) -> Any:
        t = time.perf_counter()
        rec = replay(self, *a)
        cost["replay_s"] += (time.perf_counter() - t
                             - (rec.t_return - rec.t_enqueue))
        cost["launches"] += 1
        return rec

    reads: List[float] = []             # each read's host time, us
    parts: "collections.Counter[str]" = collections.Counter()
    from repro_torch.core.session import TraceSession
    in_read = [False]

    def timed_part(name: str, fn: Any) -> Any:
        def call(*a: Any, **k: Any) -> Any:
            if not in_read[0]:
                return fn(*a, **k)
            t = time.perf_counter()
            out = fn(*a, **k)
            parts[name] += time.perf_counter() - t
            return out
        return call

    for name in ("device_time", "emit", "anchor"):
        setattr(TraceSession, name,
                timed_part(name, getattr(TraceSession, name)))

    def t_read(self: Any, *a: Any, **k: Any) -> None:
        n = len(self._unread)
        in_read[0] = True
        t = time.perf_counter()
        try:
            read(self, *a, **k)
        finally:
            in_read[0] = False
        dt = time.perf_counter() - t
        cost["read_s"] += dt
        cost["read"] += n - len(self._unread)
        if n:
            reads.append(1e6 * dt)

    def t_prefilled(self: Any, *a: Any, **k: Any) -> None:
        t = time.perf_counter()
        prefilled(self, *a, **k)
        cost["prefilled_s"] += time.perf_counter() - t

    def t_decoded(self: Any, *a: Any) -> Any:
        t = time.perf_counter()
        rec = decoded(self, *a)
        cost["decoded_s"] += time.perf_counter() - t
        return rec

    G._replay, G._read_stamps = t_replay, t_read
    G._prefilled, G.decoded = t_prefilled, t_decoded

    spec = registry.resolve(args.workload)
    result, lines = brun.execute(spec, args.seed, args.seconds, True, dev,
                                 T_START, marks=marks)
    for ln in lines:
        print(ln, file=sys.stderr)
    n = max(1, cost["launches"])
    out["cost_us_per_launch"] = {
        k[:-2]: 1e6 * v / n for k, v in cost.items() if k.endswith("_s")}
    out["cost_us_per_launch"]["total"] = sum(
        out["cost_us_per_launch"].values())
    out["cost_launches"], out["cost_read"] = cost["launches"], cost["read"]
    if reads:
        out["read_call_us"] = quartiles(reads)
        out["read_parts_us_per_launch"] = {
            k: 1e6 * v / n for k, v in parts.items()}
    if result is not None:
        out["correct"] = result["correct"]
        out["metrics"] = {k: v["value"] for k, v in result["metrics"].items()}
        out["device"] = result["device"]
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0 if result is not None and result["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
