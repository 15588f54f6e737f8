"""Tour of the command-stream methodology (the paper, end to end), on the
PyTorch/CUDA port: the port of ``examples/command_stream_tour.py``.

One :class:`repro_torch.core.TraceSession` spans the whole tour — the
watchpoint analogue: every submission passes through it exactly once,
whichever subsystem made it.

1. Listing-1 analogue: decode the submission of a serve step (``compile``;
   on the card one CUDA Graph, its nodes decoded).
2. §6.2 analogue: inline vs direct data movement (``transfer``).
3. §6.3 analogue: the command-footprint law (``graph_launch``/``dispatch``).
4. The merged timeline: all of the above interleaved in submission order.
5. Fleet-wide capture: two *separate processes*, each with its own tagged
   session and its own monotonic clock, merged
   into one cross-process submission-ordered timeline (barrier-aligned),
   by ``repro_torch.obs.aggregate``.
6. Causal attribution: spans stamp every command with the request / decode
   iteration that caused it; ``SpanProfile`` rolls doorbells, payload and
   wall time up per span path with streaming percentile histograms, the
   timeline exports to Perfetto, and the scored numbers persist in the
   metrics store.

On ``--device cpu`` part 3 says that it needs the card and goes on: the
footprint is read from a captured graph.  On the card a failure in any
part raises.

    PYTHONPATH=src python examples/command_stream_tour_torch.py [--device cpu]
"""
import argparse
import os
import socket
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import SMOKE_ARCHS
from repro_torch.core import ExecGraph, TraceSession, render_submission
from repro_torch.device import resolve_device
from repro_torch.models import get_model


def tour_1_listing(sess: TraceSession, dev: torch.device) -> None:
    print("=" * 72)
    print("1. Command-stream reconstruction (Listing 1 analogue)")
    print("=" * 72)
    cfg = SMOKE_ARCHS["mamba2-780m"]
    model = get_model(cfg, device=dev)
    params = model.init_params(0)
    state = model.init_decode_state(2, 32)
    tok = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    cs = sess.capture.lower_and_compile("serve_step", model.decode_step,
                                        args=(params, state, tok))
    print(render_submission(cs, max_entries=18))


def tour_2_dma(sess: TraceSession, dev: torch.device) -> None:
    print("\n" + "=" * 72)
    print("2. Data-movement protocols (inline vs direct, §6.2)")
    print("=" * 72)
    sess.mover.threshold = 24 * 1024            # the paper's switch point
    sess.mover.device = dev
    for nbytes in (64, 4096, 16 * 1024, 64 * 1024, 1 << 20):
        x = np.random.default_rng(0).integers(
            0, 255, size=nbytes).astype(np.uint8)
        _, rec = sess.mover.put(x)
        print(f"  {nbytes:>9d} B -> {rec.mode:7s} "
              f"complete={rec.complete_s*1e6:8.1f} us "
              f"bw={rec.bandwidth_gib_s:8.3f} GiB/s")
    print("  protocol counts:", sess.mover.stats(),
          "(threshold is a knob — CUDA's is opaque)")


def tour_3_graphs(sess: TraceSession, dev: torch.device) -> None:
    print("\n" + "=" * 72)
    print("3. Launch modes & the command-footprint law (§6.3)")
    print("=" * 72)
    if dev.type != "cuda":
        print("  needs the card: the footprint is read from a captured CUDA "
              "Graph (--device cuda)")
        return
    for K in (10, 100):
        for mode in ("per_op", "graphed", "multistep"):
            g = ExecGraph(chain_len=K, width=1024, device=dev)
            g.launch(mode, session=sess)         # warm
            _, st = g.launch(mode, session=sess)
            print(f"  K={K:4d} {mode:10s} doorbells={st.doorbells:4d} "
                  f"footprint={st.command_bytes:8d}B "
                  f"launch={st.launch_s*1e6:8.1f}us")
    print("  -> footprint and doorbells, not node count, set launch cost")


def tour_4_timeline(sess: TraceSession) -> None:
    print("\n" + "=" * 72)
    print("4. The unified timeline (one watchpoint saw all of the above)")
    print("=" * 72)
    print(sess.report(max_events=24))


def _fleet_worker(start_barrier, outdir: str, pid: int) -> None:
    """One simulated fleet process: tagged session, own clock, own shard."""
    from repro_torch.core import TraceSession

    time.sleep(0.03 * pid)                 # deliberately skew session t0
    path = os.path.join(outdir, f"trace.p{pid}.jsonl")
    with TraceSession(f"fleet_proc{pid}", jsonl_path=path,
                      tags={"host": socket.gethostname(),
                            "process": pid}) as sess:
        start_barrier.wait()               # the shared real-world moment
        sess.barrier("fleet.sync")         # -> obs.barrier alignment event
        for step in range(3):
            sess.emit("dispatch", f"decode_step{step}",
                      dur_s=1e-4 * (pid + 1), payload_bytes=512)
            time.sleep(0.01)
        sess.emit("transfer", "kv_pull", dur_s=2e-4,
                  payload_bytes=1 << 16, mode="direct")


def tour_5_fleet() -> None:
    print("\n" + "=" * 72)
    print("5. Fleet-wide aggregation (two processes, one merged timeline)")
    print("=" * 72)
    import multiprocessing as mp

    from repro_torch.obs import aggregate

    ctx = mp.get_context("spawn")
    outdir = tempfile.mkdtemp(prefix="fleet_tour_")
    start = ctx.Barrier(2)
    procs = [ctx.Process(target=_fleet_worker, args=(start, outdir, pid))
             for pid in (0, 1)]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    merged = aggregate(sorted(
        os.path.join(outdir, f) for f in os.listdir(outdir)))
    print(merged.report(max_events=16))
    for shard, al in merged.summary()["alignment"].items():
        print(f"  shard {shard}: offset={al['offset_s']*1e3:+.3f} ms "
              f"via {al['mode']}")
    print("  -> per-process clocks re-based onto one submission order")


def tour_6_attribution() -> None:
    print("\n" + "=" * 72)
    print("6. Causal attribution (spans -> percentiles -> Perfetto -> store)")
    print("=" * 72)
    from repro_torch.obs import SpanProfile, to_chrome_trace
    from repro_torch.obs.store import MetricsStore

    prof = SpanProfile(name="tour")
    outdir = tempfile.mkdtemp(prefix="attr_tour_")
    trace_path = os.path.join(outdir, "trace.jsonl")
    with TraceSession("attribution", jsonl_path=trace_path,
                      sinks=[prof]) as sess:
        for uid in range(4):
            # scoped spans nest via contextvar; every emit inside is
            # stamped with the full ancestor chain and rolls up to it
            with sess.span("request", uid=uid):
                with sess.span("prefill"):
                    sess.emit("dispatch", "prefill_launch",
                              dur_s=2e-4, payload_bytes=4096)
                for it in range(3):
                    with sess.span("decode_iter", it=it):
                        sess.emit("graph_launch", "decode_graph",
                                  dur_s=1e-4 * (1 + uid),
                                  doorbells=1, command_bytes=4610)
        # manual handle: overlapping background work, *declared* costs
        h = sess.start_span("kv_migration")
        h.end(doorbells=2, payload=1 << 16)
    print(prof.report())
    req = prof.path("request")
    print(f"  request: doorbells/span p50={req['doorbells_per_span']['p50']:.1f}"
          f" wall p99={req['wall_s']['p99']*1e3:.2f} ms")

    trace = to_chrome_trace(sess.timeline(), trace_name="tour")
    n_slices = sum(1 for t in trace["traceEvents"]
                   if t.get("cat") == "span" and t["ph"] in ("X", "b"))
    print(f"  Perfetto export: {len(trace['traceEvents'])} trace events, "
          f"{n_slices} span slices (load at ui.perfetto.dev)")

    store = MetricsStore(root=os.path.join(outdir, "metrics"))
    rec = store.append("tour", prof.store_metrics())
    print(f"  stored {len(rec.metrics)} metrics as run {rec.run_id} "
          f"@ {rec.git_sha}")
    print("  -> every doorbell now has a *cause*, not just a timestamp")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default) raises without a card")
    dev = resolve_device(ap.parse_args().device)
    with TraceSession("command_stream_tour") as sess:
        tour_1_listing(sess, dev)
        tour_2_dma(sess, dev)
        tour_3_graphs(sess, dev)
    tour_4_timeline(sess)
    tour_5_fleet()
    tour_6_attribution()


if __name__ == "__main__":
    main()
