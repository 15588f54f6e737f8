"""Traffic-replay load harness for the continuous-batching server.

    PYTHONPATH=src python -m repro_torch.launch.loadtest --arch gemma-2b \
        --quick [--device cuda|cpu]

The port of ``repro.launch.loadtest``, every flag kept.  It runs on the
card unless ``--device cpu`` is given; weights are the port's seeded init.
``--kv paged`` serves from a page pool with block tables and shared-prefix
pages, ``--prefill-chunk N`` (N > 0) prefills longer prompts N tokens a
launch, and ``--prefix-len N`` opens every prompt with the same N tokens
(system-prompt traffic).

Generates seeded Poisson traffic (mixed prompt/output lengths), replays it
against a :class:`~repro_torch.runtime.server.ContinuousBatchingServer` — by
default in real time, with a producer thread submitting into the running
decode loop — and reports p50/p99 per-request latency, tokens/sec, and
tokens-per-doorbell, all sourced from one ``TraceSession`` timeline.

``--verify N`` (on by default under ``--quick``) re-decodes N of the
replayed requests through a one-shot ``Server(batch_size=1)`` on the
engine's own params and checks the token streams are identical — the
continuous-batching correctness invariant.
``--json PATH`` writes the machine-readable run record, including the final
session ``summary()`` and per-sink drop/sample accounting.

Observability options (``repro_torch.obs``): ``--live [PORT]`` serves the
engine's live summary over HTTP while the replay runs (``GET /summary``,
``GET /stream``); ``--trace PATH`` streams the full event timeline to a
JSONL shard through a non-blocking :class:`~repro_torch.obs.AsyncSink`
(tagged with host/process ids, ready for
``python -m repro_torch.obs.aggregate``);
``--sample KIND=N`` decimates high-rate kinds on that shard with exact
sampled-away counts.

Every run also carries a :class:`~repro_torch.obs.profile.SpanProfile` sink, so
the report — and the ``--json`` record, under ``"span_profile"`` — includes
per-request causal attribution: doorbells, payload bytes, and graph
launches per ``serve.request`` span, with wall-time p50/p90/p99 from
streaming histograms.  ``--store [ROOT]`` appends the run's metrics and
span attribution to the persistent store (:mod:`repro_torch.obs.store`;
``results/metrics/`` by default) for cross-run trend queries.
"""
from __future__ import annotations

import argparse
import json
from typing import List

from ..configs import ARCHS, SMOKE_ARCHS


def _csv_ints(s: str) -> tuple:
    return tuple(int(x) for x in s.split(",") if x)


def _sample_spec(pairs) -> dict:
    out = {}
    for p in pairs or ():
        kind, _, n = p.partition("=")
        if not n:
            raise argparse.ArgumentTypeError(
                f"--sample expects KIND=N, got {p!r}")
        out[kind] = int(n)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.loadtest")
    ap.add_argument("--arch", default="gemma-2b", choices=list(ARCHS))
    ap.add_argument("--full", action="store_true",
                    help="published config (default: smoke variant)")
    ap.add_argument("--quick", action="store_true",
                    help="CI-scale run: fewer requests, verification on")
    ap.add_argument("--batch", type=int, default=4, help="KV slots")
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--tokens-per-launch", type=int, default=None,
                    help="unset -> the tuned policy, else 1")
    ap.add_argument("--max-pending", type=int, default=256)
    ap.add_argument("--admission", default="reject",
                    choices=("reject", "drop_oldest"))
    ap.add_argument("--kv", default="dense", choices=("dense", "paged"),
                    help="KV-cache backend (paged adds block tables + "
                         "shared-prefix page reuse)")
    ap.add_argument("--kv-page-tokens", type=int, default=None,
                    help="paged backend page size in tokens (unset -> "
                         "the tuned policy, else 16)")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="paged pool size in pages (unset -> every slot "
                         "fully grown: exhaustion impossible)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="max tokens per prefill launch; longer prompts "
                         "are chunked and interleaved with decode iters "
                         "(unset -> the tuned policy, else 0 = off)")
    ap.add_argument("--sched", default="fifo",
                    choices=("fifo", "priority", "fair"),
                    help="admission scheduling policy")
    ap.add_argument("--prefix-len", type=int, default=0,
                    help="shared seeded prefix tokens on every prompt "
                         "(system-prompt traffic; exercises paged "
                         "prefix reuse)")
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--rate", type=float, default=100.0,
                    help="mean Poisson arrival rate, requests/s")
    ap.add_argument("--prompt-lens", type=_csv_ints, default=(4, 8, 16))
    ap.add_argument("--new-tokens", type=_csv_ints, default=(4, 8, 16))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-realtime", dest="realtime", action="store_false",
                    help="submit everything up front, then drain")
    ap.add_argument("--speed", type=float, default=1.0,
                    help="replay speed-up for the arrival clock")
    ap.add_argument("--verify", type=int, default=None, metavar="N",
                    help="check N requests against one-shot serve() "
                         "(default: 4 under --quick, else 0)")
    ap.add_argument("--json", default="", help="write run record here")
    ap.add_argument("--live", type=int, default=None, nargs="?", const=0,
                    metavar="PORT",
                    help="serve the live summary over HTTP during the run "
                         "(PORT omitted or 0 -> ephemeral)")
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="stream the event timeline to a JSONL shard "
                         "through a non-blocking AsyncSink")
    ap.add_argument("--sample", action="append", metavar="KIND=N",
                    help="keep 1-in-N events of KIND on the --trace shard "
                         "(repeatable; barriers always kept)")
    ap.add_argument("--store", default=None, nargs="?", const="",
                    metavar="ROOT",
                    help="append run metrics + span attribution to the "
                         "persistent metrics store (default root: "
                         "results/metrics, or REPRO_METRICS_DIR)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.quick:
        args.requests = min(args.requests, 16)
        args.rate = max(args.rate, 100.0)
        args.max_seq = min(args.max_seq, 64)
        args.prompt_lens = (4, 8)
        args.new_tokens = (5, 9)
    verify_n = args.verify if args.verify is not None else (
        4 if args.quick else 0)

    from ..core.session import JsonlSink, TraceSession
    from ..distributed.context import process_tags, shard_path
    from ..obs.profile import SpanProfile
    from ..runtime.server import ContinuousBatchingServer, Request, Server
    from ..runtime.traffic import TrafficSpec, generate, replay

    cfg = (ARCHS if args.full else SMOKE_ARCHS)[args.arch]
    spec = TrafficSpec(n_requests=args.requests, rate=args.rate,
                       prompt_lens=args.prompt_lens,
                       new_tokens=args.new_tokens, seed=args.seed,
                       prefix_len=args.prefix_len)
    arrivals = generate(spec, vocab_size=cfg.vocab_size)

    # per-span causal attribution rides every run: feeds the report, the
    # --json record, and (with --store) the persistent metrics store
    prof = SpanProfile(name="loadtest")
    extra_sinks: List = [prof]
    if args.trace:
        from ..obs import AsyncSink, SamplingSink
        shard = shard_path(args.trace)
        inner = JsonlSink(shard)
        sample = _sample_spec(args.sample)
        if sample:
            inner = SamplingSink(inner, every=sample)
        extra_sinks.append(AsyncSink(inner))
        print(f"tracing -> {shard} (async"
              + (f", sampling {sample}" if sample else "") + ")")

    with TraceSession(name="loadtest", sinks=extra_sinks,
                      tags=process_tags()) as sess:
        eng = ContinuousBatchingServer(
            cfg, batch_size=args.batch, max_seq=args.max_seq,
            tokens_per_launch=args.tokens_per_launch, seed=args.seed,
            session=sess, max_pending=args.max_pending,
            admission=args.admission, kv=args.kv,
            kv_page_tokens=args.kv_page_tokens, kv_pages=args.kv_pages,
            prefill_chunk=args.prefill_chunk, sched=args.sched,
            device=args.device)
        live_srv = None
        if args.live is not None:
            live_srv = eng.start_live_endpoint(port=args.live)
            print(f"live summary endpoint: {live_srv.url}/summary "
                  f"(stream: {live_srv.url}/stream)")
        sess.barrier("loadtest.start")
        print(f"loadtest: arch={cfg.name} slots={args.batch} T={eng.T} "
              f"requests={spec.n_requests} rate={spec.rate}/s "
              f"realtime={args.realtime} admission={args.admission} "
              f"kv={eng.kv.name} chunk={eng.kv.chunk} sched={args.sched}")
        try:
            tickets, metrics = replay(eng, arrivals, realtime=args.realtime,
                                      speed=args.speed)
        finally:
            if live_srv is not None:
                eng.stop_live_endpoint()
        sess.flush()                    # drain async sinks before reading
        summary = sess.summary()
        sink_stats = sess.sink_stats()

    print(f"requests={metrics['requests']} completed={metrics['completed']} "
          f"evicted={metrics['evicted']} rejected={metrics['rejected']}")
    print(f"latency  p50={metrics['latency_p50_s']*1e3:.1f}ms "
          f"p99={metrics['latency_p99_s']*1e3:.1f}ms   "
          f"ttft p50={metrics['ttft_p50_s']*1e3:.1f}ms "
          f"p99={metrics['ttft_p99_s']*1e3:.1f}ms")
    print(f"throughput {metrics['tokens_per_s']:.1f} tokens/s   "
          f"tokens/doorbell={metrics['tokens_per_doorbell']:.2f} "
          f"({metrics['new_tokens']} tokens / {metrics['doorbells']} "
          f"doorbells)")
    kv = metrics["kv"]
    print(f"kv[{kv['backend']}] prefill launches={kv['prefill_launches']} "
          f"payload={kv['prefill_payload_bytes']}B "
          f"chunked={kv['chunked_prompts']}"
          + (f"  pages peak={kv['pages_peak']}/{kv['pages_total']} "
             f"reused={kv['pages_reused']} "
             f"prefix_hits={kv['prefix_hits']}"
             if kv["backend"] == "paged" else ""))
    req_attr = prof.path("serve.request")
    if req_attr:
        db, wall = req_attr["doorbells_per_span"], req_attr["wall_s"]
        print(f"per-request attribution: doorbells p50={db['p50']:.1f} "
              f"p99={db['p99']:.1f}  wall p50={wall['p50']*1e3:.1f}ms "
              f"p99={wall['p99']*1e3:.1f}ms  "
              f"payload={req_attr['payload_bytes']}B over "
              f"{req_attr['spans']} requests")

    ok = True
    if verify_n:
        served = [t for t in tickets if t.status in ("done", "evicted")]
        sample = served[:verify_n]
        solo = Server(cfg, batch_size=1, max_seq=args.max_seq,
                      tokens_per_launch=1, device=args.device,
                      params=eng.params)
        n_match = 0
        for t in sample:
            # evicted requests were KV-truncated: compare the served prefix
            r = Request(t.uid, t.request.prompt,
                        max_new_tokens=len(t.tokens))
            solo.serve([r])
            if r.tokens == t.tokens:
                n_match += 1
            else:
                ok = False
                print(f"equivalence MISMATCH uid={t.uid}: "
                      f"continuous={t.tokens} oneshot={r.tokens}")
        print(f"equivalence: {'OK' if ok else 'FAILED'} "
              f"({n_match}/{len(sample)} requests match one-shot serve)")

    if args.json:
        record = {
            "arch": cfg.name,
            "engine": {"batch": args.batch, "tokens_per_launch": eng.T,
                       "max_seq": args.max_seq,
                       "max_pending": args.max_pending,
                       "admission": args.admission,
                       "realtime": args.realtime,
                       "sched": args.sched},
            # KV backend footprint: prefill launches/payload, page pool
            # occupancy, prefix-hit reuse — the dense-vs-paged comparison
            # the README table and BENCH kv section are built from
            "kv": metrics["kv"],
            "traffic": spec.to_dict(),
            "metrics": metrics,
            "session_summary": summary,
            # per-sink loss accounting: how much observability this run
            # traded away (async drops, sampled-away events) — BENCH
            # artifacts carry it so the loss itself is tracked over PRs
            "sink_stats": sink_stats,
            # causal attribution: per-span-path doorbell/payload/launch
            # totals plus wall/doorbell/payload percentile summaries from
            # the streaming histograms (serve.request = one span/request)
            "span_profile": prof.snapshot(),
            "tickets": [t.to_dict() for t in tickets],
            "verified": {"n": verify_n, "ok": ok} if verify_n else None,
        }
        with open(args.json, "w") as f:
            json.dump(record, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.json}")

    if args.store is not None:
        from ..obs.store import MetricsStore, new_run_id
        store = MetricsStore(root=args.store or None)
        run_id = new_run_id()
        numeric = {k: float(v) for k, v in metrics.items()
                   if isinstance(v, (int, float))}
        store.append("loadtest", numeric, run_id=run_id,
                     meta={"arch": cfg.name, "slots": args.batch,
                           "tokens_per_launch": eng.T})
        store.append("span_profile", prof.store_metrics(), run_id=run_id,
                     meta={"arch": cfg.name})
        print(f"stored run {run_id} -> {store.root}")

    print(prof.report())
    print(eng.session.report(max_events=20, kinds=("progress",)))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
