"""Serving launcher: batched greedy decode with multi-token launches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        [--smoke] [--batch 4] [--max-seq 128] [--prompt-len 8] \
        [--new-tokens 16] [--tokens-per-launch T] [--seed 0] [--device cuda] \
        [--continuous [--requests N] [--sched fifo|priority|fair] \
         [--kv dense|paged] [--kv-page-tokens P] [--prefill-chunk C] \
         [--live [PORT]]] [--trace PATH] [--profile]

Runs on the card unless ``--device cpu`` is given.  Weights are the port's
seeded random init; prompts are seeded random tokens.  Unset launch knobs
(``--tokens-per-launch``, ``--kv-page-tokens``, ``--prefill-chunk``) come
from the tuned policy for the config (``python -m repro_torch.tune``), else
4, 16 and 0.

``--continuous`` serves the requests through the continuous-batching
engine (queued admission, per-request KV slots) instead of one static
batch; ``python -m repro_torch.launch.loadtest`` is the full traffic
harness.  ``--live [PORT]`` (with ``--continuous``) exposes the engine's
live session summary over HTTP while it runs (``GET /summary``,
``GET /stream``; :mod:`repro_torch.obs.live`).  ``--kv paged`` serves from
a page pool with block tables and shared-prefix pages (``--kv-page-tokens``
tokens a page), and ``--prefill-chunk N`` (N > 0) prefills longer prompts
N tokens a launch, interleaved with decode.

``--trace PATH`` writes a fleet-identified JSONL shard of the run
(``host``/``process`` tags, per-process filename) for
``repro_torch.obs.aggregate`` / ``repro_torch.obs.export``; ``--profile``
prints per-span command attribution (``serve.request``,
``serve.decode_iter``, ``serve.prefill``) after the run.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from ..configs import ARCHS, SMOKE_ARCHS
from ..obs.profile import SpanProfile
from ..runtime.server import ContinuousBatchingServer, Request, Server
from ..tune.policy import load_policy_for
from .mesh import fleet_session

#: decode steps a launch when ``--tokens-per-launch`` is unset and no tuned
#: policy exists
DEFAULT_TOKENS_PER_LAUNCH = 4


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="gemma-2b", choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--tokens-per-launch", type=int, default=None,
                    help="decode steps a launch (unset -> the tuned "
                         f"policy, else {DEFAULT_TOKENS_PER_LAUNCH})")
    ap.add_argument("--continuous", action="store_true",
                    help="serve through the continuous-batching engine")
    ap.add_argument("--kv", default="dense", choices=("dense", "paged"),
                    help="with --continuous: KV-cache backend")
    ap.add_argument("--kv-page-tokens", type=int, default=None,
                    help="paged backend page size in tokens (unset -> "
                         "the tuned policy, else 16)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="max tokens per prefill launch (unset -> the "
                         "tuned policy, else 0; 0 = whole-prompt)")
    ap.add_argument("--sched", default="fifo",
                    choices=("fifo", "priority", "fair"),
                    help="with --continuous: admission scheduling policy")
    ap.add_argument("--requests", type=int, default=None,
                    help="request count for --continuous (default: batch)")
    ap.add_argument("--live", type=int, default=None, nargs="?", const=0,
                    metavar="PORT",
                    help="with --continuous: serve the live summary over "
                         "HTTP while the engine runs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write this process's JSONL trace shard "
                         "(fleet-tagged, per-process filename)")
    ap.add_argument("--profile", action="store_true",
                    help="print per-span command attribution after the run")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = (SMOKE_ARCHS if args.smoke else ARCHS)[args.arch]
    # one lookup, made ambient as an owner's is; each flag left unset takes
    # the policy's value, else the CLI's default (None: the owner's)
    policy = load_policy_for(cfg, device=args.device)

    def knob(flag: Optional[int], name: str, untuned: Optional[int]
             ) -> Optional[int]:
        if flag is not None:
            return flag
        return policy.knob(name, untuned) if policy else untuned

    tpl = knob(args.tokens_per_launch, "tokens_per_launch",
               DEFAULT_TOKENS_PER_LAUNCH)
    session, shard = fleet_session("serve", trace_path=args.trace)
    prof = None
    if args.profile:
        prof = SpanProfile(name="serve")
        session.add_sink(prof)
    if args.continuous:
        srv = ContinuousBatchingServer(
            cfg, batch_size=args.batch, max_seq=args.max_seq,
            tokens_per_launch=tpl, seed=args.seed,
            session=session, kv=args.kv,
            kv_page_tokens=knob(args.kv_page_tokens, "kv_page_tokens", None),
            prefill_chunk=knob(args.prefill_chunk, "prefill_chunk", None),
            sched=args.sched,
            device=args.device)
    else:
        srv = Server(cfg, batch_size=args.batch, max_seq=args.max_seq,
                     tokens_per_launch=tpl, seed=args.seed,
                     session=session, device=args.device)
    rng = np.random.default_rng(args.seed)
    n = (args.requests or args.batch) if args.continuous else args.batch
    reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                    size=args.prompt_len).astype(np.int32),
                    max_new_tokens=args.new_tokens)
            for i in range(n)]
    if args.continuous:
        live_srv = None
        if args.live is not None:
            live_srv = srv.start_live_endpoint(port=args.live)
            print(f"live summary endpoint: {live_srv.url}/summary")
        for r in reqs:
            srv.submit(r)
        try:
            out = srv.run()
        finally:
            if live_srv is not None:
                srv.stop_live_endpoint()
    else:
        out = srv.serve(reqs)
    print(out)
    for r in reqs[:2]:
        print(f"req {r.uid}: {r.tokens}")
    print(srv.session.report(max_events=30))
    if prof is not None:
        print(prof.report())
    session.close()
    if shard:
        print(f"trace shard: {shard}")


if __name__ == "__main__":
    main()
