#!/usr/bin/env python3
"""Time gemma-2b one-shot decode of two source trees on one card.

    python3 scripts/oneshot_decode_ab.py TREE [TREE ...]

Each TREE is a checkout of this repo (``.`` for this one).  One worker
process runs per argument, in the order given, with ``TREE/src`` on its
path, so list them interleaved (``old new new old``) to tell the code apart
from the card's drift.  A worker builds that tree's kernels, serves
``chip_smoke.py``'s gemma-2b path once through ``Server`` at T=1 (4
requests, prompts of 61/128/200/255, 32 new tokens, max_seq 512; the serve
captures the graphs), then prints one JSON line: the replayed T=1 decode
step (CUDA events over 64 replays of the decode graph), its kernels' own
time a replay (torch.profiler over 4 replays) and the graph's node count,
the card's SM clock, temperature and power read by ``nvidia-smi`` while
200 replays run, the eager ``decode_step`` (CUDA events over 16 calls) and
the median tokens/s of three warm serves.  The timing code is this file's
in every worker; only the package under test differs.  Needs one CUDA
card; weights are the port's seeded init.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

PROMPT_LENS = (61, 128, 200, 255)
MAX_SEQ = 512
NEW_TOKENS = 32
REPS = 64
SMI_QUERY = "clocks.sm,clocks.mem,temperature.gpu,power.draw"


def worker() -> None:
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import _build
    from repro_torch.runtime.server import Request, Server

    def time_ms(fn, reps: int = REPS, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def requests(vocab: int):
        rng = np.random.default_rng(0)
        return [Request(i, rng.integers(0, vocab, size=n).astype(np.int32),
                        max_new_tokens=NEW_TOKENS)
                for i, n in enumerate(PROMPT_LENS)]

    _build.build()
    _build.library()
    device = torch.device("cuda")
    cfg = ARCHS["gemma-2b"]
    srv = Server(cfg, batch_size=len(PROMPT_LENS), max_seq=MAX_SEQ,
                 tokens_per_launch=1, device=device)
    srv.serve(requests(cfg.vocab_size))
    decode = srv.graphs()["decode T=1"]
    replay_ms = time_ms(decode)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            decode()
        torch.cuda.synchronize()
    kernel_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    ) / 4 / 1e3
    for _ in range(200):
        decode()
    smi = subprocess.run(
        ["nvidia-smi", f"--query-gpu={SMI_QUERY}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.cuda.synchronize()
    model, state = srv.model, srv.state
    nxt = torch.zeros(len(PROMPT_LENS), 1, dtype=torch.int32, device=device)
    eager_ms = time_ms(lambda: model.decode_step(srv.params, state, nxt), 16)
    tps = []
    for _ in range(3):
        m = srv.serve(requests(cfg.vocab_size))
        tps.append(m["new_tokens"] / m["wall_s"])
    print(json.dumps({"tree": os.environ["AB_TREE"],
                      "replay_decode_ms": replay_ms,
                      "replay_kernel_ms": kernel_ms,
                      "nodes": decode.footprint()[1],
                      "under_load": smi,
                      "eager_decode_ms": eager_ms,
                      "warm_tokens_per_s": statistics.median(tps)}),
          flush=True)


def main(trees) -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    rows = []
    for tree in trees:
        src = os.path.join(os.path.abspath(tree), "src")
        env = dict(os.environ, PYTHONPATH=src, AB_TREE=tree)
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker"], env=env, capture_output=True,
                             text=True, timeout=600)
        if out.returncode:
            sys.stderr.write(out.stderr[-4000:])
            print(f"worker for {tree} exited {out.returncode}")
            return 1
        row = json.loads(out.stdout.strip().splitlines()[-1])
        rows.append(row)
        print(f"{card} | {tree}: {json.dumps(row)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for tree in dict.fromkeys(trees):
        mine = [r for r in rows if r["tree"] == tree]
        print(f"{card} | {tree} over {len(mine)} workers: " + ", ".join(
            f"{k} " + " / ".join(f"{r[k]:.3f}" for r in mine)
            for k in ("replay_decode_ms", "replay_kernel_ms",
                      "eager_decode_ms", "warm_tokens_per_s")), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--worker"]:
        worker()
    elif len(sys.argv) > 1:
        sys.exit(main(sys.argv[1:]))
    else:
        sys.exit(__doc__)
