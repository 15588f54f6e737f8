"""One-shot serving launcher: batched greedy decode with multi-token launches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        [--smoke] [--batch 4] [--max-seq 128] [--prompt-len 8] \
        [--new-tokens 16] [--tokens-per-launch 4] [--seed 0] [--device cuda]

Runs on the card unless ``--device cpu`` is given.  Weights are the port's
seeded random init; prompts are seeded random tokens.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..configs import ARCHS, SMOKE_ARCHS
from ..runtime.server import Request, Server


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--tokens-per-launch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    cfg = (SMOKE_ARCHS if args.smoke else ARCHS)[args.arch]
    srv = Server(cfg, batch_size=args.batch, max_seq=args.max_seq,
                 tokens_per_launch=args.tokens_per_launch, seed=args.seed,
                 device=args.device)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                    size=args.prompt_len).astype(np.int32),
                    max_new_tokens=args.new_tokens)
            for i in range(args.batch)]
    out = srv.serve(reqs)
    print(out)
    for r in reqs[:2]:
        print(f"req {r.uid}: {r.tokens}")
    print(srv.session.report(max_events=30))


if __name__ == "__main__":
    main()
