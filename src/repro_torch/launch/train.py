"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --steps 50 [--smoke] [--steps-per-launch 4] [--ckpt-dir DIR] \
        [--grad-compression int8] [--seq 256 --batch 8] [--device cuda] \
        [--trace trace.jsonl] [--profile]

Runs on the card unless ``--device cpu`` is given; ``--smoke`` takes the
reduced same-family config.  Every launch is one doorbell and, on the card,
one CUDA Graph replay of ``--steps-per-launch`` train steps (unset: the
tuned policy for the config, ``python -m repro_torch.tune``, else 4).

``--trace PATH`` writes this process's fleet-identified JSONL shard
(``host``/``process`` tags, per-process filename) for
``repro_torch.obs.aggregate`` / ``repro_torch.obs.export``; ``--profile``
prints per-``train.step`` span attribution (doorbells, payload, wall
p50/p90/p99).
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from ..configs import ARCHS, SMOKE_ARCHS
from ..configs.shapes import ShapeConfig
from ..obs.profile import SpanProfile
from ..runtime.trainer import Trainer
from ..tune.policy import load_policy_for
from .mesh import fleet_session

#: steps a launch when ``--steps-per-launch`` is unset and no tuned policy
#: exists
DEFAULT_STEPS_PER_LAUNCH = 4


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen3-8b", choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps-per-launch", type=int, default=None,
                    help="unset -> the tuned policy, else "
                         f"{DEFAULT_STEPS_PER_LAUNCH}")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--grad-compression", default=None,
                    choices=[None, "int8"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write this process's JSONL trace shard "
                         "(fleet-tagged, per-process filename)")
    ap.add_argument("--profile", action="store_true",
                    help="print per-span command attribution after the run")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = (SMOKE_ARCHS if args.smoke else ARCHS)[args.arch]
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    # one lookup, made ambient as the trainer's own is
    policy = load_policy_for(cfg, device=args.device)
    spl = args.steps_per_launch
    if spl is None:
        spl = (policy.knob("steps_per_launch", DEFAULT_STEPS_PER_LAUNCH)
               if policy else DEFAULT_STEPS_PER_LAUNCH)
    session, shard = fleet_session("train", trace_path=args.trace)
    prof = None
    if args.profile:
        prof = SpanProfile(name="train")
        session.add_sink(prof)
    tr = Trainer(cfg, shape, steps_per_launch=spl,
                 ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 grad_compression=args.grad_compression,
                 peak_lr=args.lr, seed=args.seed, session=session,
                 device=args.device)
    if policy is not None:
        print(f"policy: {policy.arch} knobs={policy.knobs} "
              f"objective={policy.objective.get('after')}")
    if args.ckpt_dir and tr.maybe_restore():
        print(f"restored at step {tr.step}")
    out = tr.train(args.steps)
    print(out)
    print(tr.submission_report())
    print(tr.trace_report(max_events=30))
    if prof is not None:
        print(prof.report())
    session.close()
    if shard:
        print(f"trace shard: {shard}")


if __name__ == "__main__":
    main()
