"""CLI: search the exposed submission knobs and persist a policy.

    PYTHONPATH=src python -m repro_torch.tune --arch gemma-2b \
        [--workloads dma,serve,train] [--rounds 2] [--full] \
        [--policy-dir DIR] [--device cuda|cpu] [--devices N] \
        [--cuda-env "KEY=VALUE ..."]

The port's copy of ``python -m repro.tune``.  It runs on the card unless
``--device cpu`` is given.  The policy is written under
``$REPRO_POLICY_DIR/torch/`` (default ``results/policies/torch/``), or
into ``--policy-dir`` as given.  The environment preset (CUDA environment
variables, visible card count) is applied BEFORE anything touches
CUDA and recorded in the policy.  After tuning, ``--verify`` (default)
re-runs the serve workload with the knob left unset — exercising the
auto-apply path Trainer/Server use — and prints the TraceSession summary so
the before/after objective is visible.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tune")
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--full", action="store_true",
                    help="tune the full published config (default: smoke)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--workloads", default="dma,serve,train",
                    help="comma-separated subset of dma,serve,train,kv "
                         "(kv tunes the paged backend's kv_page_tokens + "
                         "prefill_chunk; opt-in)")
    ap.add_argument("--policy-dir", default=None,
                    help="write the policy here (default: "
                         "$REPRO_POLICY_DIR/torch); --verify's Server looks "
                         "it up in the default directory, as every owner "
                         "does")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--serve-mode", default="oneshot",
                    choices=("oneshot", "continuous"),
                    help="measure tokens_per_launch on a one-shot batch or "
                         "under the continuous-batching engine")
    ap.add_argument("--train-steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    # environment preset (applied before CUDA starts)
    ap.add_argument("--devices", type=int, default=None,
                    help="visible cards (CUDA_VISIBLE_DEVICES=0..N-1)")
    ap.add_argument("--cuda-env", default="",
                    help="space-separated KEY=VALUE environment variables")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--no-verify", dest="verify", action="store_false")
    args = ap.parse_args(argv)

    from .env import EnvPreset
    preset = EnvPreset(device_count=args.devices, cuda_env=args.cuda_env,
                       platform=args.device)
    preset.apply()

    from .autotune import WorkloadSpec, tune
    spec = WorkloadSpec(batch=args.batch, new_tokens=args.new_tokens,
                        max_seq=args.max_seq, train_steps=args.train_steps,
                        serve_mode=args.serve_mode, seed=args.seed)
    workloads = tuple(w for w in args.workloads.split(",") if w)
    policy, result, path = tune(
        args.arch, smoke=not args.full, rounds=args.rounds,
        workloads=workloads, spec=spec, env_preset=preset,
        policy_dir=args.policy_dir, device=args.device)

    if args.verify and "serve" in workloads:
        _verify(args, policy)


def _verify(args, policy) -> None:
    """Auto-apply check: a fresh Server with the knob unset picks up the
    persisted policy; its steady-state summary shows the tuned objective."""
    import numpy as np

    from ..configs import ARCHS, SMOKE_ARCHS
    from ..core.session import TraceSession
    from ..runtime.server import Request, Server
    from .objective import Objective, metrics_from_summary

    cfg = (SMOKE_ARCHS if not args.full else ARCHS)[args.arch]
    rng = np.random.default_rng(args.seed)

    def requests():
        return [Request(i, rng.integers(0, cfg.vocab_size,
                                        size=4).astype(np.int32),
                        max_new_tokens=args.new_tokens)
                for i in range(args.batch)]

    with TraceSession(name="tune_verify") as sess:
        srv = Server(cfg, batch_size=args.batch, max_seq=args.max_seq,
                     seed=args.seed, session=sess,
                     device=args.device)             # tokens_per_launch unset
        srv.serve(requests())                        # warm
        before = sess.summary()
        out = srv.serve(requests())
        summary = sess.summary()
    m = metrics_from_summary(summary, before, tokens=out["new_tokens"])
    print(f"verify: auto-applied tokens_per_launch={srv.T} "
          f"(policy says {policy.knob('tokens_per_launch')})")
    print(f"verify: objective={Objective().score(m):.3e} s/token  "
          f"doorbells/token={m.doorbells_per_token:.3f}  "
          f"dispatch={m.dispatch_s * 1e3:.2f}ms")
    print("verify: session summary:")
    print(json.dumps({k: summary[k] for k in
                      ("by_kind", "dur_s_by_kind", "total_dispatch_s")},
                     indent=2, sort_keys=True))


if __name__ == "__main__":
    main()
