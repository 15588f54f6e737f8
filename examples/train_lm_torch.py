"""End-to-end training driver on the PyTorch/CUDA port: a ~100M-param
dense LM for a few hundred steps.

Exercises the full production path: deterministic pipeline -> multi-step
graph launch (on the card one CUDA Graph of K steps) -> AdamW (fp32 master)
-> async checkpoints -> restart.  The port of ``examples/train_lm.py``; its
checkpoints go to a directory of their own, since both packages' layouts
would restore each other's state, and ``--ckpt-every`` (the reference's 50
by default) lets a short run save one.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]
        [--arch qwen3-8b] [--device cpu]
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import ARCHS
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.runtime.trainer import Trainer


def hundred_m_variant(name: str):
    """Scale an assigned arch down to ~100M params (same family/shape laws)."""
    cfg = ARCHS[name]
    return dataclasses.replace(
        cfg, n_layers=max(2, min(cfg.n_layers, 10)),
        d_model=640, n_heads=10, n_kv_heads=5 if cfg.n_kv_heads else 0,
        head_dim=64, d_ff=2560,
        vocab_size=32000, pad_vocab_to=0, pad_heads_to=0,
        n_experts=min(cfg.n_experts, 8),
        remat=False, attn_chunk=0, fsdp=False, seq_shard=False)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=list(ARCHS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps-per-launch", type=int, default=4)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_train_lm")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default) raises without a card")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = hundred_m_variant(args.arch)
    total, active = cfg.param_counts()
    print(f"training {cfg.name}-100m variant: {total/1e6:.0f}M params "
          f"({active/1e6:.0f}M active)")
    shape = ShapeConfig("train_lm", args.seq, args.batch, "train")
    tr = Trainer(cfg, shape, steps_per_launch=args.steps_per_launch,
                 ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 peak_lr=6e-4,
                 device=dev)
    if tr.maybe_restore():
        print(f"restored from checkpoint at step {tr.step}")
    out = tr.train(args.steps)
    first = tr.metrics_log[0]["loss"] if tr.metrics_log else float("nan")
    print(f"steps={out['steps']} wall={out['wall_s']:.1f}s "
          f"doorbells={out['doorbells']} "
          f"loss {first:.3f} -> {out['final_loss']:.3f}")
    print("submission report:", tr.submission_report())


if __name__ == "__main__":
    main()
