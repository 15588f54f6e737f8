"""Quickstart on the PyTorch/CUDA port: one TraceSession from capture to
report.

Runs a reduced deepseek-7b config for a few steps with all instrumentation
flowing through a single :class:`repro_torch.core.TraceSession`: the
compile event of the captured train step (on the card one CUDA Graph), the
dispatch events of the doorbell-wrapped trainer and its progress fences;
then prints the Listing-1-style decoded submission report and the unified,
submission-ordered event timeline.  The port of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core import TraceSession, analyze, render_submission
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.runtime.steps import init_all, make_train_step
from repro_torch.runtime.trainer import Trainer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default) raises without a card")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    cfg = SMOKE_ARCHS["deepseek-7b"]
    shape = ShapeConfig("quickstart", seq_len=64, global_batch=4, kind="train")

    with TraceSession("quickstart") as sess:
        # --- 1. capture the command stream at the submission boundary ----
        # (the train path is the plain route, as the reference trains)
        model = get_model(cfg, impl="ref", device=dev)
        params, opt = init_all(model, cfg)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 SyntheticTokens(cfg, shape).batch_at(0).items()}
        cs = sess.capture.lower_and_compile(
            "train_step", make_train_step(model, cfg),
            args=(params, opt, batch))
        print(render_submission(cs, max_entries=25))

        # --- 2. three-term roofline from the captured stream --------------
        rep = analyze(cs, chips=1, model_flops_total=6 * 115008 * 4 * 64)
        print(f"\nroofline: compute={rep.compute_s*1e6:.1f}us "
              f"memory={rep.memory_s*1e6:.1f}us "
              f"collective={rep.collective_s*1e6:.1f}us "
              f"-> {rep.bottleneck}-bound")

        # --- 3. train a few steps on the SAME session ----------------------
        tr = Trainer(cfg, shape, steps_per_launch=2, session=sess,
                     device=dev)
        out = tr.train(4)
        print(f"\ntrained {out['steps']} steps in {out['wall_s']:.1f}s, "
              f"{out['doorbells']} doorbells "
              f"({out['steps_per_doorbell']:.0f} steps/doorbell), "
              f"final loss {out['final_loss']:.3f}")

    # --- 4. the unified timeline: compile, dispatch, progress interleaved --
    print()
    print(sess.report(max_events=20))


if __name__ == "__main__":
    main()
