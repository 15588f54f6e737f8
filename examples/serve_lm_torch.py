"""Serving example on the PyTorch/CUDA port: batched requests, prefill and
multi-token decode launches (on the card each launch is one CUDA Graph
replay).

Shows the doorbell economy of multi-token graph launch (the paper's §6.3
lesson applied to decoding).  The port of ``examples/serve_lm.py``, with
qwen3-smoke's head dimension raised from 32 to 64 on every device: the
port's ``Server`` prefills through the flash kernel, which takes head
dimensions of 64, 128 and 256.

    PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs import SMOKE_ARCHS
from repro_torch.device import resolve_device
from repro_torch.runtime.server import Request, Server

#: the flash kernel's smallest head dimension
HEAD_DIM = 64


def config():
    """qwen3-smoke at head dimension ``HEAD_DIM``."""
    return dataclasses.replace(SMOKE_ARCHS["qwen3-8b"], head_dim=HEAD_DIM)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default) raises without a card")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    cfg = config()
    print(f"serving {cfg.name} at head_dim={cfg.hd} (smoke: "
          f"{SMOKE_ARCHS['qwen3-8b'].hd}): the flash kernel takes head "
          f"dimensions 64, 128 and 256")

    def mk():
        rng = np.random.default_rng(0)   # fresh rng: identical prompts per T
        return [Request(i, rng.integers(0, cfg.vocab_size, size=6)
                        .astype(np.int32), max_new_tokens=12)
                for i in range(4)]

    for T in (1, 4):
        srv = Server(cfg, batch_size=4, max_seq=64, tokens_per_launch=T,
                     seed=0, device=dev)
        reqs = mk()
        out = srv.serve(reqs)
        print(f"tokens_per_launch={T}: {out['new_tokens']} tokens, "
              f"{out['doorbells']} doorbells "
              f"({out['tokens_per_doorbell']:.1f} tok/doorbell), "
              f"wall {out['wall_s']:.2f}s")
        print("  first request tokens:", reqs[0].tokens)


if __name__ == "__main__":
    main()
