#!/usr/bin/env python3
"""Hold the dry-run's weighted records to its full-depth records.

    PYTHONPATH=src python scripts/dryrun_depth_check.py \\
        [--mesh single|multi] [--out FILE] ARCH:SHAPE [ARCH:SHAPE ...]

For each (arch, shape) cell of ``repro_torch.launch.dryrun`` at published
widths, on ``meta``: one record with each layer stack recorded as weighted
bodies (the default, ``models.layers.layer_loop``) and one with every layer
(``full_depth=True``), held to each other by
``dryrun.weighted_differences`` (its ``WEIGHTED_FIELDS``: integers equal,
floats within 1e-9 relative).  Prints one line a cell (EQUAL or the
differing fields, both wall times, both op counts) and appends both
records' compared fields and times to ``--out`` as JSON lines.  Exits 1
if a cell differs.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch import dryrun  # noqa: E402


def compared(rec: Dict[str, Any]) -> Dict[str, Any]:
    """The fields of ``rec`` that ``dryrun.weighted_differences`` holds,
    by their paths."""
    out: Dict[str, Any] = {}
    for field in dryrun.WEIGHTED_FIELDS:
        value = rec
        for k in field.split("/"):
            value = value[k]
        out[field] = value
    return out


def main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="scripts/dryrun_depth_check.py")
    ap.add_argument("cells", nargs="+", help="ARCH:SHAPE")
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    multi = args.mesh == "multi"
    bad = 0
    for cell in args.cells:
        arch, shape = cell.split(":")
        t0 = time.time()
        w = dryrun.run_cell(arch, shape, multi)
        tw = time.time() - t0
        if w["status"] == "skip":
            print(f"SKIP {arch} x {shape} x {args.mesh}: {w['reason']}",
                  flush=True)
            continue
        t0 = time.time()
        f = dryrun.run_cell(arch, shape, multi, full_depth=True)
        tf = time.time() - t0
        diff = dryrun.weighted_differences(w, f)
        bad += bool(diff)
        print(f"{'EQUAL' if not diff else 'DIFF '} {arch} x {shape} x "
              f"{args.mesh}: weighted {tw:.1f} s ({w['stream']['n_ops']} "
              f"ops), full depth {tf:.1f} s ({f['stream']['n_ops']} ops)",
              flush=True)
        for d in diff[:20]:
            print(f"      {d}", flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps({
                    "arch": arch, "shape": shape, "mesh": args.mesh,
                    "equal": not diff, "weighted_s": tw, "full_depth_s": tf,
                    "weighted": compared(w), "full_depth": compared(f),
                    "weighted_n_ops": w["stream"]["n_ops"],
                    "full_depth_n_ops": f["stream"]["n_ops"]}) + "\n")
    dryrun.release_fake_mesh()
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
