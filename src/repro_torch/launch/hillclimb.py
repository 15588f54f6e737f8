"""Perf hillclimbing driver: one (arch x shape x mesh) cell per invocation,
with config overrides, the full command-stream breakdown, and optional
kernel credit.  Appends labeled records to ``results/hillclimb_torch.jsonl``
so that each hypothesis -> change -> before/after stays on record.

The port of ``repro.launch.hillclimb`` over the dry-run's fake-mesh cells
(``launch/dryrun.py``: the rank-0 program's per-device roofline on the
H100)::

  python -m repro_torch.launch.hillclimb --arch llava-next-34b \\
      --shape prefill_32k --label sp_on --set seq_shard=True \\
      --set attn_chunk=2048

A ``--kernel-credit`` tag is one of the dry-run's attribution tags
(``dryrun.ATTRIBUTION_TAGS``: ``attention_interior``, ``ssd_interior``,
``moe``, ``loss``), standing for its frames, or any other substring of an
entry's ``op_path``.  For the objective-driven search over the submission
knobs see ``python -m repro_torch.tune``.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

from ..core import adjusted, analyze, attribute
from ..tune.search import parse_spec, parse_value
from .dryrun import ATTRIBUTION_TAGS, release_fake_mesh, run_cell, run_pp_cell

__all__ = ["main", "tag_frames"]

RESULTS_DEFAULT = "results/hillclimb_torch.jsonl"


def tag_frames(tag: str) -> Tuple[str, ...]:
    """The ``op_path`` substrings a credit tag matches."""
    return ATTRIBUTION_TAGS.get(tag, (tag,))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.hillclimb")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--label", required=True)
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value")
    ap.add_argument("--kernel-credit", action="append", default=[],
                    help=("tag:read_write_bytes_per_device: replace the "
                          "tagged interior's memory traffic with a kernel's "
                          "I/O working set"))
    ap.add_argument("--kernel-credit-flops", action="append", default=[],
                    help="tag:flops_scale (e.g. causal skip = 0.5)")
    ap.add_argument("--kernel-credit-mult", default=None,
                    help=("min_multiplier:io_bytes: credit every entry with "
                          "execution multiplier >= min down to the kernel "
                          "I/O working set"))
    ap.add_argument("--pp", action="store_true",
                    help="the pipeline-parallel decode path")
    ap.add_argument("--pp-tokens", type=int, default=1,
                    help="tokens scored per PP launch")
    ap.add_argument("--top", type=int, default=14)
    ap.add_argument("--out", default=RESULTS_DEFAULT)
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = parse_value(v)

    try:
        if args.pp:
            rec = run_pp_cell(args.arch, args.shape, args.mesh == "multi",
                              overrides=overrides, keep_artifacts=True,
                              tokens_per_launch=args.pp_tokens)
        else:
            rec = run_cell(args.arch, args.shape, args.mesh == "multi",
                           keep_artifacts=True, overrides=overrides)
    finally:
        release_fake_mesh()
    if rec["status"] != "ok":
        print(json.dumps({k: v for k, v in rec.items()
                          if not k.startswith("_")}, indent=2)[:2000])
        raise SystemExit(1)
    cs = rec.pop("_captured")
    rep = analyze(cs, chips=rec["chips"],
                  model_flops_total=rec["roofline"]["model_flops_total"])

    # ---- optional kernel credit -------------------------------------------
    credits: Dict[str, Any] = {}
    d_mem = d_flops = 0.0
    # specs split on the LAST colon (tags are op paths that may hold ':')
    for spec in args.kernel_credit:
        tag, io_bytes = parse_spec(spec)
        a = attribute(cs, *tag_frames(tag))
        d_mem += float(io_bytes) - a["memory_bytes"]
        credits[tag] = {"replaced_mem": a["memory_bytes"],
                        "with_io_bytes": float(io_bytes)}
    for spec in args.kernel_credit_flops:
        tag, scale = parse_spec(spec)
        a = attribute(cs, *tag_frames(tag))
        d_flops += (float(scale) - 1.0) * a["flops"]
        credits.setdefault(tag, {})["flops_scale"] = float(scale)
    if args.kernel_credit_mult:
        min_mult, io_bytes = args.kernel_credit_mult.rsplit(":", 1)
        interior = sum((e.result_bytes + e.operand_bytes) * e.multiplier
                       for e in cs.stream.entries
                       if e.multiplier >= int(min_mult))
        d_mem += float(io_bytes) - interior
        credits["mult>=" + min_mult] = {"replaced_mem": interior,
                                        "with_io_bytes": float(io_bytes)}
    if credits:
        rep = adjusted(rep, d_flops=d_flops, d_mem=d_mem,
                       name=rep.name + "+kernels")
        rec["roofline_kernel_credited"] = rep.to_dict()
        rec["kernel_credits"] = credits

    # ---- breakdowns -------------------------------------------------------
    ent = cs.stream.entries
    print(f"\n===== {args.label}: {args.arch} x {args.shape} x "
          f"{args.mesh} =====")
    r = rec["roofline_kernel_credited"] if credits else rec["roofline"]
    print(f"compute={r['compute_s']*1e3:.2f}ms "
          f"memory={r['memory_s']*1e3:.2f}ms "
          f"collective={r['collective_s']*1e3:.2f}ms -> {r['bottleneck']}"
          f"  MFr={r['model_flops_ratio']:.3f} "
          f"RF={r['roofline_fraction']:.4f}")
    m = rec["memory"]
    print(f"mem/device: args={m.get('argument_size_in_bytes', 0)/2**30:.2f} "
          f"temp={m.get('temp_size_in_bytes', 0)/2**30:.2f} GiB")
    print(f"attribution: {json.dumps(rec['attribution'])}")
    for metric, key in (("FLOPS", lambda e: e.flops * e.multiplier),
                        ("MEM", lambda e: (e.result_bytes + e.operand_bytes)
                         * e.multiplier),
                        ("LINK", lambda e: e.link_bytes * e.multiplier)):
        top = sorted(ent, key=key, reverse=True)[:args.top]
        tot = sum(key(e) for e in ent) or 1
        print(f"--- top {metric} ---")
        for e in top:
            if key(e) <= 0:
                break
            print(f"  {100*key(e)/tot:5.1f}% {e.opcode:<18s} "
                  f"x{e.multiplier:<5d} {key(e):.3e}  {e.op_path[-90:]}")

    rec["label"] = args.label
    rec["overrides"] = overrides
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps({k: v for k, v in rec.items()
                            if not k.startswith("_")}) + "\n")
    return rec


if __name__ == "__main__":
    main()
