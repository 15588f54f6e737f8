"""Render markdown tables from the dry-run and hillclimb JSONL records.

The port of ``repro.launch.report_md``::

  python -m repro_torch.launch.report_md [--dryrun results/dryrun_torch.jsonl]
                                         [--hillclimb results/hillclimb_torch.jsonl]

The tables are the reference's, but for one column: the reference asks
whether a cell fits a TPU chip's 16 GiB; the port asks whether it fits the
H100's memory, read from ``core/roofline.py::H100_SXM``, and says so in
the header.  The section titles name the fake 256- and 512-rank meshes
the records come from (``launch/dryrun.py``).
"""
from __future__ import annotations

import argparse
import json
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence

from ..core.roofline import H100_SXM, HW

__all__ = ["roofline_table", "collective_table", "trace_table",
           "hillclimb_table", "main"]

Record = Dict[str, Any]


def _load(path: str) -> List[Record]:
    try:
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
    except FileNotFoundError:
        return []


def _ms(x: float) -> str:
    return f"{x*1e3:.2f}"


def roofline_table(recs: Sequence[Record], mesh: str = "single",
                   hw: HW = H100_SXM) -> str:
    cap = hw.hbm_bytes / 2**30
    rows = ["| arch | shape | compute (ms) | memory (ms) | collective (ms) |"
            f" bound | MODEL/HLO | roofline frac | fits ≤{cap:.0f} GiB "
            f"({hw.name}) |",
            "|---|---|---:|---:|---:|---|---:|---:|---|"]
    # keep the latest record per cell
    latest: "OrderedDict[tuple, Record]" = OrderedDict()
    for r in recs:
        if r.get("mesh") != mesh:
            continue
        latest[(r["arch"], r["shape"])] = r
    for (arch, shape), r in latest.items():
        if r["status"] == "skip":
            rows.append(f"| {arch} | {shape} | — | — | — | SKIP | — | — | — |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {arch} | {shape} | — | — | — | ERROR | — | — | — |")
            continue
        rr = r["roofline"]
        m = r.get("memory", {})
        per_dev = (m.get("argument_size_in_bytes", 0)
                   + m.get("temp_size_in_bytes", 0)
                   + m.get("output_size_in_bytes", 0)) / 2**30
        fits = "yes" if per_dev <= cap else f"no ({per_dev:.0f} GiB)"
        rows.append(
            f"| {arch} | {shape} | {_ms(rr['compute_s'])} "
            f"| {_ms(rr['memory_s'])} | {_ms(rr['collective_s'])} "
            f"| {rr['bottleneck']} | {rr['model_flops_ratio']:.3f} "
            f"| {rr['roofline_fraction']:.4f} | {fits} |")
    return "\n".join(rows)


def collective_table(recs: Sequence[Record], mesh: str = "multi") -> str:
    rows = ["| arch | shape | ICI bytes/device | top collectives |",
            "|---|---|---:|---|"]
    latest: "OrderedDict[tuple, Record]" = OrderedDict()
    for r in recs:
        if r.get("mesh") != mesh or r["status"] != "ok":
            continue
        latest[(r["arch"], r["shape"])] = r
    for (arch, shape), r in latest.items():
        cols = r["stream"].get("collectives", {})
        tops = ", ".join(f"{k}={v/2**20:.0f} MiB" for k, v in
                         sorted(cols.items(), key=lambda kv: -kv[1])[:3])
        rows.append(f"| {arch} | {shape} "
                    f"| {r['roofline']['ici_bytes_per_device']/2**30:.2f} GiB "
                    f"| {tops} |")
    return "\n".join(rows)


def trace_table(recs: Sequence[Record], mesh: str = "single") -> str:
    """Unified-session event accounting per cell (``TraceSession.summary``)."""
    rows = ["| arch | shape | events | compile | dispatch | transfer "
            "| graph_launch | progress | host dispatch (ms) |",
            "|---|---|---:|---:|---:|---:|---:|---:|---:|"]
    latest: "OrderedDict[tuple, Record]" = OrderedDict()
    for r in recs:
        if r.get("mesh") != mesh or r.get("status") != "ok":
            continue
        if "trace" in r:
            latest[(r["arch"], r["shape"])] = r
    for (arch, shape), r in latest.items():
        t = r["trace"]
        k = t.get("by_kind", {})
        rows.append(
            f"| {arch} | {shape} | {t.get('events', 0)} "
            f"| {k.get('compile', 0)} | {k.get('dispatch', 0)} "
            f"| {k.get('transfer', 0)} | {k.get('graph_launch', 0)} "
            f"| {k.get('progress', 0)} "
            f"| {_ms(t.get('total_dispatch_s', 0.0))} |")
    return "\n".join(rows)


def hillclimb_table(recs: Sequence[Record]) -> str:
    rows = ["| label | arch × shape | compute (ms) | memory (ms) "
            "| collective (ms) | bound | roofline frac |",
            "|---|---|---:|---:|---:|---|---:|"]
    for r in recs:
        if r["status"] != "ok":
            continue
        rr = r.get("roofline_kernel_credited") or r["roofline"]
        rows.append(
            f"| {r.get('label', '?')} | {r['arch']} × {r['shape']} "
            f"| {_ms(rr['compute_s'])} | {_ms(rr['memory_s'])} "
            f"| {_ms(rr['collective_s'])} | {rr['bottleneck']} "
            f"| {rr['roofline_fraction']:.4f} |")
    return "\n".join(rows)


def render(dr: Sequence[Record], hc: Sequence[Record],
           section: str = "all") -> str:
    """The report's sections as one markdown string."""
    out: List[str] = []
    if section in ("all", "roofline"):
        out += ["### Fake single-pod mesh (16×16 = 256 ranks): rank-0 "
                "roofline on the H100\n", roofline_table(dr, "single")]
    if section in ("all", "multi"):
        out += ["\n### Fake multi-pod mesh (2×16×16 = 512 ranks): "
                "collective check\n", collective_table(dr, "multi")]
    if section in ("all", "trace"):
        out += ["\n### Unified submission-event timeline (TraceSession)\n",
                trace_table(dr, "single")]
    if section in ("all", "hillclimb"):
        out += ["\n### Hillclimb iterations\n", hillclimb_table(hc)]
    return "\n".join(out)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.report_md")
    ap.add_argument("--dryrun", default="results/dryrun_torch.jsonl")
    ap.add_argument("--hillclimb", default="results/hillclimb_torch.jsonl")
    ap.add_argument("--section", default="all",
                    choices=["all", "roofline", "multi", "trace",
                             "hillclimb"])
    args = ap.parse_args(argv)
    print(render(_load(args.dryrun), _load(args.hillclimb), args.section))


if __name__ == "__main__":
    main()
