"""Listing-1-style decoded submission reports, the port's copy of
``repro.core.report``.

The paper's Listing 1 shows a captured doorbell interception: the GPFIFO
summary (GET/PUT indices, base, new entry) followed by decoded pushbuffer
entries.  This module renders the equivalent for a captured CUDA Graph: the
submission summary (graph-exec handle, footprint, capture and upload time,
memory, FLOPs and bytes, doorbell writes) followed by the decoded graph,
one line a node (a kernel's name, grid, block and shared memory; a copy's or
a fill's bytes and direction).  On the CPU no graph exists, and the report
lists the op-level entries instead.
"""
from __future__ import annotations

from typing import Any, Optional

from .capture import CapturedStream
from .doorbell import DoorbellTracker

__all__ = ["render_submission", "render_roofline_row"]


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}TiB"


def render_submission(cs: CapturedStream,
                      tracker: Optional[DoorbellTracker] = None,
                      max_entries: int = 40) -> str:
    """Render a captured stream like the paper's Listing 1."""
    graph = cs.graph_stream
    lines = []
    lines.append(f"Submission captured: {cs.name}")
    lines.append("==== SUBMISSION SUMMARY ====")
    if graph is not None:
        lines.append(f"graph exec        cudaGraphExec_t@"
                     f"{hex(cs.step.graph.raw_cuda_graph_exec())}")
        lines.append(f"command footprint {_fmt_bytes(cs.command_bytes)} "
                     f"({cs.n_ops} graph nodes: "
                     + ", ".join(f"{k} {v}" for k, v in
                                 graph.counts_by_opcode().items()) + ")")
    else:
        lines.append("graph exec        none: nothing is captured on the CPU")
    lines.append(f"record/capture    {cs.lower_time_s*1e3:.1f} ms / "
                 f"{cs.compile_time_s*1e3:.1f} ms (capture+instantiate+upload)")
    if cs.memory:
        arg = cs.memory.get("argument_size_in_bytes", 0)
        out = cs.memory.get("output_size_in_bytes", 0)
        tmp = cs.memory.get("temp_size_in_bytes")
        lines.append(f"memory            args={_fmt_bytes(arg)} "
                     f"out={_fmt_bytes(out)} temp="
                     + ("n/a" if tmp is None else _fmt_bytes(tmp)))
    lines.append(f"flops/device      {cs.flops:.3e} "
                 f"({cs.stream.n_ops} op-level entries)")
    lines.append(f"hbm bytes/device  {_fmt_bytes(cs.memory_bytes)}")
    lines.append(f"nvlink bytes      {_fmt_bytes(cs.collective_link_bytes)}")
    colls = cs.stream.collective_bytes_by_op()
    if colls:
        lines.append("collective breakdown:")
        for op, b in sorted(colls.items(), key=lambda kv: -kv[1]):
            n = cs.stream.collective_counts().get(op, 0)
            lines.append(f"  {op:<22s} x{n:<6d} {_fmt_bytes(b)}")
    if tracker is not None:
        lines.append(f"doorbell writes   {tracker.count}")
    lines.append("==== END SUBMISSION SUMMARY ====")
    stream = graph if graph is not None else cs.stream
    kind = "graph nodes" if graph is not None else "op-level, no graph"
    lines.append(f"Command-stream entries: {stream.n_ops} ({kind})"
                 + (f" (showing first {max_entries})"
                    if stream.n_ops > max_entries else ""))
    for e in stream.entries[:max_entries]:
        lines.append("  " + e.describe())
    if stream.n_ops > max_entries:
        lines.append(f"  ... {stream.n_ops - max_entries} more")
    return "\n".join(lines)


def render_roofline_row(rep: Any) -> str:
    """One fixed-width roofline table row."""
    return (f"{rep.name:<44s} {rep.chips:>5d} "
            f"{rep.compute_s*1e3:>10.3f} {rep.memory_s*1e3:>10.3f} "
            f"{rep.collective_s*1e3:>10.3f} {rep.bottleneck:<10s} "
            f"{rep.model_flops_ratio:>6.3f} {rep.roofline_fraction:>6.3f}")
