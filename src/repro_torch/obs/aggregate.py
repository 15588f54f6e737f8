"""Fleet-wide trace aggregation: many per-process shards, one timeline.

The paper's watchpoint observes *one* GPU's command stream completely; the
ROADMAP's fleet is many hosts, each with its own :class:`TraceSession`
writing a JSONL shard under its own monotonic clock (``perf_counter`` is
process-local and starts at an arbitrary zero).  This module merges those
shards back into one cross-host, submission-ordered timeline — the
fleet-wide analogue of "complete capture at the commit point".

Clock-skew alignment
--------------------
Two mechanisms, best one wins per shard:

1. **Shared barriers** (preferred): every process emits
   ``session.barrier("id")`` at the same real moment (after a collective, at
   mesh setup).  For each non-reference shard the offset is the mean of
   ``t_ref(b) - t_shard(b)`` over shared barrier ids — immune to wall-clock
   skew between hosts.
2. **Wall-clock epochs** (fallback): each barrier also records
   ``time.time()``; a shard's epoch (wall time at local ``t=0``) is
   ``mean(wall_b - t_b)``, and offsets are epoch differences.  Only as good
   as NTP, hence the fallback.

Shards with neither stay unaligned (offset 0) and are flagged.

CLI::

    python -m repro_torch.obs.aggregate shard0.jsonl shard1.jsonl \
        [-o merged.jsonl] [--report N] [--summary]

The port's copy of ``repro.obs.aggregate`` (host code).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence

from ..core.session import (BARRIER_EVENT, EVENT_KINDS, JsonlSink,
                            TraceEvent)

__all__ = ["Shard", "MergedTimeline", "load_shard", "align", "merge",
           "aggregate", "summarize", "main"]


@dataclasses.dataclass
class Shard:
    """One process's slice of the fleet timeline."""

    shard_id: str
    events: List[TraceEvent]            # sorted by local seq
    offset_s: float = 0.0               # aligned_t = t + offset_s
    align_mode: str = "none"            # reference|barrier|wall|none

    @property
    def barriers(self) -> Dict[str, float]:
        """barrier_id -> local session time (first occurrence wins)."""
        out: Dict[str, float] = {}
        for e in self.events:
            if e.name == BARRIER_EVENT and "barrier" in e.meta:
                out.setdefault(str(e.meta["barrier"]), e.t)
        return out

    @property
    def epoch(self) -> Optional[float]:
        """Wall-clock estimate of local ``t=0`` from barrier wall readings."""
        samples = [float(e.meta["wall"]) - e.t for e in self.events
                   if e.name == BARRIER_EVENT and "wall" in e.meta]
        if not samples:
            return None
        return sum(samples) / len(samples)


def _shard_id_from(events: Sequence[TraceEvent], path: str) -> str:
    for e in events:
        host = e.meta.get("host")
        proc = e.meta.get("process")
        if host is not None or proc is not None:
            return f"{host or 'host'}/p{proc if proc is not None else 0}"
    return os.path.splitext(os.path.basename(path))[0]


def load_shard(path: str, shard_id: Optional[str] = None) -> Shard:
    """Read one JSONL shard; events are re-sorted by their local ``seq``
    (shard files may be written out of order by async sinks)."""
    events = sorted(JsonlSink.load(path), key=lambda e: e.seq)
    return Shard(shard_id=shard_id or _shard_id_from(events, path),
                 events=events)


def align(shards: Sequence[Shard]) -> List[Shard]:
    """Solve per-shard clock offsets against ``shards[0]`` (the reference).

    Mutates and returns the shards (offset_s / align_mode filled in).
    """
    if not shards:
        return []
    ref = shards[0]
    ref.offset_s, ref.align_mode = 0.0, "reference"
    ref_b = ref.barriers
    ref_epoch = ref.epoch
    for s in list(shards)[1:]:
        shared = sorted(set(ref_b) & set(s.barriers))
        if shared:
            sb = s.barriers
            s.offset_s = sum(ref_b[b] - sb[b] for b in shared) / len(shared)
            s.align_mode = "barrier"
        elif ref_epoch is not None and s.epoch is not None:
            s.offset_s = s.epoch - ref_epoch
            s.align_mode = "wall"
        else:
            s.offset_s, s.align_mode = 0.0, "none"
    return list(shards)


def merge(shards: Sequence[Shard]) -> "MergedTimeline":
    """Interleave aligned shards into one submission-ordered timeline.

    Every merged event is re-stamped: ``t`` becomes the aligned time,
    ``seq`` the global submission index, and ``meta`` gains
    ``shard``/``src_seq`` so provenance survives the merge.  Ordering is by
    ``(aligned_t, shard_id, local seq)`` — deterministic for any input
    permutation, and a re-merge of the merged output is a fixed point.
    """
    keyed = []
    for s in shards:
        for e in s.events:
            keyed.append((e.t + s.offset_s, s.shard_id, e.seq, e))
    keyed.sort(key=lambda k: k[:3])
    merged: List[TraceEvent] = []
    for gseq, (t_al, sid, sseq, e) in enumerate(keyed):
        meta = dict(e.meta)
        meta.setdefault("shard", sid)
        meta.setdefault("src_seq", sseq)
        merged.append(dataclasses.replace(e, seq=gseq, t=t_al, meta=meta))
    return MergedTimeline(events=merged, shards=list(shards))


def aggregate(paths: Sequence[str]) -> "MergedTimeline":
    """load + align + merge, in one call (the library entry point)."""
    return merge(align([load_shard(p) for p in paths]))


def summarize(events: Iterable[TraceEvent],
              name: str = "aggregate") -> Dict[str, Any]:
    """Session-schema summary recomputed from an event list.

    Same keys as :meth:`TraceSession.summary` (``dropped`` is always 0 —
    whatever reached the shard is what there is; ``wall_s`` is the timeline
    span).  Defined so that, alignment metadata aside, the summary of a
    merged timeline equals the elementwise sum of its shards' summaries.
    """
    evs = list(events)
    by_kind: Dict[str, int] = {}
    kind_dur: Dict[str, float] = {}
    kind_payload: Dict[str, int] = {}
    by_name: Dict[str, Dict[str, Any]] = {}
    payload = 0
    dispatch_s = 0.0
    for e in evs:
        by_kind[e.kind] = by_kind.get(e.kind, 0) + 1
        kind_dur[e.kind] = kind_dur.get(e.kind, 0.0) + e.dur_s
        kind_payload[e.kind] = kind_payload.get(e.kind, 0) + e.payload_bytes
        d = by_name.setdefault(e.name, {"events": 0, "dur_s": 0.0,
                                        "payload_bytes": 0})
        d["events"] += 1
        d["dur_s"] += e.dur_s
        d["payload_bytes"] += e.payload_bytes
        payload += e.payload_bytes
        if e.kind == "dispatch":
            dispatch_s += e.dur_s
    if not evs:
        by_kind = {k: 0 for k in EVENT_KINDS}
        kind_dur = {k: 0.0 for k in EVENT_KINDS}
        kind_payload = {k: 0 for k in EVENT_KINDS}
    return {
        "session": name,
        "events": len(evs),
        "dropped": 0,
        "by_kind": by_kind,
        "dur_s_by_kind": kind_dur,
        "payload_by_kind": kind_payload,
        "by_name": by_name,
        "total_payload_bytes": payload,
        "total_dispatch_s": dispatch_s,
        "wall_s": (max(e.t for e in evs) - min(e.t for e in evs)
                   if evs else 0.0),
    }


@dataclasses.dataclass
class MergedTimeline:
    """The fleet timeline: aligned, interleaved, provenance-tagged."""

    events: List[TraceEvent]
    shards: List[Shard]

    def summary(self) -> Dict[str, Any]:
        s = summarize(self.events, name="aggregate")
        s["alignment"] = {sh.shard_id: {"offset_s": sh.offset_s,
                                        "mode": sh.align_mode,
                                        "events": len(sh.events)}
                          for sh in self.shards}
        return s

    def timeline(self, kinds: Optional[Iterable[str]] = None,
                 shard: Optional[str] = None) -> List[TraceEvent]:
        evs = self.events
        if kinds is not None:
            ks = {kinds} if isinstance(kinds, str) else set(kinds)
            evs = [e for e in evs if e.kind in ks]
        if shard is not None:
            evs = [e for e in evs if e.meta.get("shard") == shard]
        return list(evs)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e.to_dict()) + "\n")

    def report(self, max_events: int = 60) -> str:
        lines = [f"==== AGGREGATED TIMELINE ({len(self.shards)} shards, "
                 f"{len(self.events)} events) ===="]
        for sh in self.shards:
            lines.append(f"  shard {sh.shard_id}: {len(sh.events)} events, "
                         f"offset={sh.offset_s*1e3:+.3f}ms "
                         f"({sh.align_mode})")
        lines.append(f"{'seq':>6s}  {'t':>12s}  {'kind':<12s} "
                     f"{'name':<28s} host-cost")
        for e in self.events[:max_events]:
            lines.append(e.describe() + f"  [{e.meta.get('shard')}]")
        if len(self.events) > max_events:
            lines.append(f"  ... {len(self.events) - max_events} more")
        lines.append("==== END AGGREGATED TIMELINE ====")
        return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.aggregate",
        description="Merge per-process TraceSession JSONL shards into one "
                    "cross-host submission-ordered timeline.")
    ap.add_argument("shards", nargs="+", help="per-process .jsonl files")
    ap.add_argument("-o", "--out", default="",
                    help="write the merged timeline as JSONL here")
    ap.add_argument("--report", type=int, default=24, metavar="N",
                    help="print the first N merged events (0 to silence)")
    ap.add_argument("--summary", action="store_true",
                    help="print the merged session-schema summary as JSON")
    args = ap.parse_args(argv)

    merged = aggregate(args.shards)
    if args.report:
        print(merged.report(max_events=args.report))
    if args.summary:
        print(json.dumps(merged.summary(), indent=2, sort_keys=True))
    if args.out:
        merged.save(args.out)
        print(f"wrote {args.out} ({len(merged.events)} events)")
    unaligned = [s.shard_id for s in merged.shards if s.align_mode == "none"]
    if len(merged.shards) > 1 and unaligned:
        print(f"warning: no barrier/wall alignment for {unaligned}; "
              f"their clocks are merged as-is")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
