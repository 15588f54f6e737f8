"""BENCH trajectory: diff consecutive ``BENCH_<pr>.json`` artifacts.

``benchmarks/run.py`` emits one machine-readable artifact per PR (section →
typed rows, session summary, tuned-policy objective).  This module turns
that sequence into a *perf gate*: compare a candidate artifact against a
baseline, flag per-metric regressions beyond a threshold, and render a
markdown trend report.  CI runs it after the quick benchmark pass
(warn-only on GPU-less shared runners — quick CPU timings are noisy; count
metrics like doorbells are deterministic and gate hard).

Metric identity is ``section/rowkey/column``; row keys come from the
section's identity cells (``name``/``mode`` strings plus sweep parameters
like ``nbytes``/``chain_len``), so rows match across artifacts even when
row order changes.  Direction (lower- vs higher-is-better) is inferred from
the column name; identity/size columns are never scored.

Warn-only is a *timing* concession, not a blanket one: with
``--gate-counts``, regressions in deterministic count metrics (doorbells,
command footprint bytes, tokens-per-doorbell — exact on any runner) still
fail the run even under ``--warn-only``.  CI uses exactly that split.

CLI::

    python -m repro_torch.obs.trajectory BENCH_6.json BENCH_7.json BENCH_8.json \
        [--threshold 0.25] [--report TREND.md] [--warn-only] [--gate-counts]
    python -m repro_torch.obs.trajectory --baseline BENCH_7.json \
        --candidate BENCH_ci.json --warn-only --gate-counts --report TREND.md
    python -m repro_torch.obs.trajectory --store loadtest [--store-root DIR]

``--store KIND`` diffs the two newest records of ``KIND`` in the
persistent metrics store (:mod:`repro_torch.obs.store`) instead of BENCH
artifacts — same directions, thresholds, and exit codes.

Exit status: 0 clean (or ``--warn-only`` with no enforced count
regressions), 1 regression(s) beyond threshold, 2 usage / unreadable
artifact.

The port's copy of ``repro.obs.trajectory`` (host code).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["load_artifact", "extract_metrics", "diff_metrics", "Regression",
           "trend_report", "is_count_metric", "main"]

#: columns that identify a row / describe workload size — never scored
SKIP_COLS = frozenset({
    "name", "mode", "nbytes", "chain_len", "steps", "tokens", "requests",
    "new_tokens", "command_bytes_or_bw", "events", "batch", "width",
    "tokens_per_launch", "n",
})
#: substring patterns, checked before the lower-is-better ones
#: ("prefix_hit"/"reused" must win over "pages"/"payload" below: prefix
#: hits and reused pages are the paged-KV savings, more is better)
HIGHER_PATTERNS = ("per_doorbell", "per_s", "bandwidth", "gib",
                   "improvement", "completed", "throughput",
                   "prefix_hit", "reused")
LOWER_PATTERNS = ("latency", "ttft", "overhead", "score", "objective",
                  "dispatch", "doorbell", "final_loss", "evicted",
                  "rejected", "dropped", "payload", "pages",
                  "_us", "_ms", "us", "ms", "wall")


#: deterministic command-stream *count* metrics: exact on any runner, so
#: they gate hard even where timings are warn-only (``--gate-counts``)
COUNT_PATTERNS = ("doorbell", "footprint", "command_bytes", "graph_launch",
                  "rings", "spans", "payload_bytes", "evicted", "rejected",
                  "dropped", "prefix_hit", "pages")
#: anything matching these is a measured quantity, never a count
_TIMING_HINTS = ("per_s", "bandwidth", "gib", "latency", "ttft", "wall",
                 "_us", "_ms")


def direction(col: str) -> Optional[str]:
    """'higher' / 'lower' is better, or None (metric not scored)."""
    c = col.lower()
    if c in SKIP_COLS:
        return None
    for p in HIGHER_PATTERNS:
        if p in c:
            return "higher"
    for p in LOWER_PATTERNS:
        if p in c:
            return "lower"
    if c.endswith("_s"):
        return "lower"
    return None


def is_count_metric(metric: str) -> bool:
    """True for deterministic count metrics (doorbell counts, command
    footprint bytes, tokens-per-doorbell): integer-exact on any runner, so
    a regression there is real no matter how noisy the machine is."""
    col = metric.rsplit("/", 1)[-1].lower()
    if col.endswith(("_s", "_us", "_ms")) or any(h in col
                                                 for h in _TIMING_HINTS):
        return False
    return any(p in col for p in COUNT_PATTERNS)


def load_artifact(path: str) -> Dict[str, Any]:
    with open(path) as f:
        art = json.load(f)
    if "sections" not in art:
        raise ValueError(f"{path}: not a BENCH artifact (no 'sections')")
    art["_path"] = path
    return art


def _row_key(row: Dict[str, Any]) -> str:
    parts = [f"{c}={v}" for c, v in sorted(row.items())
             if isinstance(v, str) or (c in SKIP_COLS and v is not None)]
    return ",".join(parts) or "row"


def extract_metrics(art: Dict[str, Any]) -> Dict[str, Tuple[float, str]]:
    """Flatten an artifact to ``{metric_id: (value, direction)}``.

    Only numeric cells with an inferable direction survive; duplicate row
    keys within a section are dropped (ambiguous identity can't be diffed).
    """
    out: Dict[str, Tuple[float, str]] = {}
    seen_keys: Dict[str, int] = {}
    dupes = set()
    for skey, sec in (art.get("sections") or {}).items():
        for row in sec.get("rows", []):
            rkey = f"{skey}/{_row_key(row)}"
            seen_keys[rkey] = seen_keys.get(rkey, 0) + 1
            if seen_keys[rkey] > 1:
                dupes.add(rkey)
    for skey, sec in (art.get("sections") or {}).items():
        for row in sec.get("rows", []):
            rkey = f"{skey}/{_row_key(row)}"
            if rkey in dupes:
                continue
            for col, val in row.items():
                d = direction(col)
                if d is None or not isinstance(val, (int, float)) \
                        or isinstance(val, bool):
                    continue
                out[f"{rkey}/{col}"] = (float(val), d)
    summ = art.get("session_summary") or {}
    if isinstance(summ.get("total_dispatch_s"), (int, float)):
        out["session/total_dispatch_s"] = (
            float(summ["total_dispatch_s"]), "lower")
    tuning = art.get("tuning") or {}
    if isinstance(tuning.get("after"), (int, float)):
        out["tuning/objective_after"] = (float(tuning["after"]), "lower")
    return out


@dataclasses.dataclass
class Regression:
    metric: str
    base: float
    cand: float
    worsened: float         # fractional change in the "worse" direction
    direction: str

    def describe(self) -> str:
        arrow = "↑" if self.cand >= self.base else "↓"
        return (f"{self.metric}: {self.base:.6g} -> {self.cand:.6g} "
                f"({arrow}{abs(self.worsened)*100:.1f}%, "
                f"{self.direction}-is-better)")


def diff_metrics(base: Dict[str, Tuple[float, str]],
                 cand: Dict[str, Tuple[float, str]],
                 threshold: float = 0.25
                 ) -> Tuple[List[Regression], List[Regression], int]:
    """Compare shared metrics; returns (regressions, improvements, n).

    ``worsened`` is the relative change toward the bad direction; entries
    land in one of the two lists only beyond ``threshold``.  Metrics with a
    zero baseline are skipped (no meaningful relative change).
    """
    regs: List[Regression] = []
    imps: List[Regression] = []
    shared = sorted(set(base) & set(cand))
    for m in shared:
        b, d = base[m]
        c, _ = cand[m]
        if b == 0.0:
            continue
        rel = (c - b) / abs(b)
        worsened = rel if d == "lower" else -rel
        r = Regression(metric=m, base=b, cand=c, worsened=worsened,
                       direction=d)
        if worsened > threshold:
            regs.append(r)
        elif worsened < -threshold:
            imps.append(r)
    regs.sort(key=lambda r: -r.worsened)
    imps.sort(key=lambda r: r.worsened)
    return regs, imps, len(shared)


def _headline(art: Dict[str, Any]) -> Dict[str, Any]:
    summ = art.get("session_summary") or {}
    tuning = art.get("tuning") or {}
    return {
        "pr": art.get("pr"),
        "file": art.get("_path", "?"),
        "quick": art.get("quick"),
        "arch": art.get("arch"),
        "events": summ.get("events"),
        "total_dispatch_s": summ.get("total_dispatch_s"),
        "objective_after": tuning.get("after"),
    }


def trend_report(arts: Sequence[Dict[str, Any]], threshold: float,
                 max_rows: int = 40) -> Tuple[str, List[Regression]]:
    """Markdown trend over a PR-ordered artifact sequence.

    Returns (markdown, regressions-of-the-final-pair) — the final pair is
    the gate (newest committed baseline vs fresh candidate).
    """
    lines = ["# BENCH trajectory report", "",
             f"generated: {time.strftime('%Y-%m-%dT%H:%M:%S')}  ·  "
             f"threshold: {threshold*100:.0f}%", ""]
    lines += ["## Artifacts", "",
              "| pr | file | quick | arch | events | total_dispatch_s | "
              "objective_after |",
              "|---|---|---|---|---|---|---|"]
    for art in arts:
        h = _headline(art)
        disp = (f"{h['total_dispatch_s']:.4g}"
                if isinstance(h["total_dispatch_s"], float) else "—")
        obj = (f"{h['objective_after']:.4g}"
               if isinstance(h["objective_after"], float) else "—")
        lines.append(f"| {h['pr']} | `{h['file']}` | {h['quick']} | "
                     f"{h['arch']} | {h['events']} | {disp} | {obj} |")
    lines.append("")

    gate_regs: List[Regression] = []
    for base, cand in zip(arts, arts[1:]):
        regs, imps, n = diff_metrics(extract_metrics(base),
                                     extract_metrics(cand), threshold)
        pair = (f"pr {base.get('pr')} → pr {cand.get('pr')} "
                f"(`{base.get('_path')}` → `{cand.get('_path')}`)")
        lines += [f"## {pair}", ""]
        if base.get("quick") != cand.get("quick"):
            lines += ["> **note:** quick/full scale mismatch between the "
                      "two artifacts — timing deltas are not comparable; "
                      "treat this diff as informational.", ""]
        lines.append(f"{n} shared metrics · {len(regs)} regressed · "
                     f"{len(imps)} improved (beyond threshold)")
        lines.append("")
        if regs or imps:
            lines += ["| metric | base | candidate | change | verdict |",
                      "|---|---|---|---|---|"]
            for r in (regs + imps)[:max_rows]:
                verdict = ("**REGRESSION**" if r.worsened > 0
                           else "improvement")
                lines.append(
                    f"| `{r.metric}` | {r.base:.6g} | {r.cand:.6g} | "
                    f"{(r.cand - r.base)/abs(r.base)*100:+.1f}% | "
                    f"{verdict} |")
            if len(regs) + len(imps) > max_rows:
                lines.append(f"| … {len(regs) + len(imps) - max_rows} "
                             f"more | | | | |")
        lines.append("")
        gate_regs = regs            # last pair wins: that is the gate
    return "\n".join(lines), gate_regs


def _pr_of(path: str) -> Tuple[int, str]:
    m = re.search(r"(\d+)", os.path.basename(path))
    return (int(m.group(1)) if m else 1 << 30, path)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.trajectory",
        description="Diff BENCH_<pr>.json artifacts; gate on regressions.")
    ap.add_argument("artifacts", nargs="*",
                    help="artifact files, diffed consecutively in PR order")
    ap.add_argument("--baseline", default="",
                    help="explicit baseline (with --candidate)")
    ap.add_argument("--candidate", default="",
                    help="explicit candidate (with --baseline)")
    ap.add_argument("--threshold", type=float, default=0.25,
                    help="fractional regression threshold (default 0.25)")
    ap.add_argument("--report", default="",
                    help="write the markdown trend report here")
    ap.add_argument("--warn-only", action="store_true",
                    help="report regressions but exit 0 (noisy runners)")
    ap.add_argument("--gate-counts", action="store_true",
                    help="deterministic count metrics (doorbells, command "
                         "footprint) fail the run even under --warn-only")
    ap.add_argument("--store", default="", metavar="KIND",
                    help="diff the two newest records of KIND from the "
                         "persistent metrics store instead of artifacts")
    ap.add_argument("--store-root", default=None, metavar="DIR",
                    help="metrics store root (default results/metrics or "
                         "REPRO_METRICS_DIR)")
    args = ap.parse_args(argv)

    if args.store:
        if args.artifacts or args.baseline or args.candidate:
            ap.error("--store replaces artifact arguments")
        from .store import MetricsStore
        store = MetricsStore(root=args.store_root)
        recs = store.records(args.store)
        if len(recs) < 2:
            print(f"trajectory: need >= 2 stored {args.store!r} records "
                  f"in {store.root}, have {len(recs)}")
            return 2
        base_r, cand_r = recs[-2], recs[-1]

        def as_scored(rec) -> Dict[str, Tuple[float, str]]:
            out: Dict[str, Tuple[float, str]] = {}
            for k, v in rec.metrics.items():
                if not isinstance(v, (int, float)) or isinstance(v, bool):
                    continue
                d = direction(k.rsplit("/", 1)[-1])
                if d is not None:
                    out[k] = (float(v), d)
            return out

        regs, imps, n = diff_metrics(as_scored(base_r), as_scored(cand_r),
                                     threshold=args.threshold)
        print(f"store {args.store!r}: {base_r.run_id} ({base_r.git_sha}) "
              f"-> {cand_r.run_id} ({cand_r.git_sha}), "
              f"{n} shared metrics")
        for r in imps:
            print(f"improvement {r.describe()}")
        return _gate_exit(regs, args)

    paths = list(args.artifacts)
    if args.baseline or args.candidate:
        if not (args.baseline and args.candidate) or paths:
            ap.error("--baseline/--candidate are used together, without "
                     "positional artifacts")
        paths = [args.baseline, args.candidate]
    else:
        paths.sort(key=_pr_of)
    if len(paths) < 2:
        ap.error("need at least two artifacts to diff")

    try:
        arts = [load_artifact(p) for p in paths]
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"trajectory: cannot load artifact: {e}")
        return 2

    md, gate_regs = trend_report(arts, threshold=args.threshold)
    if args.report:
        with open(args.report, "w") as f:
            f.write(md + "\n")
        print(f"wrote {args.report}")
    return _gate_exit(gate_regs, args)


def _gate_exit(gate_regs: List[Regression], args: argparse.Namespace) -> int:
    """Shared verdict: print regressions, apply the warn-only/count split."""
    count_regs = [r for r in gate_regs if is_count_metric(r.metric)]
    for r in gate_regs:
        kind = "COUNT " if r in count_regs else ""
        print(f"{kind}REGRESSION {r.describe()}")
    if not gate_regs:
        print("trajectory: no regressions beyond threshold in the gate pair")
        return 0
    enforced = (not args.warn_only) or (args.gate_counts
                                        and bool(count_regs))
    detail = ""
    if args.warn_only:
        detail = (f" [warn-only, but {len(count_regs)} deterministic "
                  f"count regression(s) gate hard]"
                  if enforced else " [warn-only]")
    print(f"trajectory: {len(gate_regs)} regression(s) beyond "
          f"{args.threshold*100:.0f}% in the gate pair{detail}")
    return 1 if enforced else 0


if __name__ == "__main__":
    raise SystemExit(main())
