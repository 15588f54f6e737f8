"""Persistent metrics store: append-only, per-kind JSONL under
``results/metrics/``.

Per-run JSONL traces answer "what happened in *this* run"; the ROADMAP's
trajectory question — is tokens-per-doorbell trending the right way across
PRs, machines, and weeks — needs runs to outlive their processes.  This
store is the minimal durable layer: every record is one JSON line keyed by
``(run_id, git_sha, timestamp)`` with a flat ``{metric_id: value}`` payload,
appended (never rewritten) to ``<root>/<kind>.jsonl``.

The port's copy of ``repro.obs.store``, with the same record format: the
reference's store reads what the port writes, and the other way round.
Writers: ``python -m repro_torch.launch.loadtest --store`` (kinds
``loadtest`` and ``span_profile``), and anything else with a dict of
numbers.  Readers: the
query/trend CLI below, and ``python -m repro_torch.obs.trajectory --store``,
which replays the stored sequence through the same regression gate it runs
on BENCH artifacts.

CLI::

    python -m repro_torch.obs.store list  [--kind bench] [--root DIR]
    python -m repro_torch.obs.store show  RUN_ID [--kind bench]
    python -m repro_torch.obs.store trend --kind loadtest \
        [--keys latency_p50_s,tokens_per_s] [--last 10] [--markdown]

``REPRO_METRICS_DIR`` overrides the root; ``REPRO_RUN_ID`` pins the run id
(so a launcher can stamp every artifact of one run identically).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence

__all__ = ["MetricRecord", "MetricsStore", "default_root", "git_sha",
           "new_run_id", "main"]

_GIT_SHA_CACHE: Optional[str] = None


def default_root() -> str:
    return os.environ.get("REPRO_METRICS_DIR",
                          os.path.join("results", "metrics"))


def git_sha() -> str:
    """The repo HEAD sha (cached; ``REPRO_GIT_SHA`` env override; falls
    back to ``"unknown"`` outside a git checkout)."""
    global _GIT_SHA_CACHE
    if _GIT_SHA_CACHE is None:
        env = os.environ.get("REPRO_GIT_SHA")
        if env:
            _GIT_SHA_CACHE = env
        else:
            try:
                _GIT_SHA_CACHE = subprocess.run(
                    ["git", "rev-parse", "--short=12", "HEAD"],
                    capture_output=True, text=True, timeout=5,
                    check=True).stdout.strip() or "unknown"
            except Exception:
                _GIT_SHA_CACHE = "unknown"
    return _GIT_SHA_CACHE


def new_run_id() -> str:
    """``REPRO_RUN_ID`` if set, else a sortable timestamp-pid id."""
    return os.environ.get(
        "REPRO_RUN_ID",
        f"{time.strftime('%Y%m%dT%H%M%S')}-p{os.getpid()}")


@dataclasses.dataclass(frozen=True)
class MetricRecord:
    """One stored measurement set: who, when, at which commit, what."""

    run_id: str
    git_sha: str
    ts: float                       # epoch seconds
    kind: str                       # store file: <kind>.jsonl
    metrics: Dict[str, Any]         # flat {metric_id: number}
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"run_id": self.run_id, "git_sha": self.git_sha,
                "ts": self.ts, "kind": self.kind, "metrics": self.metrics,
                "meta": self.meta}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MetricRecord":
        return cls(run_id=str(d["run_id"]), git_sha=str(d.get("git_sha", "")),
                   ts=float(d["ts"]), kind=str(d["kind"]),
                   metrics=dict(d.get("metrics") or {}),
                   meta=dict(d.get("meta") or {}))


class MetricsStore:
    """Append-only metrics store rooted at ``results/metrics/`` by default.

    Appends are atomic at line granularity (single ``write`` of one
    ``\\n``-terminated line on a file opened in append mode); reads tolerate
    a truncated trailing line the same way shard aggregation does, so a
    crashed writer never poisons the store.
    """

    def __init__(self, root: Optional[str] = None) -> None:
        self.root = root or default_root()

    def _path(self, kind: str) -> str:
        safe = "".join(c if (c.isalnum() or c in "-_.") else "_"
                       for c in kind) or "misc"
        return os.path.join(self.root, f"{safe}.jsonl")

    # -- writing ------------------------------------------------------------
    def append(self, kind: str, metrics: Dict[str, Any],
               run_id: Optional[str] = None,
               meta: Optional[Dict[str, Any]] = None,
               ts: Optional[float] = None) -> MetricRecord:
        """Record one measurement set; returns the stored record."""
        rec = MetricRecord(run_id=run_id or new_run_id(), git_sha=git_sha(),
                           ts=time.time() if ts is None else float(ts),
                           kind=kind, metrics=dict(metrics),
                           meta=dict(meta or {}))
        os.makedirs(self.root, exist_ok=True)
        with open(self._path(kind), "a") as f:
            f.write(json.dumps(rec.to_dict(), sort_keys=True) + "\n")
        return rec

    # -- reading ------------------------------------------------------------
    def kinds(self) -> List[str]:
        if not os.path.isdir(self.root):
            return []
        return sorted(os.path.splitext(f)[0] for f in os.listdir(self.root)
                      if f.endswith(".jsonl"))

    def records(self, kind: str, run_id: Optional[str] = None,
                since: Optional[float] = None) -> List[MetricRecord]:
        """Stored records of ``kind``, oldest first (append order)."""
        path = self._path(kind)
        if not os.path.exists(path):
            return []
        with open(path) as f:
            lines = f.read().splitlines()
        out: List[MetricRecord] = []
        for i, line in enumerate(lines):
            line = line.strip()
            if not line:
                continue
            try:
                rec = MetricRecord.from_dict(json.loads(line))
            except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                if any(l.strip() for l in lines[i + 1:]):
                    raise
                break               # truncated trailing line: crashed writer
            if run_id is not None and rec.run_id != run_id:
                continue
            if since is not None and rec.ts < since:
                continue
            out.append(rec)
        return out

    def latest(self, kind: str) -> Optional[MetricRecord]:
        recs = self.records(kind)
        return recs[-1] if recs else None

    # -- trend views --------------------------------------------------------
    def trend(self, kind: str, keys: Optional[Sequence[str]] = None,
              last: int = 10, markdown: bool = False) -> str:
        """Cross-run table of selected metrics, oldest -> newest.

        ``keys`` default to the (up to 8) numeric metric ids shared by the
        newest record; direction arrows come from
        :func:`repro_torch.obs.trajectory.direction` so a reader sees at a glance
        which way each column *should* move.
        """
        from .trajectory import direction
        recs = self.records(kind)[-max(1, int(last)):]
        if not recs:
            return f"(no records of kind {kind!r} in {self.root})"
        if not keys:
            newest = recs[-1]
            keys = [k for k, v in sorted(newest.metrics.items())
                    if isinstance(v, (int, float))
                    and not isinstance(v, bool)][:8]
        keys = list(keys)

        def arrow(k: str) -> str:
            d = direction(k.rsplit("/", 1)[-1])
            return {"higher": "↑", "lower": "↓"}.get(d or "", "")

        heads = ["run_id", "git_sha", "when"] + [f"{k}{arrow(k)}"
                                                 for k in keys]
        rows = []
        for r in recs:
            when = time.strftime("%m-%d %H:%M", time.localtime(r.ts))
            cells = [r.run_id, r.git_sha, when]
            for k in keys:
                v = r.metrics.get(k)
                cells.append(f"{v:.6g}" if isinstance(v, (int, float))
                             and not isinstance(v, bool) else "—")
            rows.append(cells)
        if markdown:
            lines = ["| " + " | ".join(heads) + " |",
                     "|" + "---|" * len(heads)]
            lines += ["| " + " | ".join(r) + " |" for r in rows]
            return "\n".join(lines)
        widths = [max(len(h), *(len(r[i]) for r in rows))
                  for i, h in enumerate(heads)]
        lines = ["  ".join(h.ljust(w) for h, w in zip(heads, widths))]
        lines += ["  ".join(c.ljust(w) for c, w in zip(r, widths))
                  for r in rows]
        return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.store",
        description="Query the persistent metrics store "
                    "(results/metrics/*.jsonl).")
    ap.add_argument("--root", default=None,
                    help=f"store root (default {default_root()})")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_list = sub.add_parser("list", help="list kinds / records")
    p_list.add_argument("--kind", default="")
    p_show = sub.add_parser("show", help="print one run's records as JSON")
    p_show.add_argument("run_id")
    p_show.add_argument("--kind", default="")
    p_trend = sub.add_parser("trend", help="cross-run metric trend table")
    p_trend.add_argument("--kind", required=True)
    p_trend.add_argument("--keys", default="",
                         help="comma-separated metric ids (default: auto)")
    p_trend.add_argument("--last", type=int, default=10)
    p_trend.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)

    store = MetricsStore(root=args.root)
    if args.cmd == "list":
        kinds = [args.kind] if args.kind else store.kinds()
        if not kinds:
            print(f"(empty store at {store.root})")
            return 0
        for k in kinds:
            recs = store.records(k)
            print(f"{k}: {len(recs)} record(s)")
            for r in recs[-5:]:
                print(f"  {r.run_id}  {r.git_sha}  "
                      f"{time.strftime('%Y-%m-%d %H:%M', time.localtime(r.ts))}"
                      f"  {len(r.metrics)} metrics")
        return 0
    if args.cmd == "show":
        kinds = [args.kind] if args.kind else store.kinds()
        found = [r for k in kinds for r in store.records(k,
                                                         run_id=args.run_id)]
        if not found:
            print(f"no records for run_id {args.run_id!r}")
            return 1
        for r in found:
            print(json.dumps(r.to_dict(), indent=2, sort_keys=True))
        return 0
    keys = [k for k in args.keys.split(",") if k] or None
    print(store.trend(args.kind, keys=keys, last=args.last,
                      markdown=args.markdown))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
