"""repro_torch.obs — fleet-wide observability on top of :class:`TraceSession`.

The port's copy of ``repro.obs``: host code, no device work.  The same
event streams give the reference's roll-ups, snapshots, merges, exports and
verdicts (``tests/test_torch_obs.py``).

The paper's contribution is *complete capture at the commit point* for one
GPU; this package scales that observation model to the ROADMAP's fleet:

* :mod:`repro_torch.obs.sinks`      — :class:`AsyncSink` (bounded queue + writer
  thread; the decode loop never blocks on trace I/O) and
  :class:`SamplingSink` (deterministic per-kind decimation), both with
  exact drop/sample accounting so observability loss is itself observable;
* :mod:`repro_torch.obs.aggregate`  — merge per-process JSONL shards into one
  cross-host submission-ordered timeline, aligning per-process monotonic
  clocks via shared barrier events (``python -m repro_torch.obs.aggregate``);
* :mod:`repro_torch.obs.live`       — :class:`LiveSummary` (incremental,
  session-schema summary) + :class:`LiveServer` (stdlib HTTP poll/stream
  endpoint the serving engine exposes);
* :mod:`repro_torch.obs.trajectory` — the ``BENCH_<pr>.json`` perf gate:
  per-metric regression detection and a markdown trend report
  (``python -m repro_torch.obs.trajectory``; deterministic count metrics gate
  hard via ``--gate-counts``);
* :mod:`repro_torch.obs.profile`    — :class:`SpanProfile`: per-span causal
  command attribution (doorbells, payload, graph launches per request /
  decode iteration / train step) with streaming :class:`LogHistogram`
  percentiles — no raw samples retained;
* :mod:`repro_torch.obs.export`     — Chrome-trace / Perfetto JSON export of any
  timeline (``python -m repro_torch.obs.export``): scoped spans as nested
  slices, request spans as async pairs, shards as processes;
* :mod:`repro_torch.obs.store`      — :class:`MetricsStore`: append-only
  persistent metrics keyed by (run_id, git_sha, timestamp) under
  ``results/metrics/`` with a query/trend CLI
  (``python -m repro_torch.obs.store``).
"""
from .aggregate import (MergedTimeline, Shard, aggregate, align, load_shard,
                        merge, summarize)
from .export import to_chrome_trace
from .live import LiveServer, LiveSummary
from .profile import LogHistogram, SpanProfile
from .sinks import AsyncSink, SamplingSink
from .store import MetricRecord, MetricsStore

__all__ = [
    "AsyncSink", "SamplingSink",
    "LiveServer", "LiveSummary",
    "LogHistogram", "SpanProfile",
    "MetricRecord", "MetricsStore",
    "MergedTimeline", "Shard", "aggregate", "align", "load_shard", "merge",
    "summarize", "to_chrome_trace",
]
