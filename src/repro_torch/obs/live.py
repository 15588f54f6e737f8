"""Live summary streaming: watch a running session without stopping it.

:class:`LiveSummary` is a sink that maintains, incrementally and
thread-safely, the *same schema* as :meth:`TraceSession.summary` — so a
poller sees exactly what a post-mortem ``summary()`` would say, just mid
flight.  :class:`ContinuousBatchingServer` installs one on its session and
exposes it via :meth:`live_summary` / :meth:`start_live_endpoint`.

:class:`LiveServer` is the transport: a stdlib ``ThreadingHTTPServer``
(zero dependencies) serving

* ``GET /summary``  — one JSON snapshot (poll mode);
* ``GET /stream``   — newline-delimited JSON snapshots every ``interval``
  seconds (``?interval=0.5&max=0``; ``max=0`` streams until disconnect);
* ``GET /healthz``  — liveness probe.

Used by ``python -m repro_torch.launch.loadtest --live PORT`` and
``python -m repro_torch.launch.serve --live PORT``.

The port's copy of ``repro.obs.live`` (host code).
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

from ..core.session import EVENT_KINDS, TraceEvent
from .profile import DEFAULT_GROWTH, LogHistogram

__all__ = ["LiveSummary", "LiveServer"]


class LiveSummary:
    """Incremental, thread-safe mirror of ``TraceSession.summary()``.

    Fed as a sink (each ``emit`` folds one event in); :meth:`snapshot`
    returns the accumulated summary under the same keys a session's
    ``summary()`` uses, plus a monotonically increasing ``updates`` counter
    so pollers can cheaply detect change.  Per-kind duration distributions
    are kept in streaming :class:`~repro_torch.obs.profile.LogHistogram`\\ s, so
    ``/summary`` and ``/stream`` report p50/p99 per event kind mid-run
    without ever storing raw samples.
    """

    def __init__(self, name: str = "live",
                 growth: float = DEFAULT_GROWTH) -> None:
        self.name = name
        self.growth = float(growth)
        self._lock = threading.Lock()
        self._t_start = time.perf_counter()
        self._n = 0
        self._by_kind: Dict[str, int] = {}
        self._kind_dur: Dict[str, float] = {}
        self._kind_payload: Dict[str, int] = {}
        self._kind_hist: Dict[str, LogHistogram] = {}
        self._by_name: Dict[str, Dict[str, Any]] = {}
        self._payload = 0
        self._dispatch_s = 0.0

    def emit(self, event: TraceEvent) -> None:
        with self._lock:
            self._n += 1
            k = event.kind
            self._by_kind[k] = self._by_kind.get(k, 0) + 1
            self._kind_dur[k] = self._kind_dur.get(k, 0.0) + event.dur_s
            self._kind_payload[k] = (self._kind_payload.get(k, 0)
                                     + event.payload_bytes)
            hist = self._kind_hist.get(k)
            if hist is None:
                hist = self._kind_hist[k] = LogHistogram(self.growth)
            hist.add(event.dur_s)
            d = self._by_name.setdefault(event.name, {"events": 0,
                                                      "dur_s": 0.0,
                                                      "payload_bytes": 0})
            d["events"] += 1
            d["dur_s"] += event.dur_s
            d["payload_bytes"] += event.payload_bytes
            self._payload += event.payload_bytes
            if k == "dispatch":
                self._dispatch_s += event.dur_s

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            n = self._n
            by_kind = dict(self._by_kind)
            kind_dur = dict(self._kind_dur)
            kind_payload = dict(self._kind_payload)
            percentiles = {k: {"p50": h.percentile(50.0),
                               "p90": h.percentile(90.0),
                               "p99": h.percentile(99.0),
                               "mean": h.mean, "max": h.max}
                           for k, h in self._kind_hist.items()}
            by_name = {k: dict(v) for k, v in self._by_name.items()}
            payload = self._payload
            dispatch_s = self._dispatch_s
        if n == 0:
            by_kind = {k: 0 for k in EVENT_KINDS}
            kind_dur = {k: 0.0 for k in EVENT_KINDS}
            kind_payload = {k: 0 for k in EVENT_KINDS}
        return {
            "session": self.name,
            "events": n,
            "dropped": 0,
            "by_kind": by_kind,
            "dur_s_by_kind": kind_dur,
            "payload_by_kind": kind_payload,
            "dur_percentiles_by_kind": percentiles,
            "by_name": by_name,
            "total_payload_bytes": payload,
            "total_dispatch_s": dispatch_s,
            "wall_s": time.perf_counter() - self._t_start,
            "updates": n,
        }

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"sink": "LiveSummary", "name": self.name,
                    "events": self._n}

    def close(self) -> None:  # sink protocol
        pass


class LiveServer:
    """Tiny threaded HTTP endpoint around a ``snapshot_fn`` callable."""

    def __init__(self, snapshot_fn: Callable[[], Dict[str, Any]],
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self.snapshot_fn = snapshot_fn
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a: Any) -> None:   # silence stderr spam
                pass

            def _json(self, obj: Any, code: int = 200) -> None:
                body = (json.dumps(obj, sort_keys=True) + "\n").encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:
                url = urlparse(self.path)
                if url.path in ("/summary", "/"):
                    self._json(outer.snapshot_fn())
                elif url.path == "/healthz":
                    self._json({"ok": True})
                elif url.path == "/stream":
                    q = parse_qs(url.query)
                    interval = float(q.get("interval", ["0.5"])[0])
                    max_n = int(q.get("max", ["0"])[0])
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/x-ndjson")
                    self.end_headers()
                    sent = 0
                    try:
                        while not outer._stopping.is_set():
                            line = json.dumps(outer.snapshot_fn(),
                                              sort_keys=True) + "\n"
                            self.wfile.write(line.encode())
                            self.wfile.flush()
                            sent += 1
                            if max_n and sent >= max_n:
                                break
                            outer._stopping.wait(interval)
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self._json({"error": f"unknown path {url.path}"},
                               code=404)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._stopping = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def start(self) -> "LiveServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="live-endpoint", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stopping.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
