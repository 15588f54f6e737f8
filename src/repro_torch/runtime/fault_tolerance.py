"""Fault tolerance: heartbeats, straggler mitigation, restart, elastic
re-mesh: the port's copy of ``repro.runtime.fault_tolerance``.

Built on the paper's progress-tracker primitive (core/semaphore.py): a
worker's step completion *is* its heartbeat, exactly like a semaphore
release proves command completion within a channel.

Policies (all exercised by tests with injected failures):

* **straggler detection** — workers whose inter-beat interval lags the fleet
  median by ``straggler_factor`` are flagged; mitigation = re-dispatching the
  laggard's shard (simulated single-process: the shard is recomputed by the
  survivor pool).
* **fail-stop + restart** — a dead worker (no beat within ``dead_timeout``)
  triggers restore-from-latest-checkpoint; the deterministic pipeline
  regenerates the exact batch sequence, so recovery is bit-exact.
* **elastic re-mesh** — when the fleet shrinks/grows, ``plan_elastic_mesh``
  picks the largest (data × model) grid that divides the survivors and whose
  model axis still divides the arch's TP-sharded dims; training resumes on
  the new mesh from the checkpoint.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..core.semaphore import Heartbeat

__all__ = ["FaultPolicy", "FleetMonitor", "plan_elastic_mesh"]


@dataclasses.dataclass
class FaultPolicy:
    straggler_factor: float = 3.0
    dead_timeout_s: float = 30.0
    max_restarts: int = 16


class FleetMonitor:
    """Tracks per-worker liveness from step completions."""

    def __init__(self, n_workers: int, policy: Optional[FaultPolicy] = None
                 ) -> None:
        self.policy = policy or FaultPolicy()
        self.hb = Heartbeat(n_workers, self.policy.straggler_factor)
        self.n_workers = n_workers
        self.restarts = 0
        self.events: List[Dict] = []

    def step_completed(self, worker: int, t: Optional[float] = None) -> None:
        self.hb.beat(worker, t)

    def check(self, now: Optional[float] = None
              ) -> Tuple[List[int], List[int]]:
        """(stragglers, dead) at time ``now``."""
        now = time.perf_counter() if now is None else now
        dead = self.hb.dead(self.policy.dead_timeout_s, now)
        stragglers = [w for w in self.hb.stragglers(now) if w not in dead]
        if stragglers:
            self.events.append({"t": now, "stragglers": stragglers})
        if dead:
            self.events.append({"t": now, "dead": dead})
        return stragglers, dead

    def should_restart(self, dead: List[int]) -> bool:
        if not dead:
            return False
        self.restarts += 1
        if self.restarts > self.policy.max_restarts:
            raise RuntimeError("restart budget exhausted")
        return True


def plan_elastic_mesh(n_devices: int, model_dims: List[int],
                      prefer_model: int = 16) -> Tuple[int, int]:
    """Largest (data, model) grid for a shrunken/grown fleet.

    ``model_dims`` are the tensor dims that must stay divisible by the model
    axis (e.g. d_ff, padded heads, padded vocab).  Preference order: keep the
    model axis as close to ``prefer_model`` as possible, then maximize total
    devices used.
    """
    best: Optional[Tuple[int, int]] = None
    best_score = (-1, -1)
    for model in range(min(prefer_model, n_devices), 0, -1):
        if any(d % model for d in model_dims if d):
            continue
        data = n_devices // model
        if data == 0:
            continue
        used = data * model
        score = (used, -abs(model - prefer_model))
        if score > best_score:
            best_score = score
            best = (data, model)
    if best is None:
        best = (n_devices, 1)
    return best
