"""Objective: score a candidate policy from TraceSession measurements.

The port's copy of ``repro.tune.objective``.  The tuner's ground truth is
the unified submission timeline: host dispatch time, submission cycles
(doorbells), and transfer cost, all read from
:meth:`repro_torch.core.session.TraceSession.summary` (the reference's
schema).  :class:`Metrics` extracts the relevant accumulators (supporting
before/after deltas so warm-up and CUDA Graph capture can be excluded), and
:class:`Objective` folds them into one scalar **host cost per unit of useful
work** — lower is better.  The score's formula and its float64 order of
operations are the reference's, bit for bit, including where that order
loses a dispatch time too small to move the sum: the score never decreases
in dispatch time, and rises strictly once ``dispatch * (d_hi - d_lo)``
exceeds a few ulps of the cost (``tests/test_torch_tune.py``).

On the card a doorbell's ``dispatch_s`` is the host's time to enqueue a
CUDA Graph replay, not the device's time to run it: the objective scores
host cost only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

__all__ = ["Metrics", "ObjectiveWeights", "Objective", "metrics_from_summary"]


@dataclasses.dataclass
class Metrics:
    """Submission-cost accumulators for one measured run (or run delta)."""

    dispatch_s: float = 0.0        # host time spent in dispatch events
    doorbells: int = 0             # submission cycles (dispatch-kind events)
    transfer_s: float = 0.0        # host time spent submitting transfers
    transfer_bytes: int = 0        # payload bytes moved by transfers
    compile_s: float = 0.0         # compile-kind time (reported, not scored)
    wall_s: float = 0.0
    tokens: int = 0                # useful work units (tokens, steps, puts)

    @property
    def doorbells_per_token(self) -> float:
        return self.doorbells / max(1, self.tokens)

    @property
    def transfer_bandwidth_gib_s(self) -> float:
        return self.transfer_bytes / max(self.transfer_s, 1e-12) / 2**30

    def __sub__(self, other: "Metrics") -> "Metrics":
        return Metrics(
            dispatch_s=self.dispatch_s - other.dispatch_s,
            doorbells=self.doorbells - other.doorbells,
            transfer_s=self.transfer_s - other.transfer_s,
            transfer_bytes=self.transfer_bytes - other.transfer_bytes,
            compile_s=self.compile_s - other.compile_s,
            wall_s=self.wall_s - other.wall_s,
            tokens=self.tokens - other.tokens)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["doorbells_per_token"] = self.doorbells_per_token
        d["transfer_bandwidth_gib_s"] = self.transfer_bandwidth_gib_s
        return d


def metrics_from_summary(summary: Dict[str, Any],
                         before: Optional[Dict[str, Any]] = None,
                         tokens: int = 0) -> Metrics:
    """Extract :class:`Metrics` from ``TraceSession.summary()`` output.

    ``before`` subtracts an earlier snapshot of the *same* session, so a
    caller can warm up (compile, first dispatch) and measure only the steady
    state — the regime a persisted policy will actually run in.
    """
    def _one(s: Dict[str, Any]) -> Metrics:
        kinds = s.get("by_kind", {})
        dur = s.get("dur_s_by_kind", {})
        payload = s.get("payload_by_kind", {})
        return Metrics(
            dispatch_s=float(dur.get("dispatch",
                                     s.get("total_dispatch_s", 0.0))),
            doorbells=int(kinds.get("dispatch", 0)),
            transfer_s=float(dur.get("transfer", 0.0)),
            transfer_bytes=int(payload.get("transfer", 0)),
            compile_s=float(dur.get("compile", 0.0)),
            wall_s=float(s.get("wall_s", 0.0)))

    m = _one(summary)
    if before is not None:
        m = m - _one(before)
    m.tokens = int(tokens)
    return m


@dataclasses.dataclass(frozen=True)
class ObjectiveWeights:
    """Cost model weights, all in host seconds (non-negative).

    ``doorbell_cost_s`` charges each submission cycle a fixed host-side
    overhead beyond its measured dispatch time — the paper's §6.3 point that
    submission *cycles*, not just submission *time*, bound small-kernel
    throughput (ring write + fence + scheduler wakeup are not all visible in
    the dispatch duration).
    """

    dispatch: float = 1.0
    transfer: float = 1.0
    doorbell_cost_s: float = 5e-6

    def __post_init__(self) -> None:
        if self.dispatch <= 0 or self.transfer < 0 or self.doorbell_cost_s < 0:
            raise ValueError("weights must be non-negative "
                             "(dispatch strictly positive)")


class Objective:
    """Scalar host cost per unit of work; lower is better."""

    def __init__(self, weights: ObjectiveWeights = ObjectiveWeights()) -> None:
        self.weights = weights

    def score(self, m: Metrics) -> float:
        w = self.weights
        cost = (w.dispatch * m.dispatch_s
                + w.transfer * m.transfer_s
                + w.doorbell_cost_s * m.doorbells)
        return cost / max(1, m.tokens)

    def score_summary(self, summary: Dict[str, Any],
                      before: Optional[Dict[str, Any]] = None,
                      tokens: int = 0) -> float:
        return self.score(metrics_from_summary(summary, before, tokens))
