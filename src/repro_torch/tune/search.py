"""Knob-space search: coordinate descent over discrete value ladders.

The port's copy of ``repro.tune.search``, line for line: the same visiting
order, cache key and stopping rule, so the same ``evaluate`` gives the same
trial log in both packages.  The search walks an explicit knob space — each
:class:`Knob` is an ordered ladder of candidate values — and greedily
descends one coordinate at a time until a full round makes no improvement.
Evaluations are cached by knob assignment, so re-visiting a configuration
(common in coordinate descent) costs nothing; every evaluation is kept as a
:class:`Trial` so the search trajectory is auditable in the persisted
policy.

Also home to the ``key:value`` override parsing of the hillclimb CLI
(:func:`parse_value`, :func:`parse_spec`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["Knob", "Trial", "SearchResult", "coordinate_descent",
           "parse_value", "parse_spec"]


@dataclasses.dataclass(frozen=True)
class Knob:
    """One tunable: a name and the ordered ladder of values to consider."""

    name: str
    values: Tuple[Any, ...]
    default: Any = None

    def __post_init__(self) -> None:
        if not self.values:
            raise ValueError(f"knob {self.name!r} has no candidate values")

    def start(self) -> Any:
        return self.default if self.default is not None else self.values[0]


@dataclasses.dataclass
class Trial:
    """One evaluated knob assignment."""

    knobs: Dict[str, Any]
    score: float
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"knobs": dict(self.knobs), "score": self.score,
                "info": dict(self.info)}


@dataclasses.dataclass
class SearchResult:
    best: Dict[str, Any]
    best_score: float
    start_score: float
    trials: List[Trial]
    rounds: int

    @property
    def improvement(self) -> float:
        """Fractional objective reduction vs the starting assignment."""
        if self.start_score <= 0:
            return 0.0
        return (self.start_score - self.best_score) / self.start_score


def coordinate_descent(
        evaluate: Callable[[Dict[str, Any]], Any],
        knobs: Sequence[Knob],
        start: Optional[Dict[str, Any]] = None,
        max_rounds: int = 3,
        log: Optional[Callable[[str], None]] = None) -> SearchResult:
    """Greedy per-coordinate descent over discrete ladders.

    ``evaluate`` maps a full knob assignment to a score (lower is better),
    or to a ``(score, info)`` pair — ``info`` rides along in the trial log.
    Each round sweeps every knob's full ladder with the others held at the
    incumbent; the search stops after a round with no improvement or after
    ``max_rounds`` rounds.
    """
    def _eval(assign: Dict[str, Any]) -> Tuple[float, Dict[str, Any]]:
        out = evaluate(dict(assign))
        if isinstance(out, tuple):
            score, info = out
        else:
            score, info = out, {}
        return float(score), dict(info)

    say = log or (lambda s: None)
    current = {k.name: k.start() for k in knobs}
    if start:
        current.update({k: v for k, v in start.items() if k in current})

    cache: Dict[Tuple, Tuple[float, Dict[str, Any]]] = {}
    trials: List[Trial] = []

    def _score(assign: Dict[str, Any]) -> float:
        key = tuple(assign[k.name] for k in knobs)
        if key not in cache:
            cache[key] = _eval(assign)
            trials.append(Trial(dict(assign), *cache[key]))
            say(f"  trial {assign} -> {cache[key][0]:.3e}")
        return cache[key][0]

    best_score = start_score = _score(current)
    rounds = 0
    for rounds in range(1, max_rounds + 1):
        improved = False
        for knob in knobs:
            for v in knob.values:
                if v == current[knob.name]:
                    continue
                cand = dict(current)
                cand[knob.name] = v
                s = _score(cand)
                if s < best_score:
                    best_score, current, improved = s, cand, True
            say(f"round {rounds}: {knob.name}={current[knob.name]} "
                f"score={best_score:.3e}")
        if not improved:
            break
    return SearchResult(best=current, best_score=best_score,
                        start_score=start_score, trials=trials, rounds=rounds)


# -- CLI spec parsing (the hillclimb CLI's) ---------------------------------

def parse_value(v: str) -> Any:
    """``"True"``/``"False"``/int/float/str, in that order."""
    if v in ("True", "False"):
        return v == "True"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def parse_spec(spec: str) -> Tuple[str, Any]:
    """Split a ``key:value`` spec on the LAST colon.

    Keys are free-form labels (HLO op paths, fusion tags) that may themselves
    contain colons — ``split(":")`` would shear them apart; only the value
    after the final colon is the numeric payload.
    """
    if ":" not in spec:
        raise ValueError(f"expected 'key:value', got {spec!r}")
    key, val = spec.rsplit(":", 1)
    return key, parse_value(val)
