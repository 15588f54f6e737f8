"""The benchmark's traffic: seeded arrivals from a mix file.

A frozen copy of ``repro_torch.runtime.traffic.generate`` (one numpy
Generator seed fixes arrival times, prompts and budgets), extended with
weighted lengths.  An open loop is a Poisson stream held to its mean
count: ``n = round(rate * horizon)`` requests whose times are drawn
uniform over the window, which is how a Poisson process's arrivals lie
once their number is given, bursts and lulls included; the ``n`` prompt
and output lengths hold each length in its weight's share (largest
remainders), in an order the seed shuffles.  An offline mix queues all its
requests at time 0, in blocks of ``block`` requests, each block holding
every pair of prompt and output length in the share of the product of
their weights, in an order the seed shuffles.  So every seed offers the
same work in another order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["Arrival", "generate", "counts"]


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request, due ``t`` seconds after the window opens."""

    uid: int
    t: float
    prompt: np.ndarray           # [S] int32
    max_new_tokens: int


def counts(weights: Sequence[float], n: int) -> List[int]:
    """``n`` split by ``weights`` (largest remainders, ties to the first)."""
    total = float(sum(weights))
    exact = [w * n / total for w in weights]
    out = [int(math.floor(x)) for x in exact]
    order = sorted(range(len(exact)), key=lambda i: (-(exact[i] - out[i]), i))
    for i in order[:n - sum(out)]:
        out[i] += 1
    return out


def _block_of(lens: Sequence[int], weights: Sequence[float], n: int,
              rng: np.random.Generator) -> List[int]:
    vals = [v for v, c in zip(lens, counts(weights, n)) for _ in range(c)]
    return [vals[i] for i in rng.permutation(n)]


def generate(mix: Dict[str, Any], seed: int, vocab_size: int,
             rate: Optional[float] = None, horizon_s: float = 0.0
             ) -> List[Arrival]:
    """The arrivals of ``mix`` for ``seed``: an open loop's
    ``round(rate * horizon_s)`` over ``[0, horizon_s)``, an offline mix's
    ``queue`` requests at time 0."""
    rng = np.random.default_rng(seed % (1 << 63))
    arrivals: List[Arrival] = []
    if mix["loop"] != "offline":
        if not rate:
            raise ValueError(f"mix {mix['name']!r}: an open loop needs a rate")
        n = int(round(rate * horizon_s))
        times = np.sort(rng.uniform(0.0, horizon_s, size=n))
        plens = _block_of(mix["prompt_lens"], mix["prompt_weights"], n, rng)
        olens = _block_of(mix["output_lens"], mix["output_weights"], n, rng)
        for t, plen, budget in zip(times, plens, olens):
            prompt = rng.integers(0, vocab_size, size=plen).astype(np.int32)
            arrivals.append(Arrival(uid=len(arrivals), t=float(t),
                                    prompt=prompt,
                                    max_new_tokens=int(budget)))
        return arrivals
    block = int(mix["block"])
    pairs = [(p, o) for p in mix["prompt_lens"] for o in mix["output_lens"]]
    w = [a * b for a in mix["prompt_weights"] for b in mix["output_weights"]]
    while True:
        for i in _block_of(list(range(len(pairs))), w, block, rng):
            if len(arrivals) >= int(mix["queue"]):
                return arrivals
            plen, budget = pairs[i]
            prompt = rng.integers(0, vocab_size, size=plen).astype(np.int32)
            arrivals.append(Arrival(uid=len(arrivals), t=0.0, prompt=prompt,
                                    max_new_tokens=int(budget)))
