"""What decides ``correct``: the served tokens against the plain reference.

Once the window has closed and the engine is freed, a sample of the
requests the run finished, drawn from the seed and holding the one with
the most served tokens, goes through the reference of the configuration's
family (``bench/reference/<family>.py``) on the same weights: each prompt
with its served tokens, teacher-forced, a block of requests at a time.  At
every served position the number read is the gap by which the served
token's reference logit lies below the reference's best.  The run reads
the widest such gap (``max_logit_gap``), their 90th percentile
(``p90_logit_gap``) and, over the requests, the largest share of a
request's tokens that lie more than ``OFF`` logits below
(``worst_request_off_share``), and compares those its cell gives a limit
(``check.limits``), with no failed request.  Greedy serving gives gaps of
0 up to near-ties that bf16 rounding flips; a token that is not the
request's own greedy chain (a wrong cache, another slot's token, a stale
step) lies far below, and a fault confined to one slot puts most of its
requests' tokens there.

The control is the same reference computed in float8 in the program's
place (``control=True``): at every position of the same sequences, the gap
of the token it puts first.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import registry, stats
from .stats import INF

__all__ = ["OFF", "sample", "sequences", "gaps", "summary", "readings",
           "judge"]

#: logits below the reference's best at which a served token is off
OFF = 0.5
#: requests a pass of the reference takes
BLOCK = 16


def sample(reqs: Sequence[Any], seed: int, n: int) -> List[Any]:
    """Up to ``n`` finished requests: the one with the most served tokens,
    and the rest drawn from the seed."""
    done = [r for r in reqs if stats.ok(r)]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.ticket.tokens), -r.arrival.uid))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng((seed + 1) % (1 << 63))
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def sequences(reqs: Sequence[Any]) -> List[Tuple[np.ndarray, int]]:
    """Each prompt with its served tokens but the last: the positions
    ``prompt_len - 1 ..`` predict the served tokens."""
    out = []
    for r in reqs:
        toks = np.asarray(r.ticket.tokens, np.int64)
        prompt = np.asarray(r.arrival.prompt, np.int64)
        out.append((np.concatenate([prompt, toks[:-1]]), len(prompt)))
    return out


def _gaps(ref: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    return ref.max(dim=-1).values - ref.gather(1, chosen[:, None])[:, 0]


def gaps(weights: Any, cfg: Dict[str, Any], reqs: Sequence[Any],
         control: bool = False) -> List[torch.Tensor]:
    """The gap of every served token of each request (float32, on the
    host); with ``control``, the gaps of the float8 reference's first
    choices at the same positions instead."""
    ref = registry.reference(cfg["family"])
    out: List[torch.Tensor] = []
    with torch.no_grad():
        for a in range(0, len(reqs), BLOCK):
            part = reqs[a:a + BLOCK]
            seqs = sequences(part)
            hi = ref.logits(weights, cfg, seqs, "fp32")
            if control:
                chosen = [lg.argmax(dim=-1)
                          for lg in ref.logits(weights, cfg, seqs, "fp8")]
            else:
                chosen = [torch.as_tensor(r.ticket.tokens, device=h.device)
                          for r, h in zip(part, hi)]
            out += [_gaps(h, c).float().cpu() for h, c in zip(hi, chosen)]
            del hi, chosen
    return out


def summary(per_request: Sequence[torch.Tensor]) -> Dict[str, float]:
    """The numbers a cell may compare: the widest gap, the 90th percentile
    (nearest rank) of the gaps, and the largest share of one request's
    gaps over ``OFF``; infinite where none was read."""
    rows = [g for g in per_request if len(g)]
    if not rows:
        return {"max_logit_gap": INF, "p90_logit_gap": INF,
                "worst_request_off_share": INF}
    g = torch.cat(rows)
    return {"max_logit_gap": float(g.max()),
            "p90_logit_gap": stats.percentile(g.tolist(), 90),
            "worst_request_off_share": max(float((r > OFF).double().mean())
                                           for r in rows)}


def readings(weights: Any, cfg: Dict[str, Any], reqs: Sequence[Any],
             control: bool = False) -> Dict[str, float]:
    """The numbers of :func:`summary` on the served tokens of ``reqs`` (or
    the control's), and how many tokens and requests they were read on."""
    g = gaps(weights, cfg, reqs, control) if reqs else []
    return {**summary(g), "tokens": sum(len(x) for x in g),
            "requests": len(reqs)}


def judge(got: Dict[str, float], limits: Dict[str, float], n_failed: int
          ) -> Tuple[Dict[str, Dict[str, float]], bool]:
    """Each number that has a limit beside it, and no failed request:
    (the numbers compared, whether all are within their limits)."""
    checks = {n: {"value": got[n], "limit": float(v)}
              for n, v in limits.items()}
    checks["failed_requests"] = {"value": n_failed, "limit": 0}
    return checks, bool(got["tokens"] > 0 and all(
        c["value"] <= c["limit"] for c in checks.values()))
