"""Plain reference of the sparse-expert decoder (Qwen1.5-MoE-A2.7B's block:
the dense decoder of ``dense.py`` with its MLP replaced by a softmax router
over the routed experts, the top ``num_experts_per_tok`` SwiGLU experts
weighted by their router probabilities, and the shared expert added), with
the configuration file's ``departures`` where they stand in for its values:
the top-k weights renormalised (``norm_topk_prob``), the shared expert
ungated, and a whole-prompt prefill's capacity: of the prompt's S tokens an
expert keeps the first ``C = min(S, max(1, floor(S * k * capacity_factor /
E)))`` that chose it, by position, and drops the rest of its choices.  Every position after the
prompt is a decode row of its own and drops nothing.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import dense
from .dense import Precision

__all__ = ["logits", "ffn_moe", "route"]

Tree = Dict[str, Any]


def _swiglu(prec: Precision, h: torch.Tensor, wg: torch.Tensor,
            wu: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    g = prec.mm(h, wg)
    return prec.mm(torch.nn.functional.silu(g) * prec.mm(h, wu), wd)


def route(probs: torch.Tensor, k: int, normalise: bool
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of the router's probabilities [N, E] (ties to the lower
    expert): (weights [N, k], experts [N, k])."""
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :k], ids[:, :k]
    if normalise:
        w = w / w.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return w, ids


def _kept(ids: torch.Tensor, prompt_len: int, E: int, cf: float
          ) -> torch.Tensor:
    """[N, k] True where a sequence's choice is served: every choice after
    the prompt, and of the prompt's, an expert's first C by position."""
    N, k = ids.shape
    S = prompt_len
    C = min(S, max(1, int(S * k * cf / E)))
    keep = torch.ones(N, k, dtype=torch.bool, device=ids.device)
    onehot = torch.nn.functional.one_hot(ids[:S], E).sum(dim=1)   # [S, E]
    before = torch.cumsum(onehot, dim=0) - onehot      # earlier tokens' picks
    rank = before.gather(1, ids[:S])                   # [S, k]
    keep[:S] = rank < C
    return keep


def ffn_moe(p: Tree, h: torch.Tensor, cfg: Dict[str, Any], prec: Precision,
            prompt_lens: Sequence[int], lengths: Sequence[int]
            ) -> torch.Tensor:
    """The MoE block on the normed rows of every sequence, concatenated."""
    m = p["moe"]
    E, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    cf = float(cfg["departures"]["prefill_capacity_factor"])
    probs = torch.softmax(prec.mm(h, m["router"]), dim=-1)
    w, ids = route(probs, k, bool(cfg["departures"].get(
        "norm_topk_prob", cfg["norm_topk_prob"])))
    keeps: List[torch.Tensor] = []
    at = 0
    for S, n in zip(prompt_lens, lengths):
        keeps.append(_kept(ids[at:at + n], S, E, cf))
        at += n
    w = w * torch.cat(keeps).float()
    y = torch.zeros_like(h)
    for e in range(E):
        rows, slot = torch.nonzero(ids == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        out = _swiglu(prec, h[rows], m["w_gate"][e], m["w_up"][e],
                      m["w_down"][e])
        y.index_add_(0, rows, out * w[rows, slot, None])
    s = m["shared"]
    for j in range(s["w_gate"].shape[0]):
        y = y + _swiglu(prec, h, s["w_gate"][j], s["w_up"][j], s["w_down"][j])
    return y


def logits(weights: Tree, cfg: Dict[str, Any],
           seqs: Sequence[Tuple[np.ndarray, int]],
           precision: str = "fp32") -> List[torch.Tensor]:
    """As :func:`dense.logits`, with the MoE block."""
    return dense.logits(weights, cfg, seqs, precision, ffn=ffn_moe)
