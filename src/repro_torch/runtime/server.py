"""One-shot serving: batched prefill + greedy decode with doorbell accounting.

The port of ``repro.runtime.server.Server.serve``.  Decode is the
small-submission regime of the paper's study: one token of useful work per
dispatch.  ``tokens_per_launch=T`` runs T decode steps in one wrapped call,
so a T-step block rings one doorbell.  PyTorch runs eagerly, so each doorbell
still issues every kernel of its steps; capturing the block as one CUDA Graph
replay is a later step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.session import TraceSession
from ..models import get_model
from ..models.layers import Params

__all__ = ["Server", "Request"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # [S] int32
    max_new_tokens: int = 16
    tokens: Optional[List[int]] = None


def _empty_metrics() -> Dict[str, Any]:
    return {"wall_s": 0.0, "doorbells": 0, "new_tokens": 0,
            "tokens_per_doorbell": 0.0, "trace_events": 0}


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """[B, S, V] logits -> [B, 1] int32 argmax of the last position."""
    return torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)


class Server:
    """Static-batch greedy server on the flash-attention route.

    ``params`` defaults to the model's seeded init (``seed``); pass a param
    tree to serve given weights (e.g. the reference's, via
    :func:`repro_torch.weights.params_from_jax`).  ``tokens_per_launch=None``
    means 1 (the reference's tuned policy is not ported).
    """

    def __init__(self, cfg: ModelConfig, batch_size: int, max_seq: int,
                 tokens_per_launch: Optional[int] = None, seed: int = 0,
                 session: Optional[TraceSession] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 params: Optional[Params] = None) -> None:
        self.cfg = cfg
        self.B = batch_size
        self.max_seq = max_seq
        self.T = max(1, int(tokens_per_launch or 1))
        self.model = get_model(cfg, impl="cuda", device=device)
        self.device = self.model.device
        # Shared timeline: pass a session to merge serving events with a
        # benchmark's; otherwise the server owns one.
        self.session = session or TraceSession(name="server")
        self.tracker = self.session.doorbell
        self.params = (params if params is not None
                       else self.model.init_params(seed))

        self._prefill = self.tracker.wrap(
            lambda p, toks: self.model.prefill(p, toks, max_seq), "prefill")
        if self.T == 1:
            self._decode = self.tracker.wrap(self.model.decode_step,
                                             "decode_step")
        else:
            self._decode_T = self.tracker.wrap(self._decode_steps,
                                               "decode_T_steps")

    def _decode_steps(self, params: Params, state: Dict[str, torch.Tensor],
                      tokens: torch.Tensor
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """T greedy decode steps in one call; returns (state, tokens [T, B])."""
        out = []
        for _ in range(self.T):
            state, logits = self.model.decode_step(params, state, tokens)
            tokens = _greedy(logits)
            out.append(tokens[:, 0])
        return state, torch.stack(out)

    def _decode_block(self, state: Dict[str, torch.Tensor], nxt: torch.Tensor,
                      want: int
                      ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor],
                                 torch.Tensor]:
        """One multi-token launch; keep only ``want`` tokens.

        The launch always runs ``self.T`` steps; when ``want < T`` the block
        is truncated and only the prefix is useful output.  Returns
        ``(state, tokens, continuation)`` where ``continuation`` is the last
        *kept* token (``tok_block[take - 1]``, not ``tok_block[-1]``).
        """
        state, tok_block = self._decode_T(self.params, state, nxt)
        take = min(self.T, want)
        toks = [tok_block[t] for t in range(take)]
        nxt = tok_block[take - 1][:, None]
        return state, toks, nxt

    def serve(self, requests: List[Request]) -> Dict[str, Any]:
        """Greedy-decode a batch of requests (left-padded to the longest)."""
        if not requests:
            return _empty_metrics()
        if len(requests) > self.B:
            raise ValueError(
                f"got {len(requests)} requests for batch_size={self.B}")
        for r in requests:
            if len(r.prompt) > self.max_seq:
                raise ValueError(
                    f"request {r.uid}: prompt length {len(r.prompt)} exceeds "
                    f"max_seq={self.max_seq}; the decode state would overrun")
        S = max(len(r.prompt) for r in requests)
        toks = np.zeros((self.B, S), np.int32)
        for i, r in enumerate(requests):
            toks[i, S - len(r.prompt):] = r.prompt      # left-pad
        t0 = time.perf_counter()
        # session may be shared with other consumers: report per-run deltas
        db0 = self.tracker.count
        ev0 = self.session.n_events
        max_new = max(r.max_new_tokens for r in requests)
        with self.session.span("serve.oneshot", batch=len(requests),
                               max_new=max_new):
            with self.session.span("serve.prefill", seq_len=S):
                state, logits = self._prefill(
                    self.params, torch.from_numpy(toks).to(self.device))
            nxt = _greedy(logits)
            out = [nxt[:, 0]]
            produced = 1
            while produced < max_new:
                with self.session.span("serve.decode_iter",
                                       produced=produced):
                    if self.T == 1:
                        state, logits = self._decode(self.params, state, nxt)
                        nxt = _greedy(logits)
                        out.append(nxt[:, 0])
                        produced += 1
                    else:
                        state, block, nxt = self._decode_block(
                            state, nxt, max_new - produced)
                        out.extend(block)
                        produced += len(block)
            tokens = torch.stack(out, dim=1).cpu().numpy()   # [B, new]; waits
        wall = time.perf_counter() - t0
        for i, r in enumerate(requests):
            r.tokens = tokens[i, :r.max_new_tokens].tolist()
        doorbells = self.tracker.count - db0
        # useful tokens = what each request asked for, NOT max_new * B
        new_tokens = int(sum(r.max_new_tokens for r in requests))
        return {
            "wall_s": wall,
            "doorbells": doorbells,
            "new_tokens": new_tokens,
            "tokens_per_doorbell": new_tokens / max(1, doorbells),
            "trace_events": self.session.n_events - ev0,
        }
