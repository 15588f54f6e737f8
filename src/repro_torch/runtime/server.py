"""One-shot serving: batched prefill + greedy decode with doorbell accounting.

The port of ``repro.runtime.server.Server.serve``.  Decode is the
small-submission regime of the paper's study: one token of useful work per
dispatch.  ``tokens_per_launch=T`` runs T decode steps in one wrapped call,
so a T-step block rings one doorbell.

Each doorbell is one CUDA Graph replay on the card, as each is one
``jax.jit`` dispatch in the reference: the prefill is one graph per prompt
length (as ``jax.jit`` compiles one per shape), the T-step decode block one
graph holding T steps and their greedy argmax (the reference's
``lax.scan``).  The graphs work on buffers allocated once per ``Server``:
the decode state, the prompt ``[B, max_seq]``, the decode input token
``[B, 1]`` and the block's tokens ``[T, B]``.  On the CPU (``device="cpu"``)
the same step functions run directly on the same buffers.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.graphs import CapturedStep
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
    """Static-batch greedy server on the kernel route (``impl="cuda"``) of
    the config's family: dense transformer or Mamba2.

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

        # fixed buffers of every graph; the graphs also bake in self.params
        self.state = self.model.init_decode_state(batch_size, max_seq)
        self._prompt = torch.zeros(batch_size, max_seq, dtype=torch.int32,
                                   device=self.device)
        self._tok = torch.zeros(batch_size, 1, dtype=torch.int32,
                                device=self.device)
        self._block = torch.zeros(self.T, batch_size, dtype=torch.int32,
                                  device=self.device)
        self._prefill_graphs: Dict[int, CapturedStep] = {}
        self._decode_graph = CapturedStep(self._decode_steps, self.device)

        # the doorbells: the reference's names and arguments, so dispatch
        # names and payload bytes equal its own
        self._prefill = self.tracker.wrap(self._prefill_call, "prefill")
        if self.T == 1:
            self._decode = self.tracker.wrap(self._decode_call, "decode_step")
        else:
            self._decode_T = self.tracker.wrap(self._decode_call,
                                               "decode_T_steps")

    def graphs(self) -> Dict[str, CapturedStep]:
        """The server's steps by name (``"prefill S=<n>"``, ``"decode
        T=<T>"``): one CUDA graph each once captured on the card."""
        out = {f"prefill S={S}": g for S, g in self._prefill_graphs.items()}
        out[f"decode T={self.T}"] = self._decode_graph
        return out

    def _check_params(self, params: Params) -> None:
        if params is not self.params:
            raise ValueError("this Server's graphs are bound to its own "
                             "params; serve another param tree from another "
                             "Server")

    def _prefill_step(self, S: int) -> Callable[[], None]:
        def step() -> None:
            _, logits = self.model.prefill(self.params, self._prompt[:, :S],
                                           self.max_seq, state=self.state)
            self._tok.copy_(_greedy(logits))
        return step

    def _decode_steps(self) -> None:
        """T greedy decode steps on the fixed state: the tokens go to the
        block ``[T, B]`` and the last one back into the input."""
        tokens = self._tok
        for t in range(self.T):
            _, logits = self.model.decode_step(self.params, self.state, tokens)
            tokens = _greedy(logits)
            self._block[t].copy_(tokens[:, 0])
        self._tok.copy_(tokens)

    def _prefill_call(self, params: Params, toks: torch.Tensor) -> None:
        """The prompt (already in ``toks``, a view of the fixed buffer)
        through its graph; the first greedy token lands in ``self._tok``."""
        self._check_params(params)
        self._prefill_graphs[toks.shape[1]]()

    def _decode_call(self, params: Params, state: Dict[str, torch.Tensor],
                     tokens: torch.Tensor) -> None:
        """``state`` and ``tokens`` are the fixed buffers the graph reads;
        they are arguments so that the doorbell counts their bytes."""
        self._check_params(params)
        self._decode_graph()

    def _decode_block(self, want: int) -> List[torch.Tensor]:
        """One multi-token launch; keep only ``want`` tokens.

        The launch always runs ``self.T`` steps; when ``want < T`` the block
        is truncated and only the prefix is useful output, and the decode
        input continues from the last *kept* token (``block[take - 1]``,
        not ``block[-1]``).  The block is copied on the device before the
        next replay rewrites it.
        """
        self._decode_T(self.params, self.state, self._tok)
        block = self._block.clone()
        take = min(self.T, want)
        if take < self.T:
            self._tok.copy_(block[take - 1][:, None])
        return [block[t] for t in range(take)]

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
        prompt = self._prompt[:, :S]
        prompt.copy_(torch.from_numpy(toks))
        # capture on first use, before the prefill: the decode graph's
        # warm-up step writes the state that the prefill then resets
        self._decode_graph.capture()
        if S not in self._prefill_graphs:
            self._prefill_graphs[S] = CapturedStep(self._prefill_step(S),
                                                   self.device)
        self._prefill_graphs[S].capture()
        with self.session.span("serve.oneshot", batch=len(requests),
                               max_new=max_new):
            with self.session.span("serve.prefill", seq_len=S):
                self._prefill(self.params, prompt)
            out = [self._tok[:, 0].clone()]
            produced = 1
            while produced < max_new:
                with self.session.span("serve.decode_iter",
                                       produced=produced):
                    if self.T == 1:
                        self._decode(self.params, self.state, self._tok)
                        out.append(self._tok[:, 0].clone())
                        produced += 1
                    else:
                        block = self._decode_block(max_new - produced)
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
