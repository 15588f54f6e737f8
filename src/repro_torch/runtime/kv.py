"""KV-cache management for the continuous-batching engine.

The port of ``repro.runtime.kv``'s manager interface and its dense backend.
:class:`KVCacheManager` is what the engine schedules against;
:class:`DenseKV` gives every slot a full ``max_seq`` decode state and
prefills each admitted prompt whole, in one launch.

The reference keeps one stacked batch-1 decode-state pytree per slot and
``jax.vmap``\\ s a batch-1 decode over them.  On the card the slots are one
batched decode state instead (``model.init_slot_state(B, max_seq)``: every
``[L, B, ...]`` tensor with the batch on axis 1, and for the transformer a
cache length per slot, ``[B]``), decoded together with per-slot lengths:

* **prefill**: one :class:`~repro_torch.core.graphs.CapturedStep` for each
  distinct prompt length (the port's ``jax.jit`` for one shape), at batch 1
  on a staging state.  One replay runs the prefill, installs the staging
  state into the slot named by a device-side slot index
  (``model.install_slot``: all ``max_seq`` rows) and writes the greedy
  first token into that slot's next-token entry, so one graph serves every
  slot.  The reference's install is a separate jit that rings no doorbell;
  folding it into the prefill's graph keeps the counted doorbells equal to
  the reference's, and the card's submissions no more than those counted.
* **decode**: one ``CapturedStep`` for the engine's life, ``T`` greedy
  steps over all ``B`` slots, the tokens into a ``[B, T]`` block and the
  last one back into the ``[B, 1]`` next-token buffer.  Its doorbell is
  ``decode_slots`` with the reference's arguments (params, the slot states,
  the next tokens), so its payload bytes equal the reference's.

A finished or free slot goes on decoding garbage, as in the reference; its
length runs past ``max_seq`` and the decode's clamped writes stay in range.

``PagedKV`` (page pool, block tables, shared-prefix reuse) and chunked
prefill (``prefill_chunk > 0``) are not ported yet: asking for either
raises ``ValueError``.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core.graphs import CapturedStep
from ..models.layers import greedy

if TYPE_CHECKING:                                    # pragma: no cover
    from .scheduler import RequestTicket
    from .server import ContinuousBatchingServer

__all__ = ["KVCacheManager", "DenseKV", "make_kv", "KV_BACKENDS"]

KV_BACKENDS = ("dense", "paged")

NOT_PORTED = ("the paged KV backend and chunked prefill (prefill_chunk > 0) "
              "are not ported to PyTorch yet; use kv='dense' with "
              "prefill_chunk=0")


class KVCacheManager:
    """Backend interface the engine schedules against.

    Lifecycle per request: :meth:`begin` claims a slot for a ticket;
    :meth:`prefill_step` advances the slot's prefill by at most one launch
    and returns the first generated token once the prompt is fully in
    cache; :meth:`decode` runs the one launch over all slots;
    :meth:`release` returns the slot's memory.  The reference's page-pool
    hooks (``begin`` failing on page exhaustion, ``reserve_decode`` naming
    victims) come with its paged backend.
    """

    name = "none"
    chunk = 0                    # prefill_chunk knob (0 = whole-prompt)

    def begin(self, slot: int, tix: "RequestTicket") -> None:
        raise NotImplementedError

    def prefill_step(self, slot: int) -> Optional[int]:
        raise NotImplementedError

    def decode(self) -> np.ndarray:
        raise NotImplementedError

    def release(self, slot: int) -> None:
        pass

    def stats(self) -> Dict[str, Any]:
        raise NotImplementedError


class _PrefillCounters:
    """Shared launch/byte accounting (feeds loadtest --json)."""

    def __init__(self) -> None:
        self.prefill_launches = 0        # all prefill/extend launches
        self.prefill_chunk_launches = 0  # the subset that were chunk ticks
        self.prefill_tokens = 0          # prompt tokens actually pushed
        self.chunked_prompts = 0         # prompts that needed >1 launch

    @property
    def prefill_payload_bytes(self) -> int:
        return 4 * self.prefill_tokens

    def to_dict(self) -> Dict[str, int]:
        return {
            "prefill_launches": self.prefill_launches,
            "prefill_chunk_launches": self.prefill_chunk_launches,
            "prefill_tokens": self.prefill_tokens,
            "prefill_payload_bytes": self.prefill_payload_bytes,
            "chunked_prompts": self.chunked_prompts,
        }


class DenseKV(KVCacheManager):
    """Every slot a full ``max_seq`` decode state; whole-prompt prefill.

    The buffers every graph reads are allocated once: the slot states, a
    batch-1 staging state and prompt ``[1, max_seq]``, the slot index
    ``[1]``, the next tokens ``[B, 1]`` and the decode block ``[B, T]``.
    The decode graph is captured here, before any slot holds a request: its
    eager warm-up runs ``T`` steps over every slot.
    """

    name = "dense"

    def __init__(self, engine: "ContinuousBatchingServer",
                 prefill_chunk: int = 0) -> None:
        if prefill_chunk:
            raise ValueError(f"prefill_chunk={prefill_chunk}: {NOT_PORTED}")
        self.engine = engine
        model, dev = engine.model, engine.device
        B, S = engine.B, engine.max_seq
        self.slots = model.init_slot_state(B, S)
        self._staging = model.init_decode_state(1, S)
        self._prompt = torch.zeros(1, S, dtype=torch.int32, device=dev)
        self._slot = torch.zeros(1, dtype=torch.int64, device=dev)
        self._nxt = torch.zeros(B, 1, dtype=torch.int32, device=dev)
        self._block = torch.zeros(B, engine.T, dtype=torch.int32, device=dev)
        self._prefill_graphs: Dict[int, CapturedStep] = {}
        self._decode_graph = CapturedStep(self._decode_steps, dev)
        self._decode_graph.capture()
        # the doorbells: the reference's names and arguments, so dispatch
        # names and payload bytes equal its own
        self._prefill = engine.tracker.wrap(self._prefill_call, "prefill")
        self._decode_slots = engine.tracker.wrap(self._decode_call,
                                                 "decode_slots")
        self._pending: Dict[int, "RequestTicket"] = {}
        self.counters = _PrefillCounters()

    def graphs(self) -> Dict[str, CapturedStep]:
        """The backend's steps by name (``"prefill S=<n>"``, ``"decode
        T=<T>"``): one CUDA graph each once captured on the card."""
        out = {f"prefill S={S}": g for S, g in self._prefill_graphs.items()}
        out[f"decode T={self.engine.T}"] = self._decode_graph
        return out

    # -- the graphs' steps -------------------------------------------------
    def _prefill_step(self, S: int) -> Callable[[], None]:
        eng = self.engine

        def step() -> None:
            _, logits = eng.model.prefill(eng.params, self._prompt[:, :S],
                                          eng.max_seq, state=self._staging)
            eng.model.install_slot(self.slots, self._staging, self._slot)
            self._nxt.index_copy_(0, self._slot, greedy(logits))
        return step

    def _decode_steps(self) -> None:
        """T greedy steps over every slot, each at its own length."""
        eng = self.engine
        tokens = self._nxt
        for t in range(eng.T):
            _, logits = eng.model.decode_step(eng.params, self.slots, tokens)
            tokens = greedy(logits)
            self._block[:, t].copy_(tokens[:, 0])
        self._nxt.copy_(tokens)

    def _check_params(self, params: Any) -> None:
        if params is not self.engine.params:
            raise ValueError("this engine's graphs are bound to its own "
                             "params; serve another param tree from another "
                             "engine")

    def _prefill_call(self, params: Any, toks: torch.Tensor) -> None:
        """The prompt (already in ``toks``, a view of the fixed buffer)
        through its graph, into the slot named by ``self._slot``."""
        self._check_params(params)
        self._prefill_graphs[toks.shape[1]]()

    def _decode_call(self, params: Any, slots: Dict[str, torch.Tensor],
                     nxt: torch.Tensor) -> None:
        """``slots`` and ``nxt`` are the fixed buffers the graph reads; they
        are arguments so that the doorbell counts their bytes."""
        self._check_params(params)
        self._decode_graph()

    # -- prefill -----------------------------------------------------------
    def begin(self, slot: int, tix: "RequestTicket") -> None:
        self._pending[slot] = tix

    def prefill_step(self, slot: int) -> Optional[int]:
        tix = self._pending.pop(slot)
        eng = self.engine
        prompt = np.asarray(tix.request.prompt, np.int32)
        S = len(prompt)
        self._prompt[0, :S].copy_(torch.from_numpy(prompt))
        self._slot.fill_(slot)
        if S not in self._prefill_graphs:
            self._prefill_graphs[S] = CapturedStep(self._prefill_step(S),
                                                   eng.device)
        self._prefill_graphs[S].capture()
        with eng.session.span("serve.prefill", uid=tix.uid, prompt_len=S):
            self._prefill(eng.params, self._prompt[:, :S])
        self.counters.prefill_launches += 1
        self.counters.prefill_tokens += S
        tix.n_prefill_launches += 1
        return int(self._nxt[slot, 0])               # host sync

    # -- decode ------------------------------------------------------------
    def decode(self) -> np.ndarray:
        self._decode_slots(self.engine.params, self.slots, self._nxt)
        return self._block.cpu().numpy()             # [B, T] host sync

    def release(self, slot: int) -> None:
        self._pending.pop(slot, None)

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"backend": self.name,
                               "prefill_chunk": self.chunk}
        out.update(self.counters.to_dict())
        return out


def make_kv(engine: "ContinuousBatchingServer", kind: str = "dense",
            page_tokens: int = 16, pages: Optional[int] = None,
            prefill_chunk: int = 0) -> KVCacheManager:
    if kind == "dense":
        return DenseKV(engine, prefill_chunk=prefill_chunk)
    if kind == "paged":
        raise ValueError(f"kv='paged': {NOT_PORTED}")
    raise ValueError(f"unknown kv backend {kind!r}; "
                     f"expected one of {KV_BACKENDS}")
