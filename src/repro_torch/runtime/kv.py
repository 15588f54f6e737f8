"""KV-cache management for the continuous-batching engine.

The port of ``repro.runtime.kv``.  :class:`KVCacheManager` is what the engine
schedules against, with two backends:

* :class:`DenseKV`: every slot a full ``max_seq`` decode state, one decode
  launch over all slots;
* :class:`PagedKV`: one page pool ``[L, 1 + pages, page_tokens, Hkv, hd]``
  with a block table per slot.  A decode launch gathers each slot's pages
  into the layout the dense backend decodes, runs the *same* decode, and
  scatters the new rows back, so paged tokens are dense tokens.  Pages
  holding a fully prefilled prompt prefix are content-addressed (a hash
  chain over page tokens) and shared by later requests with the same
  prefix: a prefix hit skips those prefill tokens.  Pool exhaustion evicts
  with ``reason="kv_pages"``.

Both backends support **chunked prefill**: a prompt longer than
``prefill_chunk`` is advanced one bounded ``prefill_extend`` launch at a
time (``serve.prefill_chunk`` spans), which the engine interleaves with
decode launches so that a long prompt no longer stalls the active slots.

Page 0 of the pool is a scratch page: free and still-prefilling slots point
every block-table row at it with length 0, so the decode launch stays total
and shape-stable, as the dense backend's free slots go on decoding garbage.

The reference keeps one stacked batch-1 decode state per slot and
``jax.vmap``\\ s a batch-1 decode over them.  On the card the slots are one
batched decode state (``model.init_slot_state(B, max_seq)``: every
``[L, B, ...]`` tensor with the batch on axis 1 and a cache length per slot,
``[B]``), decoded together.  Every launch is one
:class:`~repro_torch.core.graphs.CapturedStep` replay (the port's ``jax.jit``
for one shape) on buffers allocated once; what varies between replays
(tokens, the slot, the chunk's start, block tables, lengths) is copied into
fixed device buffers before the replay, so one graph serves every slot:

* **prefill** (dense, whole prompt): one graph a prompt length, at batch 1
  on a staging state; the replay also installs the staging state into the
  slot (``model.install_slot``) and writes the greedy first token into the
  slot's next-token entry.  The reference's install is a separate jit that
  rings no doorbell; folding it in keeps the card's submissions equal to the
  counted doorbells.
* **extend** (a prompt chunk of ``C`` tokens at a device-side ``start``):
  one graph a chunk length.  Dense: the slot's partial prefill lives in its
  own rows of a ``[L, B, max_seq, ...]`` staging buffer (never in the
  slot's decode state, whose rows the interleaved decode launches
  overwrite); the replay gathers them into the batch-1 staging state, runs
  ``prefill_extend``, writes them back, installs the state into the slot
  and writes the greedy token.  Paged: the replay gathers the slot's pages
  into the batch-1 staging state, runs ``prefill_extend``, scatters rows
  ``[start, start + C)`` into the slot's pages and writes the greedy token.
  Only a prompt's final chunk reads its token back to the host.
* **decode**: one graph for the engine's life, captured when the backend is
  built (its eager warm-up then touches no request's memory: the paged
  tables point at scratch page 0).  ``T`` greedy steps over all ``B`` slots
  (:func:`_decode_steps`); the paged graph first gathers every slot's pages
  and afterwards scatters each slot's rows ``[min(len, S - T), +T)`` back.

Doorbells keep the reference's names and arguments (``prefill``,
``prefill_extend``, ``decode_slots``), so their payload bytes equal the
reference's.

Every one of these graphs is timed on the device from inside: its step
records a timing event as its first and its last operation
(:class:`_Stamped`), and each launch leaves a
:class:`~repro_torch.runtime.scheduler.LaunchRecord` on the tickets it
served.  The stamps are read at the next host sync the engine makes anyway
(the first token's read, the decode's harvest), onto the session's clock
(``TraceSession.anchor``/``device_time``, re-anchored at each such sync),
and each launch read is one ``graph_launch`` event.
"""
from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from typing import (TYPE_CHECKING, Any, Callable, Dict, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from ..configs.shapes import kv_geometry
from ..core.graphs import CapturedStep
from ..models.attention import gather_block_table, scatter_block_rows
from ..models.layers import dtype_of, greedy
from .scheduler import LaunchRecord

if TYPE_CHECKING:                                    # pragma: no cover
    from .scheduler import RequestTicket
    from .server import ContinuousBatchingServer

__all__ = ["KVCacheManager", "DenseKV", "PagedKV", "make_kv", "KV_BACKENDS"]

KV_BACKENDS = ("dense", "paged")


def _decode_steps(engine: "ContinuousBatchingServer",
                  state: Dict[str, torch.Tensor], nxt: torch.Tensor,
                  block: torch.Tensor) -> None:
    """The shared decode body: ``T`` greedy steps over every slot of
    ``state``, each at its own length; the tokens into ``block`` [B, T] and
    the last one back into ``nxt`` [B, 1].  Both backends capture this one
    function, which is what makes their token streams equal: the only
    difference is where the cache lives before and after."""
    tokens = nxt
    for t in range(engine.T):
        _, logits = engine.model.decode_step(engine.params, state, tokens)
        tokens = greedy(logits)
        block[:, t].copy_(tokens[:, 0])
    nxt.copy_(tokens)


class _Stamped:
    """``fn`` between two stamps, its first and its last operation.

    On the card each stamp is a CUDA timing event recorded as an ``external``
    event, which the capture turns into an event-record node: a replay's
    stamps are the device times at which the graph's first node started
    and its last node ended.  On the CPU, where the step runs
    synchronously, they are ``perf_counter`` readings at its head and
    tail."""

    def __init__(self, fn: Callable[[], None], device: torch.device) -> None:
        self.fn = fn
        self.cuda = device.type == "cuda"
        self.head: Any = -1.0
        self.tail: Any = -1.0
        if self.cuda:
            self.head = torch.cuda.Event(enable_timing=True, external=True)
            self.tail = torch.cuda.Event(enable_timing=True, external=True)

    def __call__(self) -> None:
        if self.cuda:
            self.head.record()
            self.fn()
            self.tail.record()
        else:
            self.head = time.perf_counter()
            self.fn()
            self.tail = time.perf_counter()


class KVCacheManager:
    """Backend interface the engine schedules against.

    Lifecycle per request: :meth:`begin` claims resources for a slot
    (returns False only on unrecoverable page exhaustion: the engine then
    evicts with ``reason="kv_pages"``); :meth:`prefill_step` advances the
    slot's prefill by at most one launch and returns the first generated
    token once the prompt is fully in cache; :meth:`reserve_decode` grows
    per-slot capacity ahead of a decode launch (returning victims when the
    pool cannot); :meth:`decode` runs the one launch over all slots, and
    :meth:`decoded` gives its launch record with the requests that rode it;
    :meth:`release` returns the slot's memory.
    """

    name = "none"
    chunk = 0                    # prefill_chunk knob (0 = whole-prompt)

    def begin(self, slot: int, tix: "RequestTicket") -> bool:
        raise NotImplementedError

    def prefill_step(self, slot: int) -> Optional[int]:
        raise NotImplementedError

    def reserve_decode(self, slots: List[int]) -> List[int]:
        return []

    def decode(self) -> np.ndarray:
        raise NotImplementedError

    def decoded(self, riders: Sequence["RequestTicket"]) -> LaunchRecord:
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


def _require_extend(model: Any, why: str) -> None:
    if not hasattr(model, "prefill_extend"):
        raise ValueError(
            f"{why} requires a model with a prefill_extend() decode-state "
            f"extension (transformer-family); {type(model).__name__} has "
            f"none — use kv='dense' with prefill_chunk=0")


class _Graphed(KVCacheManager):
    """The fixed buffers and graphs both backends share: the prompt or
    chunk tokens ``[1, max_seq]``, the slot index ``[1]``, the chunk's start
    ``[]``, the next tokens ``[B, 1]``, the decode block ``[B, T]``, and a
    batch-1 staging state for prefills and chunks."""

    def __init__(self, engine: "ContinuousBatchingServer",
                 prefill_chunk: int) -> None:
        self.engine = engine
        self.chunk = max(0, int(prefill_chunk))
        dev, B, S = engine.device, engine.B, engine.max_seq
        self._tokens = torch.zeros(1, S, dtype=torch.int32, device=dev)
        self._slot = torch.zeros(1, dtype=torch.int64, device=dev)
        self._start = torch.zeros((), dtype=torch.int32, device=dev)
        self._nxt = torch.zeros(B, 1, dtype=torch.int32, device=dev)
        self._block = torch.zeros(B, engine.T, dtype=torch.int32, device=dev)
        self._staging = engine.model.init_decode_state(1, S)
        self._prefill_graphs: Dict[int, CapturedStep] = {}
        self._extend_graphs: Dict[int, CapturedStep] = {}
        self._decode_graph: Optional[CapturedStep] = None
        self._pending: Dict[int, Dict[str, Any]] = {}
        self.counters = _PrefillCounters()
        # each graph's stamps by name, and the launches not yet read
        self._stamps: Dict[str, _Stamped] = {}
        self._unread: List[Tuple[LaunchRecord, _Stamped]] = []
        self._decode_rec: Optional[LaunchRecord] = None     # the last one
        # the doorbells: the reference's names, and the reference's
        # arguments at each call, so dispatch names and payload bytes equal
        # its own
        self._prefill = engine.tracker.wrap(self._prefill_call, "prefill")
        self._extend = engine.tracker.wrap(self._extend_call,
                                           "prefill_extend")
        self._decode_slots = engine.tracker.wrap(self._decode_call,
                                                 "decode_slots")

    def graphs(self) -> Dict[str, CapturedStep]:
        """The backend's steps by name (``"prefill S=<n>"``, ``"extend
        C=<n>"``, ``"decode T=<T>"``): one CUDA graph each once captured on
        the card."""
        out = {f"prefill S={S}": g for S, g in self._prefill_graphs.items()}
        out.update((f"extend C={C}", g)
                   for C, g in self._extend_graphs.items())
        out[f"decode T={self.engine.T}"] = self._decode_graph
        return out

    def _captured(self, name: str, fn: Callable[[], None]) -> CapturedStep:
        stamped = _Stamped(fn, self.engine.device)
        step = CapturedStep(stamped, self.engine.device)
        step.capture()                 # ends in a host synchronize
        self._stamps[name] = stamped
        self._read_stamps()
        return step

    def _replay(self, name: str, step: CapturedStep) -> LaunchRecord:
        """Replay graph ``name`` between two host readings; its record stays
        unread until the next host sync.  A graph's stamps are read before
        it replays again: only chunked prefill with nothing decoding comes
        here with them unread, and the read then waits for the earlier
        replay, which the stream runs first anyway."""
        stamped = self._stamps[name]
        if any(s is stamped for _, s in self._unread):
            self._read_stamps(upto=stamped)
        t0 = time.perf_counter()
        step()
        rec = LaunchRecord(name, t0, time.perf_counter())
        self._unread.append((rec, stamped))
        return rec

    def _read_stamps(self, upto: Optional[_Stamped] = None) -> None:
        """The unread launches' device start and end on the session's
        clock, one ``graph_launch`` event each (``t`` the host's enqueue).
        Called right after a host sync, when every launch has ended, and
        the clock is re-anchored there; with ``upto``, from that graph's
        next replay: after waiting for its earlier replay, the launches up
        to it are read, and the clock keeps its anchor."""
        sess = self.engine.session
        n = len(self._unread)
        if upto is not None:
            n = 1 + next(i for i, (_, s) in enumerate(self._unread)
                         if s is upto)
            if upto.cuda:
                upto.tail.synchronize()
        for rec, stamped in self._unread[:n]:
            rec.t_start = sess.device_time(stamped.head)
            rec.t_end = sess.device_time(stamped.tail)
            sess.emit("graph_launch", rec.graph, t=rec.t_enqueue,
                      dur_s=rec.t_return - rec.t_enqueue,
                      device_start=rec.t_start - sess.t0,
                      device_s=rec.device_s)
        del self._unread[:n]
        if upto is None:
            sess.anchor(self.engine.device)

    def _prefilled(self, tix: "RequestTicket", rec: LaunchRecord, c: int,
                   chunk: bool) -> None:
        """A prefill or extend launch of ``c`` prompt tokens for ``tix``."""
        rec.uid, rec.tokens = tix.uid, c
        tix.launches.append(rec)
        tix.n_prefill_launches += 1
        self.counters.prefill_launches += 1
        self.counters.prefill_chunk_launches += int(chunk)
        self.counters.prefill_tokens += c

    def decoded(self, riders: Sequence["RequestTicket"]) -> LaunchRecord:
        """The last decode launch's record (read at its host sync), with
        its riders and each one's cache length before it: the prompt and
        every token but the last, which it fed.  Call before the harvest
        adds the launch's tokens."""
        rec = self._decode_rec
        rec.uids = tuple(t.uid for t in riders)
        rec.lengths = tuple(len(t.request.prompt) + len(t.tokens) - 1
                            for t in riders)
        return rec

    def _load(self, slot: int, prompt: np.ndarray, pos: int, c: int) -> None:
        """Tokens ``prompt[pos:pos+c]``, the slot and the start into the
        fixed buffers the next replay reads."""
        self._tokens[0, :c].copy_(torch.from_numpy(prompt[pos:pos + c]))
        self._slot.fill_(slot)
        self._start.fill_(pos)

    def _check_params(self, params: Any) -> None:
        if params is not self.engine.params:
            raise ValueError("this engine's graphs are bound to its own "
                             "params; serve another param tree from another "
                             "engine")

    # the doorbells' bodies: the arguments are the fixed buffers the graphs
    # read (the last one the tokens), passed so that the doorbell counts
    # their bytes
    def _prefill_call(self, params: Any, tokens: torch.Tensor
                      ) -> LaunchRecord:
        self._check_params(params)
        S = tokens.shape[1]
        return self._replay(f"prefill S={S}", self._prefill_graphs[S])

    def _extend_call(self, params: Any, *buffers: Any) -> LaunchRecord:
        self._check_params(params)
        C = buffers[-1].shape[1]
        return self._replay(f"extend C={C}", self._extend_graphs[C])

    def _decode_call(self, params: Any, *buffers: Any) -> LaunchRecord:
        self._check_params(params)
        return self._replay(f"decode T={self.engine.T}", self._decode_graph)

    def _first_token(self, slot: int) -> int:
        del self._pending[slot]
        tok = int(self._nxt[slot, 0])                # host sync
        self._read_stamps()
        return tok


class DenseKV(_Graphed):
    """Every slot a full ``max_seq`` decode state.

    A prompt no longer than ``prefill_chunk`` (or any prompt, without
    chunking) is prefilled whole, in one launch that runs the flash kernel.
    A longer one is staged chunk by chunk in the slot's rows of a private
    ``[L, B, max_seq, ...]`` buffer and installed into its slot, with its
    first token, by every chunk's replay: the last chunk's install is the
    one the slot decodes from.
    """

    name = "dense"

    def __init__(self, engine: "ContinuousBatchingServer",
                 prefill_chunk: int = 0) -> None:
        super().__init__(engine, prefill_chunk)
        model = engine.model
        if self.chunk:
            _require_extend(model, "chunked prefill")
        B, S = engine.B, engine.max_seq
        self.slots = model.init_slot_state(B, S)
        self._chunks = model.init_slot_state(B, S) if self.chunk else None
        self._decode_graph = self._captured(
            f"decode T={engine.T}",
            lambda: _decode_steps(engine, self.slots, self._nxt,
                                  self._block))

    # -- the graphs' steps -------------------------------------------------
    def _prefill_step(self, S: int) -> Callable[[], None]:
        eng = self.engine

        def step() -> None:
            _, logits = eng.model.prefill(eng.params, self._tokens[:, :S],
                                          eng.max_seq, state=self._staging)
            eng.model.install_slot(self.slots, self._staging, self._slot)
            self._nxt.index_copy_(0, self._slot, greedy(logits))
        return step

    def _extend_step(self, C: int) -> Callable[[], None]:
        eng, work, chunks = self.engine, self._staging, self._chunks

        def step() -> None:
            for key in ("k", "v"):
                torch.index_select(chunks[key], 1, self._slot, out=work[key])
            work["length"].copy_(self._start)
            _, logits = eng.model.prefill_extend(eng.params, work,
                                                 self._tokens[:, :C])
            for key in ("k", "v"):
                chunks[key].index_copy_(1, self._slot, work[key])
            eng.model.install_slot(self.slots, work, self._slot)
            self._nxt.index_copy_(0, self._slot, greedy(logits))
        return step

    # -- prefill -----------------------------------------------------------
    def begin(self, slot: int, tix: "RequestTicket") -> bool:
        prompt = np.asarray(tix.request.prompt, np.int32)
        chunked = bool(self.chunk) and len(prompt) > self.chunk
        self._pending[slot] = {"tix": tix, "prompt": prompt, "pos": 0,
                               "chunked": chunked}
        if chunked:
            self.counters.chunked_prompts += 1
        return True

    def prefill_step(self, slot: int) -> Optional[int]:
        p = self._pending[slot]
        tix, prompt = p["tix"], p["prompt"]
        eng = self.engine
        if not p["chunked"]:
            S = len(prompt)
            # the step writes nothing but this slot, the staging state and
            # this slot's token, and the same again in the replay: it is
            # safe to capture on the request's own inputs
            self._load(slot, prompt, 0, S)
            if S not in self._prefill_graphs:
                self._prefill_graphs[S] = self._captured(
                    f"prefill S={S}", self._prefill_step(S))
            with eng.session.span("serve.prefill", uid=tix.uid,
                                  prompt_len=S):
                rec = self._prefill(eng.params, self._tokens[:, :S])
            self._prefilled(tix, rec, S, chunk=False)
            return self._first_token(slot)
        pos = p["pos"]
        c = min(self.chunk, len(prompt) - pos)
        self._load(slot, prompt, pos, c)
        if c not in self._extend_graphs:          # idempotent, as above
            self._extend_graphs[c] = self._captured(f"extend C={c}",
                                                    self._extend_step(c))
        with eng.session.span("serve.prefill_chunk", uid=tix.uid, start=pos,
                              size=c, prompt_len=int(len(prompt))):
            rec = self._extend(eng.params, self._staging,
                               self._tokens[:, :c])
        p["pos"] = pos + c
        self._prefilled(tix, rec, c, chunk=True)
        if p["pos"] < len(prompt):
            return None
        return self._first_token(slot)

    # -- decode ------------------------------------------------------------
    def decode(self) -> np.ndarray:
        self._decode_rec = self._decode_slots(self.engine.params, self.slots,
                                              self._nxt)
        blocks = self._block.cpu().numpy()           # [B, T] host sync
        self._read_stamps()
        return blocks

    def release(self, slot: int) -> None:
        self._pending.pop(slot, None)

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"backend": self.name,
                               "prefill_chunk": self.chunk}
        out.update(self.counters.to_dict())
        return out


def _hash_page(parent: bytes, tokens: np.ndarray) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(parent)
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    return h.digest()


class PagedKV(_Graphed):
    """Fixed-size pages + block tables + shared-prefix page reuse.

    Geometry: pool ``[L, 1 + pages, page_tokens, Hkv, hd]`` in the model's
    type (page 0 is scratch), block tables ``[B, max_seq // page_tokens]``
    and lengths host-side (numpy).  Pages whose span lies entirely inside
    the *prompt* (decode never writes them: the first decode write lands at
    position ``prompt_len``) are registered under a content hash chain once
    prefilled, and later requests sharing that prefix attach to them
    instead of prefilling again, always leaving at least the final prompt
    token to prefill so that the first output token's logits exist.

    Allocation: free list first, then the least recently freed cached
    (refcount 0 but registered) page.  When both are empty the requester
    loses: ``begin`` returns False / ``reserve_decode`` names the slot as a
    victim, and the engine evicts it with ``reason="kv_pages"``.

    On the card the tables and lengths are copied into the graphs' fixed
    buffers before each replay (still-prefilling and free slots masked to
    scratch page 0 at length 0); the extend graphs gather into the batch-1
    staging state, the decode graph into a ``[L, B, max_seq, ...]`` state.
    """

    name = "paged"

    def __init__(self, engine: "ContinuousBatchingServer",
                 page_tokens: int = 16, pages: Optional[int] = None,
                 prefill_chunk: int = 0) -> None:
        _require_extend(engine.model, "kv='paged'")
        self.pt = int(page_tokens)
        self.n_blk, default_pages = kv_geometry(
            engine.max_seq, self.pt, engine.B)
        self.pages = int(pages) if pages is not None else default_pages
        if self.pages < self.n_blk:
            raise ValueError(
                f"kv_pages={self.pages} cannot hold even one full slot "
                f"({self.n_blk} pages of {self.pt} tokens)")
        super().__init__(engine, prefill_chunk)
        cfg, dev = engine.cfg, engine.device
        P = 1 + self.pages                            # + scratch page 0
        shape = (cfg.n_layers, P, self.pt, cfg.n_kv_heads, cfg.hd)
        self.k_pool = torch.zeros(shape, dtype=dtype_of(cfg), device=dev)
        self.v_pool = torch.zeros(shape, dtype=dtype_of(cfg), device=dev)
        self.page_bytes = int(2 * np.prod(shape[2:]) * cfg.n_layers
                              * self.k_pool.element_size())

        B = engine.B
        self.tables = np.zeros((B, self.n_blk), np.int32)   # 0 = scratch
        self.n_rows = np.zeros(B, np.int32)           # valid table rows
        self.lengths = np.zeros(B, np.int32)          # 0 until installed
        self.ready = np.zeros(B, bool)                # prefill complete

        self._free: List[int] = list(range(P - 1, 0, -1))   # pop() -> 1,2,..
        self._ref = np.zeros(P, np.int64)
        self._key_of: Dict[int, bytes] = {}           # page -> content key
        self._page_of: Dict[bytes, int] = {}          # content key -> page
        self._cached: "OrderedDict[int, None]" = OrderedDict()  # ref==0 LRU
        self._chain: Dict[int, List[bytes]] = {}      # slot -> page keys

        self.pages_allocated = 0                      # cumulative fresh
        self.pages_reused = 0                         # prefix-hit attaches
        self.prefix_hits = 0                          # requests that hit
        self.prefix_hit_tokens = 0
        self.pages_peak = 0

        # the graphs' device-side table buffers: the extend's slot [n_blk],
        # the decode's masked tables [B, n_blk] and lengths [B], all zero
        # (scratch page 0, length 0) while the decode graph is captured
        self._table = torch.zeros(self.n_blk, dtype=torch.int32, device=dev)
        self._tables = torch.zeros(B, self.n_blk, dtype=torch.int32,
                                   device=dev)
        self._lengths = torch.zeros(B, dtype=torch.int32, device=dev)
        self._dec = engine.model.init_slot_state(B, engine.max_seq)
        self._decode_graph = self._captured(f"decode T={engine.T}",
                                            self._decode_step)

    # -- the graphs' steps -------------------------------------------------
    def _decode_step(self) -> None:
        """Gather every slot's pages, decode ``T`` steps as the dense
        backend does, scatter each slot's rows ``[min(len, S - T), +T)``
        back: the rows this launch wrote, clamped as the dense cache's
        write clamps when a finishing slot overruns."""
        eng, dec = self.engine, self._dec
        S, T = eng.max_seq, eng.T
        for key, pool in (("k", self.k_pool), ("v", self.v_pool)):
            gather_block_table(pool, self._tables, out=dec[key])
        dec["length"].copy_(self._lengths)
        start = self._lengths.clamp(max=S - T)
        _decode_steps(eng, dec, self._nxt, self._block)
        rows = start.long()[:, None] + torch.arange(T, device=start.device)
        slot = torch.arange(eng.B, device=start.device)[:, None]
        for key, pool in (("k", self.k_pool), ("v", self.v_pool)):
            scatter_block_rows(pool, self._tables, dec[key][:, slot, rows],
                               start)

    def _extend_step(self, C: int) -> Callable[[], None]:
        eng, work = self.engine, self._staging
        S = eng.max_seq

        def step() -> None:
            for key, pool in (("k", self.k_pool), ("v", self.v_pool)):
                gather_block_table(pool, self._table, out=work[key])
            work["length"].copy_(self._start)
            _, logits = eng.model.prefill_extend(eng.params, work,
                                                 self._tokens[:, :C])
            rows = (self._start.long().clamp(0, S - C)
                    + torch.arange(C, device=self._start.device))
            for key, pool in (("k", self.k_pool), ("v", self.v_pool)):
                scatter_block_rows(pool, self._table, work[key][:, 0, rows],
                                   self._start)
            self._nxt.index_copy_(0, self._slot, greedy(logits))
        return step

    # -- page accounting ---------------------------------------------------
    @property
    def pages_in_use(self) -> int:
        return self.pages - len(self._free) - len(self._cached)

    def _take_pages(self, n: int) -> Optional[List[int]]:
        """n fresh pages, reclaiming cached prefix pages if needed."""
        got: List[int] = []
        while len(got) < n:
            if self._free:
                got.append(self._free.pop())
            elif self._cached:
                page, _ = self._cached.popitem(last=False)   # oldest
                key = self._key_of.pop(page)
                self._page_of.pop(key, None)
                got.append(page)
            else:
                self._free.extend(got)                       # rollback
                return None
        self.pages_allocated += len(got)
        self.pages_peak = max(self.pages_peak, self.pages_in_use)
        return got

    def _drop_ref(self, page: int) -> None:
        self._ref[page] -= 1
        if self._ref[page] == 0:
            if page in self._key_of:
                self._cached[page] = None            # reusable, reclaimable
            else:
                self._free.append(page)

    def _register(self, page: int, key: bytes) -> None:
        if key not in self._page_of and page not in self._key_of:
            self._page_of[key] = page
            self._key_of[page] = key

    # -- prefill -----------------------------------------------------------
    def begin(self, slot: int, tix: "RequestTicket") -> bool:
        prompt = np.asarray(tix.request.prompt, np.int32)
        plen = len(prompt)
        chain: List[bytes] = []
        key = b"kv-root"
        for p in range(plen // self.pt):             # fully-covered pages
            key = _hash_page(key, prompt[p * self.pt:(p + 1) * self.pt])
            chain.append(key)
        # shareable prefix: page span must end before the last prompt token
        # so at least one token remains to prefill (tok0 needs logits)
        n_share_max = (plen - 1) // self.pt
        shared: List[int] = []
        for p in range(min(n_share_max, len(chain))):
            pg = self._page_of.get(chain[p])
            if pg is None:
                break
            # pin BEFORE allocating: a refcount-0 shared page sits in
            # self._cached, which _take_pages reclaims under pool pressure;
            # left unpinned, the same physical page could be handed back
            # as a fresh prefill target and the prefill would clobber the
            # shared prefix content
            if self._ref[pg] == 0:
                self._cached.pop(pg, None)
            self._ref[pg] += 1
            shared.append(pg)
        n_total = -(-plen // self.pt)                # pages covering prompt
        got = self._take_pages(n_total - len(shared))
        if got is None:
            for pg in shared:                        # unpin: roll back
                self._drop_ref(pg)
            return False
        for pg in got:
            self._ref[pg] += 1
        self.tables[slot, :n_total] = shared + got
        self.tables[slot, n_total:] = 0
        self.n_rows[slot] = n_total
        self.lengths[slot] = 0
        self.ready[slot] = False
        self._chain[slot] = chain
        start = len(shared) * self.pt
        chunked = bool(self.chunk) and (plen - start) > self.chunk
        self._pending[slot] = {"tix": tix, "prompt": prompt, "pos": start,
                               "chunked": chunked}
        if chunked:
            self.counters.chunked_prompts += 1
        if shared:
            self.prefix_hits += 1
            self.pages_reused += len(shared)
            self.prefix_hit_tokens += start
            self.engine.session.emit(
                "progress", "kv.prefix_hit", uid=tix.uid, slot=slot,
                pages=len(shared), tokens=start,
                payload_bytes=len(shared) * self.page_bytes)
        if got:
            self.engine.session.emit(
                "progress", "kv.alloc", uid=tix.uid, slot=slot,
                pages=len(got), payload_bytes=len(got) * self.page_bytes)
        return True

    def prefill_step(self, slot: int) -> Optional[int]:
        p = self._pending[slot]
        tix, prompt, pos = p["tix"], p["prompt"], p["pos"]
        eng = self.engine
        plen = len(prompt)
        remaining = plen - pos
        c = min(self.chunk, remaining) if p["chunked"] else remaining
        span_name = "serve.prefill_chunk" if p["chunked"] else "serve.prefill"
        if c not in self._extend_graphs:
            # capture against scratch page 0 at start 0: the eager warm-up
            # then writes no page that a request owns or shares
            self._table.zero_()
            self._start.zero_()
            self._slot.fill_(slot)
            self._extend_graphs[c] = self._captured(f"extend C={c}",
                                                    self._extend_step(c))
        self._load(slot, prompt, pos, c)
        self._table.copy_(torch.from_numpy(self.tables[slot]))
        with eng.session.span(span_name, uid=tix.uid, start=pos, size=c,
                              prompt_len=plen):
            rec = self._extend(eng.params, self.k_pool, self.v_pool,
                               self._table, self._start, self._tokens[:, :c])
        p["pos"] = pos + c
        self._prefilled(tix, rec, c, chunk=p["chunked"])
        if p["pos"] < plen:
            return None
        # prompt fully in cache: register shareable pages, go decodable.
        # Pages overlapping [max_seq - T, max_seq) are excluded: a slot
        # finishing at the KV cap scatter-writes its clamped decode rows
        # there (scatter start = min(length, S - T)), and a registered page
        # must stay immutable once other requests attach to it; reachable
        # when page_tokens < tokens_per_launch.
        chain = self._chain[slot]
        n_reg = min(plen // self.pt, (eng.max_seq - eng.T) // self.pt)
        for i in range(n_reg):
            self._register(int(self.tables[slot, i]), chain[i])
        self.lengths[slot] = plen
        self.ready[slot] = True
        return self._first_token(slot)

    # -- decode ------------------------------------------------------------
    def reserve_decode(self, slots: List[int]) -> List[int]:
        """Grow block tables to cover the next T decode writes.

        Returns slots the pool cannot serve (after reclaiming every cached
        page): the engine evicts those with ``reason="kv_pages"`` and calls
        again, so freed pages immediately serve the survivors.  At most ONE
        victim is returned per call: several slots crossing a page boundary
        in the same iteration must not all be evicted when freeing a single
        one would let the rest grow.
        """
        victims: List[int] = []
        for slot in slots:
            ln = int(self.lengths[slot])
            last = min(ln + self.engine.T, self.engine.max_seq) - 1
            need = last // self.pt + 1 - int(self.n_rows[slot])
            if need <= 0:
                continue
            got = self._take_pages(need)
            if got is None:
                victims.append(slot)
                return victims
            r0 = int(self.n_rows[slot])
            self.tables[slot, r0:r0 + need] = got
            self.n_rows[slot] = r0 + need
            for pg in got:
                self._ref[pg] += 1
            self.engine.session.emit(
                "progress", "kv.alloc", uid=self._uid(slot), slot=slot,
                pages=need, payload_bytes=need * self.page_bytes)
        return victims

    def _uid(self, slot: int) -> int:
        tix = self.engine._slot_tix[slot]
        return tix.uid if tix is not None else -1

    def decode(self) -> np.ndarray:
        # still-prefilling slots decode as empty scratch slots: their block
        # tables and lengths are masked so the launch never touches their
        # half-written pages
        tables = np.where(self.ready[:, None], self.tables, 0)
        lengths = np.where(self.ready, self.lengths, 0)
        self._tables.copy_(torch.from_numpy(tables.astype(np.int32)))
        self._lengths.copy_(torch.from_numpy(lengths.astype(np.int32)))
        self._decode_rec = self._decode_slots(
            self.engine.params, self.k_pool, self.v_pool, self._tables,
            self._lengths, self._nxt)
        blocks = self._block.cpu().numpy()           # [B, T] host sync
        self._read_stamps()
        self.lengths[self.ready] += self.engine.T
        return blocks

    def release(self, slot: int) -> None:
        n = int(self.n_rows[slot])
        freed = 0
        for i in range(n):
            self._drop_ref(int(self.tables[slot, i]))
            freed += 1
        if freed:
            self.engine.session.emit(
                "progress", "kv.free", uid=self._uid(slot), slot=slot,
                pages=freed, payload_bytes=freed * self.page_bytes)
        self.tables[slot, :] = 0
        self.n_rows[slot] = 0
        self.lengths[slot] = 0
        self.ready[slot] = False
        self._chain.pop(slot, None)
        self._pending.pop(slot, None)

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "backend": self.name,
            "prefill_chunk": self.chunk,
            "page_tokens": self.pt,
            "pages_total": self.pages,
            "pages_in_use": self.pages_in_use,
            "pages_peak": self.pages_peak,
            "pages_allocated": self.pages_allocated,
            "pages_reused": self.pages_reused,
            "pages_cached": len(self._cached),
            "prefix_hits": self.prefix_hits,
            "prefix_hit_tokens": self.prefix_hit_tokens,
        }
        out.update(self.counters.to_dict())
        return out


def make_kv(engine: "ContinuousBatchingServer", kind: str = "dense",
            page_tokens: int = 16, pages: Optional[int] = None,
            prefill_chunk: int = 0) -> KVCacheManager:
    if kind == "dense":
        return DenseKV(engine, prefill_chunk=prefill_chunk)
    if kind == "paged":
        return PagedKV(engine, page_tokens=page_tokens, pages=pages,
                       prefill_chunk=prefill_chunk)
    raise ValueError(f"unknown kv backend {kind!r}; "
                     f"expected one of {KV_BACKENDS}")
