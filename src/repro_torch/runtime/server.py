"""Serving: batched prefill + greedy decode with doorbell accounting.

The port of ``repro.runtime.server``: the one-shot :class:`Server` and the
:class:`ContinuousBatchingServer`.  Decode is the
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

The continuous engine admits queued requests into KV slots between decode
launches; its graphs (one prefill a prompt length, one extend a prompt-chunk
length, one decode over all slots) live in its KV backend,
``runtime/kv.py``: dense slots or a page pool with block tables, with or
without chunked prefill.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.graphs import CapturedStep
from ..core.session import SpanHandle, TraceSession
from ..device import resolve_device
from ..models import get_model
from ..models.layers import Params, greedy
from ..obs.live import LiveServer, LiveSummary
from ..tune.policy import Policy, load_policy_for
from .kv import make_kv
from .scheduler import (AdmissionQueue, RequestTicket, latency_stats,
                        make_policy)

__all__ = ["Server", "Request", "ContinuousBatchingServer"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # [S] int32
    max_new_tokens: int = 16
    tokens: Optional[List[int]] = None
    priority: int = 0           # PriorityPolicy: higher admits first
    user: str = ""              # FairSharePolicy: least-served user first


def _empty_metrics() -> Dict[str, Any]:
    return {"wall_s": 0.0, "doorbells": 0, "new_tokens": 0,
            "tokens_per_doorbell": 0.0, "trace_events": 0}


class _Serving:
    """What both serving surfaces share: the model on the kernel route
    (``impl="cuda"``) of the config's family, its params, the session and
    its doorbell tracker.

    ``params`` defaults to the model's seeded init (``seed``); pass a param
    tree to serve given weights (e.g. the reference's, via
    :func:`repro_torch.weights.params_from_jax`, or another server's: the
    tree is shared, not copied).  ``tokens_per_launch=None`` auto-applies
    the tuned policy for this (model config, platform, device count), if
    one is persisted (:func:`repro_torch.tune.policy.load_policy_for`, which
    also makes it ambient), else 1; an explicit value always wins, with
    ``policy`` None.
    """

    def __init__(self, cfg: ModelConfig, batch_size: int, max_seq: int,
                 tokens_per_launch: Optional[int] = None, seed: int = 0,
                 session: Optional[TraceSession] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 params: Optional[Params] = None) -> None:
        self.cfg = cfg
        self.B = batch_size
        self.max_seq = max_seq
        # the policy is keyed by the device's platform: resolve it first
        self.device = resolve_device(device)
        self.policy: Optional[Policy] = None
        if tokens_per_launch is None:
            self.policy = load_policy_for(cfg, device=self.device)
            tokens_per_launch = (self.policy.knob("tokens_per_launch", 1)
                                 if self.policy else 1)
        self.T = max(1, int(tokens_per_launch))
        self.model = get_model(cfg, impl="cuda", device=self.device)
        # Shared timeline: pass a session to merge serving events with a
        # benchmark's; otherwise the server owns one.
        self.session = session or TraceSession(name="server")
        self.tracker = self.session.doorbell
        self.params = (params if params is not None
                       else self.model.init_params(seed))


class Server(_Serving):
    """Static-batch greedy server: one batch of requests decoded to the
    end (see :class:`_Serving` for the arguments)."""

    def __init__(self, cfg: ModelConfig, batch_size: int, max_seq: int,
                 tokens_per_launch: Optional[int] = None, seed: int = 0,
                 session: Optional[TraceSession] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 params: Optional[Params] = None) -> None:
        super().__init__(cfg, batch_size, max_seq, tokens_per_launch, seed,
                         session, device, params)

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
            self._tok.copy_(greedy(logits))
        return step

    def _decode_steps(self) -> None:
        """T greedy decode steps on the fixed state: the tokens go to the
        block ``[T, B]`` and the last one back into the input."""
        tokens = self._tok
        for t in range(self.T):
            _, logits = self.model.decode_step(self.params, self.state, tokens)
            tokens = greedy(logits)
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


class ContinuousBatchingServer(_Serving):
    """Continuous-batching inference engine.

    Requests are :meth:`submit`-ted (thread-safe — a traffic-generator
    thread can feed a running decode loop) into a bounded
    :class:`~repro_torch.runtime.scheduler.AdmissionQueue`; :meth:`run`
    drives the decode loop, admitting queued requests into free KV slots
    *between decode launches*, so the one captured ``tokens_per_launch``
    decode never changes shape (and is never captured again) across
    join/leave boundaries.

    Per-request state: slot ``i`` holds its own decode state, with its own
    cache length; one decode launch runs every slot.  Prefill runs per
    admitted request at its exact prompt length (one graph per distinct
    length), so a request's greedy chain is the one ``Server.serve([request])``
    gives, whenever it joined and whoever shared the batch (in fp32 exactly;
    in bf16 up to near-ties, since the batched decode's products run at
    M = B rather than 1).  With ``prefill_chunk=C`` a longer prompt is only
    *started* at admission, then advanced one ``C``-token chunk a scheduler
    iteration (round-robin over the prompts still prefilling), so active
    slots keep decoding underneath; on the card the chunks' attention is
    the plain masked softmax, not the flash kernel, so bf16 tokens equal
    the whole-prompt prefill's up to near-ties (fp32 exactly).

    Lifecycle events land on the session timeline as ``progress`` events
    (``serve.submit/admit/finish/evict/reject``); a finish event carries
    the emitted tokens as its payload (4 bytes each), so token throughput
    is recoverable from session accounting alone.

    Observability plane: the engine installs a
    :class:`~repro_torch.obs.LiveSummary` sink on its session, so
    :meth:`live_summary` answers at any point *during* a run with the same
    schema ``session.summary()`` gives post-mortem (plus engine state:
    active slots, queue depth, ticket fates).  :meth:`start_live_endpoint`
    serves that over HTTP (``GET /summary``, ``GET /stream``).

    ``kv`` names the backend: ``"dense"`` (a full ``max_seq`` cache a
    slot) or ``"paged"`` (a pool of ``kv_pages`` pages of ``kv_page_tokens``
    tokens, block tables, shared-prefix pages; pool exhaustion evicts with
    ``reason="kv_pages"``); both need a model with ``prefill_extend`` for
    ``"paged"`` or ``prefill_chunk > 0`` (Mamba2 has none and raises
    ``ValueError``).  Unset, ``kv_page_tokens`` (paged only) and
    ``prefill_chunk`` come from the tuned policy that an unset
    ``tokens_per_launch`` loads (:class:`_Serving`), else 16 and 0.  Runs
    on the card unless ``device="cpu"``; ``params`` as for :class:`Server`.
    """

    def __init__(self, cfg: ModelConfig, batch_size: int, max_seq: int,
                 tokens_per_launch: Optional[int] = None, seed: int = 0,
                 session: Optional[TraceSession] = None,
                 max_pending: int = 256,
                 admission: str = "reject",
                 kv: str = "dense",
                 kv_page_tokens: Optional[int] = None,
                 kv_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 sched: str = "fifo",
                 device: Optional[Union[str, torch.device]] = None,
                 params: Optional[Params] = None) -> None:
        super().__init__(cfg, batch_size, max_seq, tokens_per_launch, seed,
                         session, device, params)
        self.queue = AdmissionQueue(max_pending=max_pending, policy=admission)
        self.sched_policy = make_policy(sched)
        self.tickets: List[RequestTicket] = []      # submit order, all fates
        self._slot_tix: List[Optional[RequestTicket]] = [None] * self.B
        self._prefilling: set = set()               # slots mid-chunked-prefill
        self._prefill_rr = 0                        # round-robin tick cursor
        # per-request causal spans: a request's lifetime crosses scheduler
        # iterations (and the decode launch is shared by every active slot),
        # so these are manual handles closed in _finish with *declared*
        # attribution — n_launches decode launches + prefill launches
        self._req_spans: Dict[int, SpanHandle] = {}

        # live observability plane: every event the (possibly shared)
        # session emits while this engine exists also folds into an
        # incremental summary a poller can read mid-run
        self.live = LiveSummary(name=self.session.name)
        self.session.add_sink(self.live)
        self._live_server: Optional[LiveServer] = None

        # unset knobs fall back to the tuned policy for this config, then to
        # 16 and 0; explicit invalid values (e.g. 0) must reach
        # kv_geometry's validation instead of being silently coerced
        # (a page size only for the paged backend: dense has no pages)
        if kv_page_tokens is None:
            kv_page_tokens = int(self.policy.knob("kv_page_tokens", 16)
                                 if self.policy and kv == "paged" else 16)
        if prefill_chunk is None:
            prefill_chunk = int(self.policy.knob("prefill_chunk", 0)
                                if self.policy else 0)
        self.kv = make_kv(self, kv, page_tokens=kv_page_tokens,
                          pages=kv_pages, prefill_chunk=prefill_chunk)

    def graphs(self) -> Dict[str, CapturedStep]:
        """The engine's captured steps by name: one prefill a distinct
        prompt length, one extend a distinct chunk length, and the one
        decode."""
        return self.kv.graphs()

    # -- intake (any thread) ----------------------------------------------
    def submit(self, request: Request) -> RequestTicket:
        """Enqueue a request; returns its ticket (possibly already
        ``rejected`` — admission control, not an exception, because the
        traffic thread must keep running).  Host-only: touches no device."""
        tix = RequestTicket(request=request, t_submit=time.perf_counter())
        if len(request.prompt) > self.max_seq:
            tix.status, tix.reason = "rejected", "prompt_exceeds_max_seq"
            tix.t_done = tix.t_submit
        else:
            accepted, dropped = self.queue.submit(tix)
            if dropped is not None:
                dropped.status, dropped.reason = "evicted", "queue_overflow"
                dropped.t_done = time.perf_counter()
                self.session.emit("progress", "serve.evict",
                                  uid=dropped.uid, reason=dropped.reason)
                self._end_request_span(dropped)
            if not accepted:
                tix.status = "rejected"
                tix.reason = ("intake_closed" if self.queue.closed
                              else "queue_full")
                tix.t_done = time.perf_counter()
            else:
                self._req_spans[tix.uid] = self.session.start_span(
                    "serve.request", uid=tix.uid,
                    prompt_len=int(len(request.prompt)))
        self.tickets.append(tix)
        name = "serve.submit" if not tix.finished else "serve.reject"
        self.session.emit("progress", name, uid=tix.uid, status=tix.status,
                          reason=tix.reason)
        return tix

    def close_intake(self) -> None:
        """No more submits: :meth:`run` may exit once everything drains."""
        self.queue.close()

    # -- live observability (any thread) -----------------------------------
    def live_summary(self) -> Dict[str, Any]:
        """Session-schema summary *now*, plus engine state.

        Safe from any thread while the decode loop runs; this is the
        poll-mode payload of the live endpoint.
        """
        snap = self.live.snapshot()
        tickets = list(self.tickets)
        snap["engine"] = {
            "slots": self.B,
            "active": self.n_active,
            "queued": len(self.queue),
            "intake_closed": self.queue.closed,
            "tickets": {s: sum(1 for t in tickets if t.status == s)
                        for s in ("queued", "active", "done", "evicted",
                                  "rejected")},
            "tokens_emitted": sum(len(t.tokens) for t in tickets),
        }
        return snap

    def start_live_endpoint(self, port: int = 0, host: str = "127.0.0.1"
                            ) -> LiveServer:
        """Serve :meth:`live_summary` over HTTP; returns the started
        :class:`~repro_torch.obs.LiveServer` (``.url``, ``.stop()``)."""
        self._live_server = LiveServer(self.live_summary, host=host,
                                       port=port).start()
        return self._live_server

    def stop_live_endpoint(self) -> None:
        if self._live_server is not None:
            self._live_server.stop()
            self._live_server = None

    # -- scheduling (decode-loop thread) -----------------------------------
    def _free_slots(self) -> List[int]:
        return [i for i, t in enumerate(self._slot_tix) if t is None]

    @property
    def n_active(self) -> int:
        return sum(1 for t in self._slot_tix if t is not None)

    def _end_request_span(self, tix: RequestTicket) -> None:
        """Close a request's causal span with its declared attribution.

        The decode launch is shared by every active slot, so this request's
        share of the command stream can't be read off stamped events — it
        is *declared* here instead: one doorbell per decode launch the
        request rode (``n_launches``) plus its prefill, and 4 bytes per
        emitted token (matching the finish-event payload).
        """
        handle = self._req_spans.pop(tix.uid, None)
        if handle is None:
            return
        launches = tix.n_launches
        handle.end(uid=tix.uid, status=tix.status, slot=tix.slot,
                   n_tokens=len(tix.tokens),
                   doorbells=launches + tix.n_prefill_launches,
                   graph_launches=launches,
                   payload=4 * len(tix.tokens))

    def _on_first_token(self, tix: RequestTicket, tok0: int) -> None:
        """Prefill completed: record token 0, finish degenerate requests."""
        self._prefilling.discard(tix.slot)
        tix.tokens.append(tok0)
        tix.t_first = time.perf_counter()
        if len(tix.tokens) >= min(tix.request.max_new_tokens, tix.cap):
            self._finish(tix)           # degenerate 1-token request

    def _admit(self) -> int:
        """Move queued tickets into free slots.

        Whole-prompt admission (no chunking) prefills here, one launch at
        the prompt's exact length.  Prompts longer than the backend's
        ``prefill_chunk`` only *start* here; :meth:`_prefill_tick` advances
        them one bounded launch per scheduler iteration so active slots
        keep decoding underneath.
        """
        admitted = 0
        for slot in self._free_slots():
            tix = self.queue.pop(self.sched_policy)
            if tix is None:
                break
            r = tix.request
            if not self.kv.begin(slot, tix):
                # page pool exhausted even after reclaiming shared pages
                tix.status, tix.reason = "evicted", "kv_pages"
                tix.t_done = time.perf_counter()
                self.session.emit("progress", "serve.evict", uid=tix.uid,
                                  reason=tix.reason)
                self._end_request_span(tix)
                self.sched_policy.note_finished(tix)
                continue
            tix.status, tix.slot = "active", slot
            tix.t_admit = time.perf_counter()
            # KV capacity: decode token j (0-based; token 0 comes straight
            # from prefill logits) writes cache position prompt_len + j - 1,
            # which must stay below max_seq.
            tix.cap = self.max_seq - len(r.prompt) + 1
            self._slot_tix[slot] = tix
            self._prefilling.add(slot)
            chunk = self.kv.chunk
            whole = not (chunk and len(r.prompt) > chunk)
            tok0 = self.kv.prefill_step(slot) if whole else None
            self.session.emit("progress", "serve.admit", uid=tix.uid,
                              slot=slot, queued_s=tix.t_admit - tix.t_submit)
            if whole:
                self._on_first_token(tix, tok0)
            admitted += 1
        return admitted

    def _prefill_tick(self) -> None:
        """Advance at most ONE pending chunked prefill by one launch.

        One bounded launch per scheduler iteration bounds the gap between
        decode launches; round-robin across prefilling slots keeps long
        prompts from starving each other.
        """
        pending = sorted(s for s in self._prefilling
                         if self._slot_tix[s] is not None)
        if not pending:
            return
        slot = pending[self._prefill_rr % len(pending)]
        self._prefill_rr += 1
        tok0 = self.kv.prefill_step(slot)
        if tok0 is not None:
            self._on_first_token(self._slot_tix[slot], tok0)

    def _finish(self, tix: RequestTicket, reason: Optional[str] = None
                ) -> None:
        evicted = (reason is not None
                   or len(tix.tokens) < tix.request.max_new_tokens)
        tix.status = "evicted" if evicted else "done"
        if evicted:
            tix.reason = reason or "kv_overrun"
        tix.t_done = time.perf_counter()
        tix.request.tokens = list(tix.tokens)
        self._slot_tix[tix.slot] = None
        self._prefilling.discard(tix.slot)
        self.kv.release(tix.slot)
        self.session.emit(
            "progress", "serve.evict" if evicted else "serve.finish",
            payload_bytes=4 * len(tix.tokens), uid=tix.uid, slot=tix.slot,
            tokens=len(tix.tokens), latency_s=tix.latency_s,
            **({"reason": tix.reason} if evicted else {}))
        self._end_request_span(tix)
        self.sched_policy.note_finished(tix)

    def step(self) -> bool:
        """One scheduler iteration: admit, advance one chunked prefill,
        then one decode launch across all decodable slots; harvest per-slot
        tokens.  Returns False if idle."""
        self._admit()
        self._prefill_tick()
        decodable = [slot for slot, tix in enumerate(self._slot_tix)
                     if tix is not None and slot not in self._prefilling]
        if not decodable:
            return self.n_active > 0    # prefills pending still count
        # paged backend: grow block tables for the coming T writes; slots
        # the pool cannot serve are evicted (reason="kv_pages") and their
        # freed pages immediately retried for the survivors
        while True:
            victims = self.kv.reserve_decode(decodable)
            if not victims:
                break
            for slot in victims:
                self._finish(self._slot_tix[slot], reason="kv_pages")
                decodable.remove(slot)
            if not decodable:
                return self.n_active > 0
        with self.session.span("serve.decode_iter", active=self.n_active):
            blocks = self.kv.decode()               # [B, T] host sync
            for slot in decodable:
                tix = self._slot_tix[slot]
                tix.n_launches += 1
                budget = min(tix.request.max_new_tokens, tix.cap)
                take = min(self.T, budget - len(tix.tokens))
                tix.tokens.extend(int(t) for t in blocks[slot, :take])
                if len(tix.tokens) >= budget:
                    self._finish(tix)
        return True

    def run(self, idle_timeout_s: float = 5.0,
            poll_s: float = 0.0005) -> Dict[str, Any]:
        """Drive the decode loop until all work drains.

        Exits when no request is queued or active AND either the intake is
        closed (threaded replay calls :meth:`close_intake` when the
        producer finishes) or nothing has arrived for ``idle_timeout_s``
        (synchronous submit-then-run callers never close the intake).
        When idle, the loop blocks on the queue's condition variable —
        :meth:`submit` and :meth:`close_intake` wake it immediately —
        with ``poll_s`` as the floor of its timeout.  Returns run metrics;
        per-request detail lives on the tickets.
        """
        t0 = time.perf_counter()
        db0, ev0 = self.tracker.count, self.session.n_events
        # snapshot: the tickets list grows from the traffic thread mid-run
        done0 = sum(1 for t in list(self.tickets) if t.t_done >= 0)
        tok0 = sum(len(t.tokens) for t in list(self.tickets))
        idle_since: Optional[float] = None
        while True:
            if self.step():
                idle_since = None
                continue
            if len(self.queue) == 0:
                if self.queue.closed:
                    break
                now = time.perf_counter()
                idle_since = idle_since if idle_since is not None else now
                remaining = idle_timeout_s - (now - idle_since)
                if remaining <= 0:
                    break
                self.queue.wait_for_work(timeout=max(poll_s, remaining))
            # else: queued work raced in after this iteration's admit pass;
            # loop around immediately
        wall = time.perf_counter() - t0
        tickets = list(self.tickets)
        ended = [t for t in tickets if t.t_done >= t0]
        by_status = {s: sum(1 for t in ended if t.status == s)
                     for s in ("done", "evicted", "rejected")}
        new_tokens = sum(len(t.tokens) for t in tickets) - tok0
        doorbells = self.tracker.count - db0
        out = {
            "wall_s": wall,
            "requests": sum(1 for t in tickets if t.t_done >= 0) - done0,
            "completed": by_status["done"],
            "evicted": by_status["evicted"],
            "rejected": by_status["rejected"],
            "new_tokens": int(new_tokens),
            "doorbells": doorbells,
            "tokens_per_doorbell": new_tokens / max(1, doorbells),
            "tokens_per_s": new_tokens / max(wall, 1e-9),
            "trace_events": self.session.n_events - ev0,
            # backend accounting (prefill launches/bytes): engine-lifetime
            # totals, not per-run deltas
            "kv": self.kv.stats(),
        }
        # latency percentiles over requests that actually decoded; instant
        # rejections would skew p50 toward zero
        out.update(latency_stats(
            [t for t in ended if t.status in ("done", "evicted")]))
        return out
