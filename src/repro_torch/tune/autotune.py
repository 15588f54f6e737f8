"""The measurement->search->apply loop behind ``python -m repro_torch.tune``.

The port's copy of ``repro.tune.autotune``.  Each candidate knob assignment
is scored on small, representative workloads run under a fresh
:class:`~repro_torch.core.session.TraceSession`, on the card unless the
caller passes ``device="cpu"``:

* ``dma``   — a :class:`~repro_torch.core.dma.HybridMover` put-sweep across
  sizes straddling the inline/direct switch (knob: ``dma_threshold_bytes``;
  inline is one CUDA Graph replay carrying the payload in kernel
  parameters, direct a pageable ``cudaMemcpy``);
* ``serve`` — a :class:`~repro_torch.runtime.server.Server` greedy-decode
  batch, or (``serve_mode="continuous"``) the continuous-batching engine
  (knob: ``tokens_per_launch``, the steps one decode graph replay holds);
* ``train`` — a :class:`~repro_torch.runtime.trainer.Trainer` run (knob:
  ``steps_per_launch``, the train steps one graph replay holds);
* ``kv``    — shared-prefix continuous-batching traffic on the paged KV
  backend (knobs: ``kv_page_tokens``, ``prefill_chunk``, which set the
  paged engine's graph shapes); opt-in via ``--workloads``.

Every workload warms up first (the CUDA Graph captures, the inline payload
cache) and measures only the steady-state summary delta, because that is
the regime a persisted policy runs in.  Workload results are cached by the
sub-assignment of knobs they actually read, so coordinate descent never
re-measures an unchanged workload.  Each workload's owner is released
before the next is built (a captured graph's memory pool lives as long as
its graph).
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from .env import EnvPreset, snapshot_env
from .objective import Metrics, Objective, metrics_from_summary
from .policy import Policy, activate_policy, platform_of, save_policy
from .search import Knob, SearchResult, coordinate_descent

__all__ = ["WorkloadSpec", "KNOB_WORKLOADS", "default_knobs",
           "CandidateEvaluator", "tune"]

#: workload name -> the knobs its measurement depends on (the cache key).
KNOB_WORKLOADS: Dict[str, Tuple[str, ...]] = {
    "dma": ("dma_threshold_bytes",),
    "serve": ("tokens_per_launch",),
    "train": ("steps_per_launch",),
    # paged-KV serving path: page granularity and prefill chunking are
    # coupled (a chunk boundary lands mid-page or not), so one workload
    # measures both under shared-prefix continuous-batching traffic.
    "kv": ("kv_page_tokens", "prefill_chunk"),
}


@dataclasses.dataclass
class WorkloadSpec:
    """Sizes of the measurement workloads (smoke-scale by default)."""

    # serve; ``serve_mode="continuous"`` measures the knob under the
    # continuous-batching engine (queued Poisson traffic, per-slot decode)
    # instead of a static one-shot batch — the regime a serving policy
    # actually runs in.
    batch: int = 2
    prompt_len: int = 4
    new_tokens: int = 8
    max_seq: int = 64
    serve_mode: str = "oneshot"   # oneshot | continuous
    serve_requests: int = 6       # continuous mode: requests per measurement
    kv_prefix_len: int = 16       # kv workload: shared prefix tokens
    # train
    train_batch: int = 2
    train_seq: int = 32
    train_steps: int = 8          # measured steps; ladder values must divide
    # dma
    dma_sizes: Tuple[int, ...] = (256, 4096, 32 * 1024, 256 * 1024)
    dma_repeats: int = 3
    seed: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def default_knobs(workloads: Sequence[str]) -> List[Knob]:
    """The exposed submission knobs, as discrete ladders, per workload."""
    from ..core.dma import INLINE_THRESHOLD_DEFAULT
    ladders = {
        "dma": (Knob("dma_threshold_bytes",
                     (0, 4 * 1024, INLINE_THRESHOLD_DEFAULT, 128 * 1024),
                     default=INLINE_THRESHOLD_DEFAULT),),
        "serve": (Knob("tokens_per_launch", (1, 2, 4, 8), default=1),),
        "train": (Knob("steps_per_launch", (1, 2, 4), default=1),),
        # page-size ladder must divide the workload max_seq (64); chunk 0
        # means whole-prompt prefill (the chunking-off baseline).
        "kv": (Knob("kv_page_tokens", (4, 8, 16, 32), default=16),
               Knob("prefill_chunk", (0, 4, 8, 16), default=0)),
    }
    return [k for w in workloads for k in ladders[w]]


def _release(device: torch.device) -> None:
    """Free what the last workload's owner held: its reference cycles, and
    on the card the cached blocks of its graphs' pools."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


class CandidateEvaluator:
    """Score one knob assignment across the enabled workloads.

    Callable with the :func:`~repro_torch.tune.search.coordinate_descent`
    contract: ``evaluate(knobs) -> (score, info)``.  Per-workload
    measurements are cached by the knob values that workload reads.
    Every owner runs on ``device`` (``None`` means ``cuda``).
    """

    def __init__(self, cfg: Any, spec: WorkloadSpec = WorkloadSpec(),
                 objective: Optional[Objective] = None,
                 workloads: Sequence[str] = ("dma", "serve", "train"),
                 log: Optional[Callable[[str], None]] = None,
                 device: Optional[Union[str, torch.device]] = "cuda"
                 ) -> None:
        unknown = set(workloads) - set(KNOB_WORKLOADS)
        if unknown:
            raise ValueError(f"unknown workloads: {sorted(unknown)}")
        self.cfg = cfg
        self.spec = spec
        self.objective = objective or Objective()
        self.workloads = tuple(workloads)
        self.device = resolve_device(device)
        self._cache: Dict[Tuple, Metrics] = {}
        self._log = log or (lambda s: None)

    # -- workloads ---------------------------------------------------------
    def _measure_dma(self, knobs: Dict[str, Any]) -> Metrics:
        from ..core.dma import HybridMover
        from ..core.session import TraceSession
        spec = self.spec
        arrays = [np.arange(max(1, n), dtype=np.int64).astype(np.uint8)
                  for n in spec.dma_sizes]
        with TraceSession(name="tune_dma") as sess:
            mover = HybridMover(threshold=knobs["dma_threshold_bytes"],
                                device=self.device, session=sess)
            for x in arrays:                       # warm: stage inline puts
                mover.put(x)
            before = sess.summary()
            for _ in range(spec.dma_repeats):
                for x in arrays:
                    mover.put(x)
            m = metrics_from_summary(
                sess.summary(), before,
                tokens=spec.dma_repeats * len(arrays))
        return m

    def _measure_serve(self, knobs: Dict[str, Any]) -> Metrics:
        if self.spec.serve_mode == "continuous":
            return self._measure_serve_continuous(knobs)
        from ..core.session import TraceSession
        from ..runtime.server import Request, Server
        spec = self.spec
        rng = np.random.default_rng(spec.seed)

        def requests() -> List[Request]:
            return [Request(i, rng.integers(
                        0, self.cfg.vocab_size,
                        size=spec.prompt_len).astype(np.int32),
                        max_new_tokens=spec.new_tokens)
                    for i in range(spec.batch)]

        with TraceSession(name="tune_serve") as sess:
            srv = Server(self.cfg, batch_size=spec.batch,
                         max_seq=spec.max_seq,
                         tokens_per_launch=knobs["tokens_per_launch"],
                         seed=spec.seed, session=sess, device=self.device)
            srv.serve(requests())                  # warm: capture + dispatch
            before = sess.summary()
            out = srv.serve(requests())
            m = metrics_from_summary(sess.summary(), before,
                                     tokens=out["new_tokens"])
        return m

    def _measure_serve_continuous(self, knobs: Dict[str, Any]) -> Metrics:
        """Score ``tokens_per_launch`` under continuous batching: seeded
        Poisson traffic drained synchronously (deterministic scheduling),
        steady-state summary delta after one warm-up replay."""
        from ..core.session import TraceSession
        from ..runtime.server import ContinuousBatchingServer
        from ..runtime.traffic import TrafficSpec, generate, replay
        spec = self.spec
        tspec = TrafficSpec(n_requests=spec.serve_requests, rate=1000.0,
                            prompt_lens=(spec.prompt_len,),
                            new_tokens=(spec.new_tokens,), seed=spec.seed)
        with TraceSession(name="tune_serve_cb") as sess:
            eng = ContinuousBatchingServer(
                self.cfg, batch_size=spec.batch, max_seq=spec.max_seq,
                tokens_per_launch=knobs["tokens_per_launch"],
                seed=spec.seed, session=sess, device=self.device)
            # warm: captures prefill (per prompt length) + the slot decode
            replay(eng, generate(tspec, self.cfg.vocab_size),
                   realtime=False)
            before = sess.summary()
            _, out = replay(eng, generate(tspec, self.cfg.vocab_size),
                            realtime=False)
            m = metrics_from_summary(sess.summary(), before,
                                     tokens=out["new_tokens"])
        return m

    def _measure_kv(self, knobs: Dict[str, Any]) -> Metrics:
        """Score page size + prefill chunking on the paged backend under
        shared-prefix traffic — the regime where both knobs matter: page
        granularity sets how much of the common prefix is reusable, and
        the chunk bound trades prefill latency against decode stalls."""
        from ..core.session import TraceSession
        from ..runtime.server import ContinuousBatchingServer
        from ..runtime.traffic import TrafficSpec, generate, replay
        spec = self.spec
        tspec = TrafficSpec(n_requests=spec.serve_requests, rate=1000.0,
                            prompt_lens=(spec.prompt_len,),
                            new_tokens=(spec.new_tokens,), seed=spec.seed,
                            prefix_len=spec.kv_prefix_len)
        with TraceSession(name="tune_kv") as sess:
            # tokens_per_launch is pinned (not read from ``knobs``): it is
            # not in this workload's cache key, so reading it would serve
            # stale measurements when the serve workload tunes it.
            eng = ContinuousBatchingServer(
                self.cfg, batch_size=spec.batch, max_seq=spec.max_seq,
                tokens_per_launch=4,
                seed=spec.seed, session=sess, kv="paged",
                kv_page_tokens=int(knobs["kv_page_tokens"]),
                prefill_chunk=int(knobs["prefill_chunk"]),
                device=self.device)
            # warm: captures the paged decode + extend graphs
            replay(eng, generate(tspec, self.cfg.vocab_size),
                   realtime=False)
            before = sess.summary()
            _, out = replay(eng, generate(tspec, self.cfg.vocab_size),
                            realtime=False)
            m = metrics_from_summary(sess.summary(), before,
                                     tokens=out["new_tokens"])
        return m

    def _measure_train(self, knobs: Dict[str, Any]) -> Metrics:
        from ..configs.shapes import ShapeConfig
        from ..core.session import TraceSession
        from ..runtime.trainer import Trainer
        spec = self.spec
        k = int(knobs["steps_per_launch"])
        shape = ShapeConfig("tune", spec.train_seq, spec.train_batch, "train")
        with TraceSession(name="tune_train") as sess:
            tr = Trainer(self.cfg, shape, steps_per_launch=k,
                         seed=spec.seed, session=sess, device=self.device)
            tr.train(k)                            # warm: one launch + capture
            before = sess.summary()
            steps = max(k, (spec.train_steps // k) * k)
            tr.train(tr.step + steps)
            m = metrics_from_summary(sess.summary(), before, tokens=steps)
        return m

    _MEASURE = {"dma": _measure_dma, "serve": _measure_serve,
                "train": _measure_train, "kv": _measure_kv}

    # -- evaluation --------------------------------------------------------
    def measure(self, workload: str, knobs: Dict[str, Any]) -> Metrics:
        key = (workload,) + tuple(knobs[k] for k in KNOB_WORKLOADS[workload])
        if key not in self._cache:
            t0 = time.perf_counter()
            self._cache[key] = self._MEASURE[workload](self, knobs)
            _release(self.device)
            self._log(f"    measured {key} in "
                      f"{time.perf_counter() - t0:.1f}s")
        return self._cache[key]

    def __call__(self, knobs: Dict[str, Any]
                 ) -> Tuple[float, Dict[str, Any]]:
        total = 0.0
        info: Dict[str, Any] = {}
        for w in self.workloads:
            if any(k not in knobs for k in KNOB_WORKLOADS[w]):
                continue
            m = self.measure(w, knobs)
            s = self.objective.score(m)
            total += s
            info[w] = {"score": s, **m.to_dict()}
        return total, info


def tune(arch: str, smoke: bool = True, rounds: int = 2,
         workloads: Sequence[str] = ("dma", "serve", "train"),
         spec: WorkloadSpec = WorkloadSpec(),
         objective: Optional[Objective] = None,
         env_preset: Optional[EnvPreset] = None,
         policy_dir: Optional[str] = None,
         log: Optional[Callable[[str], None]] = print,
         device: Optional[Union[str, torch.device]] = "cuda",
         ) -> Tuple[Policy, SearchResult, str]:
    """Search the knob space for ``arch`` on ``device``; persist + activate
    the winner.

    Returns ``(policy, search_result, saved_path)``.  The policy's
    ``objective`` block records the before (all-defaults) and after (best)
    scores plus the full trial log, so the win is auditable without
    re-running the tuner.  The preset is applied before anything touches
    the device.
    """
    from ..configs import ARCHS, SMOKE_ARCHS
    if env_preset is not None:
        env_preset.apply()
    dev = resolve_device(device)
    cfg = (SMOKE_ARCHS if smoke else ARCHS)[arch]
    objective = objective or Objective()
    knobs = default_knobs(workloads)
    evaluator = CandidateEvaluator(cfg, spec=spec, objective=objective,
                                   workloads=workloads, log=log, device=dev)
    result = coordinate_descent(evaluator, knobs, max_rounds=rounds, log=log)
    platform, device_count = platform_of(dev)
    # Key the policy by the config's own name (what Trainer/Server look up
    # via ``cfg.name``), not the registry key -- smoke registries alias
    # "gemma-2b" to a config named "gemma-smoke".
    policy = Policy(
        arch=getattr(cfg, "name", None) or arch,
        platform=platform,
        device_count=device_count,
        knobs=dict(result.best),
        objective={
            "before": result.start_score,
            "after": result.best_score,
            "improvement": result.improvement,
            "weights": dataclasses.asdict(objective.weights),
            "trials": [t.to_dict() for t in result.trials],
        },
        env={**snapshot_env(dev),
             **({"preset": env_preset.to_dict()} if env_preset else {})},
        meta={
            "arch_key": arch,
            "smoke": smoke,
            "rounds": result.rounds,
            "workloads": list(workloads),
            "workload_spec": spec.to_dict(),
            "created_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        })
    path = save_policy(policy, policy_dir)
    activate_policy(policy)
    if log:
        log(f"policy saved: {path}")
        log(f"objective: before={result.start_score:.3e} "
            f"after={result.best_score:.3e} "
            f"({100 * result.improvement:.1f}% better), knobs={result.best}")
    return policy, result, path
