"""Trainer: the training loop, the port's copy of ``repro.runtime.trainer``.

Every launch is one doorbell and, on the card, one CUDA Graph replay
(``core.graphs.CapturedStep``) of K train steps (``steps_per_launch``):

* the params, the fp32 master weights and moments, the step counter and the
  error-feedback residuals are fixed tensors that the captured steps update
  in place; only the batch is copied in before each launch, into fixed
  buffers shaped as the pipeline's first batch (tokens and labels, with
  fp32 frames for audio or patch embeddings for vlm), one batch (K = 1)
  or K stacked (K > 1, the reference's ``lax.scan`` input);
* the first launch is the capture's eager warm-up, which is a real launch
  of K steps; the capture follows it and every later launch replays the
  graph.  There is no eager fallback: a failed capture raises;
* unlike the reference's ``lax.scan``, the graph holds K unrolled steps, so
  its footprint grows with K (``graphs()``, ``CapturedStep.footprint``);
* after each launch one progress fence, then one host read of the K
  losses (``losses``; ``metrics_log`` keeps the last, as the reference).

The model is the reference's training route, ``impl="ref"``: no kernel of
the port runs in a train step.  On the CPU (``device="cpu"``) nothing is
captured and every launch runs the same steps directly.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..configs.shapes import ShapeConfig
from ..core.graphs import CapturedStep
from ..core.session import TraceSession
from ..data.pipeline import SyntheticTokens, make_pipeline
from ..device import resolve_device
from ..models import get_model
from ..models.layers import Params
from ..optim.adamw import tree_leaves
from ..optim.compression import ef_init
from ..tune.policy import Policy, load_policy_for
from .checkpoint import CheckpointManager, latest_step, restore
from .fault_tolerance import FleetMonitor
from .steps import init_all, make_train_step

__all__ = ["Trainer"]

class Trainer:
    """Train ``cfg`` on the deterministic synthetic pipeline at ``shape``.

    ``steps_per_launch=None`` auto-applies the tuned policy for this
    (model config, platform, device count), if one is persisted, else 1;
    an explicit value always wins, with ``policy`` None.  ``params`` (e.g. the reference's, through
    ``weights.params_from_jax``) is copied; without it the model's seeded
    init (``seed``) is used.  ``device`` defaults to ``cuda``.
    ``grad_compression="int8"`` applies at K = 1 only, as in the reference,
    whose K-step scan passes no error-feedback state.
    """

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 steps_per_launch: Optional[int] = None,
                 ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 100,
                 grad_compression: Optional[str] = None,
                 peak_lr: float = 3e-4,
                 seed: int = 0,
                 session: Optional[TraceSession] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 params: Optional[Params] = None) -> None:
        self.cfg = cfg
        self.shape = shape
        # the policy is keyed by the device's platform: resolve it first
        self.device = resolve_device(device)
        self.policy: Optional[Policy] = None
        if steps_per_launch is None:
            self.policy = load_policy_for(cfg, device=self.device)
            steps_per_launch = (self.policy.knob("steps_per_launch", 1)
                                if self.policy else 1)
        self.k = max(1, int(steps_per_launch))
        self.model = get_model(cfg, impl="ref", device=self.device)
        # one session carries every event of this trainer; callers share
        # theirs to merge timelines
        self.session = session or TraceSession(name="trainer")
        self.tracker = self.session.doorbell
        self.progress = self.session.progress
        self.monitor = FleetMonitor(n_workers=1)
        self.grad_compression = grad_compression
        self.ckpt = (CheckpointManager(ckpt_dir, every_steps=ckpt_every)
                     if ckpt_dir else None)
        self.seed = seed
        self.step = 0
        self.metrics_log: List[Dict[str, Any]] = []
        self.losses: List[float] = []

        with self.session:          # init_all's ambient span lands here
            self.params, self.opt_state = init_all(self.model, cfg, seed,
                                                   params)
        self.ef_state = (ef_init(self.params)
                         if grad_compression == "int8" and self.k == 1
                         else None)
        self._step_fn = make_train_step(self.model, cfg, peak_lr=peak_lr,
                                        grad_compression=grad_compression)
        # the family's batch, shaped as the pipeline draws it: tokens and
        # labels, with fp32 frames (audio) or patch embeddings (vlm)
        lead = () if self.k == 1 else (self.k,)
        self._batch = {
            key: torch.zeros(lead + a.shape, dtype=torch.from_numpy(a).dtype,
                             device=self.device)
            for key, a in SyntheticTokens(cfg, shape, seed).batch_at(0).items()}
        self._loss = torch.zeros(self.k, dtype=torch.float32,
                                 device=self.device)
        self._graph = CapturedStep(self._steps, self.device)
        self._launch = self.tracker.wrap(
            self._launch_call, "train_step" if self.k == 1 else "train_k_steps")

    # ------------------------------------------------------------------
    def _steps(self) -> torch.Tensor:
        """K train steps on the fixed tensors; the losses land in
        ``self._loss``."""
        for i in range(self.k):
            batch = (self._batch if self.k == 1 else
                     {key: v[i] for key, v in self._batch.items()})
            extra = () if self.ef_state is None else (self.ef_state,)
            out = self._step_fn(self.params, self.opt_state, batch, *extra)
            self._loss[i].copy_(out[2]["loss"])
        return self._loss

    def _launch_call(self, *args: Any) -> None:
        """One launch of K steps on the fixed tensors (``args`` are they,
        passed so that the doorbell counts their bytes)."""
        if self.device.type == "cuda" and self._graph.graph is None:
            self._graph.capture()        # its warm-up is this launch
        else:
            self._graph()

    def graphs(self) -> Dict[str, CapturedStep]:
        """The trainer's step by name: one CUDA Graph once captured."""
        return {f"train K={self.k}": self._graph}

    def _stage(self, pipe: Any) -> None:
        """The next K batches of ``pipe`` into the fixed batch buffer."""
        batches = [pipe.next()[1] for _ in range(self.k)]
        for key, buf in self._batch.items():
            host = (batches[0][key] if self.k == 1 else
                    np.stack([b[key] for b in batches]))
            buf.copy_(torch.from_numpy(host))

    def maybe_restore(self) -> bool:
        """Restore the latest checkpoint into the fixed tensors, in place,
        so a captured graph trains on from it."""
        if self.ckpt is None or latest_step(self.ckpt.dir) is None:
            return False
        tree = (self.params, self.opt_state)
        loaded, step, extra = restore(self.ckpt.dir, tree)
        with torch.no_grad():
            for dst, src in zip(tree_leaves(tree), tree_leaves(loaded)):
                dst.copy_(src)
        self.step = int(extra.get("next_step", step))
        return True

    def train(self, num_steps: int, pipe: Any = None,
              eager: bool = False) -> Dict[str, Any]:
        """Launch K steps at a time until ``num_steps`` steps are done.
        ``eager=True`` runs each launch's steps without a graph (the
        control a captured run is held to); it rings no doorbell."""
        own_pipe = pipe is None
        if own_pipe:
            pipe = make_pipeline(self.cfg, self.shape, self.seed,
                                 start_step=self.step)
        t0 = time.perf_counter()
        # the session may be shared: report this run's deltas
        db0 = self.tracker.count
        ev0 = self.session.n_events
        args = (self.params, self.opt_state, self._batch)
        if self.ef_state is not None:
            args += (self.ef_state,)
        try:
            while self.step < num_steps:
                # one span per launch: the data staging, the launch and
                # its progress fence
                with self.session.span("train.step", step=self.step,
                                       k=self.k):
                    self._stage(pipe)
                    if eager:
                        self._steps()
                    else:
                        self._launch(*args)
                    self.step += self.k
                    tok = self.progress.release(self._loss)
                    self.progress.wait(tok)            # fence the launch
                self.monitor.step_completed(0)
                losses = self._loss.tolist()
                self.losses += losses
                self.metrics_log.append({"step": self.step,
                                         "loss": losses[-1]})
                if self.ckpt is not None:
                    self.ckpt.maybe_save(
                        self.step, (self.params, self.opt_state),
                        extra={"next_step": self.step})
        finally:
            if own_pipe:
                pipe.stop()
            if self.ckpt is not None:
                self.ckpt.wait()
        wall = time.perf_counter() - t0
        doorbells = self.tracker.count - db0
        return {"steps": self.step, "wall_s": wall,
                "final_loss": self.metrics_log[-1]["loss"],
                "doorbells": doorbells,
                "steps_per_doorbell": self.step / max(1, doorbells),
                "trace_events": self.session.n_events - ev0}

    def submission_report(self) -> Dict[str, Any]:
        out = self.tracker.summary()
        out["session"] = self.session.summary()
        return out

    def trace_report(self, max_events: int = 60) -> str:
        """Listing-1-style interleaved timeline of this trainer's run."""
        return self.session.report(max_events=max_events)
