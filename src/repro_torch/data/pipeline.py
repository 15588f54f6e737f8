"""Deterministic synthetic data pipeline with per-host sharding + prefetch:
the port's copy of ``repro.data.pipeline``, numpy only, so every batch
equals the reference's byte for byte.

Every batch is a pure function of (seed, step, host) — restart-safe: after a
checkpoint restore at step k the pipeline regenerates exactly the batches it
would have produced, which is what makes checkpoint/restart exact (see
runtime/fault_tolerance.py).  A background thread prefetches ahead of the
training loop so host data work overlaps device compute — the same
submission-overlap lesson as the paper's pipelined pushbuffer writes.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np

from ..configs.base import ModelConfig
from ..configs.shapes import ShapeConfig

__all__ = ["SyntheticTokens", "Prefetcher", "make_pipeline"]


class SyntheticTokens:
    """Zipf-ish synthetic token stream (deterministic per step/host)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                 host_id: int = 0, n_hosts: int = 1) -> None:
        assert shape.global_batch % n_hosts == 0
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.host_batch = shape.global_batch // n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg, shape = self.cfg, self.shape
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.host_id)
        B, S = self.host_batch, shape.seq_len
        # zipf-like marginal over the real (unpadded) vocab
        u = rng.random((B, S + 1))
        toks = np.minimum((cfg.vocab_size * u ** 2.2).astype(np.int32),
                          cfg.vocab_size - 1)
        out: Dict[str, np.ndarray] = {}
        if cfg.family == "audio":
            S_dec = max(S // cfg.enc_seq_ratio, 1)
            out["frames"] = rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)
            out["tokens"] = toks[:, :S_dec]
            out["labels"] = toks[:, 1:S_dec + 1]
        elif cfg.family == "vlm":
            S_text = S - cfg.n_patches
            out["patch_embeds"] = rng.standard_normal(
                (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
            out["tokens"] = toks[:, :S_text]
            out["labels"] = toks[:, 1:S_text + 1]
        else:
            out["tokens"] = toks[:, :S]
            out["labels"] = toks[:, 1:S + 1]
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of a step-indexed dataset."""

    def __init__(self, dataset: SyntheticTokens, start_step: int = 0,
                 depth: int = 2) -> None:
        self.dataset = dataset
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        step = self._step
        while not self._stop.is_set():
            batch = self.dataset.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self, timeout: float = 30.0):
        return self.q.get(timeout=timeout)

    def stop(self) -> None:
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


def make_pipeline(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                  host_id: int = 0, n_hosts: int = 1,
                  start_step: int = 0, prefetch: int = 2) -> Prefetcher:
    return Prefetcher(SyntheticTokens(cfg, shape, seed, host_id, n_hosts),
                      start_step=start_step, depth=prefetch)
