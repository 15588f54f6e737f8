"""Host→device data-movement protocols, inline vs direct: the port's copy of
``repro.core.dma``.

The paper's first case study (§6.2, Figure 6) shows the NVIDIA driver
silently choosing between two DMA submission modes for a host→device
``cudaMemcpy``: below a size threshold the payload is embedded *in the
command stream* and the compute engine writes it out (inline DMA); above it
the command carries only source and destination descriptors and a copy
engine moves the bytes (direct DMA).  CUDA exposes no control over the
switch; the paper's §7 contrasts that with Open MPI, whose protocol
thresholds are exposed and tunable.  This module exposes it:

* **inline** (:func:`inline_put`): the payload travels in the parameters of
  kernel launches (``kernels/csrc/inline_put.cu``), which the kernel stores
  at the destination.  The launches of one payload are captured once into a
  ``torch.cuda.CUDAGraph``, cached by content and device as the reference
  caches its compiled materializer; a put is one graph replay.
* **direct** (:func:`direct_put`): a plain copy from pageable host memory,
  ``torch.from_numpy(x).to(device)``, as ``jax.device_put`` is: the driver's
  own ``cudaMemcpy``, whose inline/direct switch the paper measured.

:class:`HybridMover` selects by size against an explicit, user-settable
threshold (default 24 KiB, the paper's observed switch point).

A payload moves as its own bytes: a bfloat16 numpy array (``ml_dtypes``)
moves as 2-byte words and is reinterpreted as ``torch.bfloat16`` on the
device, so a record's ``nbytes`` is the payload's size.  On the CPU (only
when the caller passes ``device="cpu"``) the inline path materializes the
cached payload with a plain copy and the direct path copies the array.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device, wait
from ..kernels import _build, launches
from .session import TraceSession, resolve_session

__all__ = [
    "INLINE_THRESHOLD_DEFAULT",
    "TransferRecord",
    "inline_put",
    "direct_put",
    "HybridMover",
    "sweep_transfer",
]

INLINE_THRESHOLD_DEFAULT = 24 * 1024  # bytes — the paper's observed switch


@dataclasses.dataclass
class TransferRecord:
    mode: str                  # inline | direct
    nbytes: int
    build_s: float             # capture/stage cost (once per payload for inline)
    submit_s: float            # per-call dispatch cost
    complete_s: float          # to completion
    bandwidth_gib_s: float


class _InlineMaterializer:
    """One payload staged for inline puts; :meth:`dispatch` writes it to
    ``out``.

    On CUDA the payload is baked into the captured launches' parameters, so
    the capture is the 'staging' cost (≙ the driver writing payload bytes
    into the pushbuffer) and each replay is the doorbell+engine cost.  Every
    put of the payload rewrites the same ``out``: a put returns that buffer,
    which the caller treats as read-only (or clones).
    """

    def __init__(self, payload: np.ndarray, device: torch.device) -> None:
        self.out = torch.empty(payload.size, dtype=torch.uint8, device=device)
        self._const: Optional[torch.Tensor] = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        if payload.size == 0:
            return
        if device.type == "cpu":
            self._const = torch.from_numpy(payload.copy())
            return
        lib = _build.library()
        with torch.cuda.device(device):
            _build.check(lib.inline_put_prepare(), "inline_put")
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                err = lib.inline_put_launch(
                    payload.ctypes.data, payload.size, self.out.data_ptr(),
                    _build.stream_ptr(device))
            _build.check(err, "inline_put")
        self._graph = graph

    def dispatch(self) -> None:
        if self._graph is not None:
            self._graph.replay()
            launches["inline_put"] += 1
        elif self._const is not None:
            self.out.copy_(self._const)


class _InlineCache:
    """Staged materializers keyed by payload fingerprint and device."""

    def __init__(self, maxsize: int = 64) -> None:
        self._cache: Dict[Any, Any] = {}
        self._maxsize = maxsize

    def get(self, key: Any) -> Optional[Any]:
        return self._cache.get(key)

    def put(self, key: Any, staged: Any) -> None:
        if len(self._cache) >= self._maxsize:
            self._cache.pop(next(iter(self._cache)))
        self._cache[key] = staged


_inline_cache = _InlineCache()


def _fingerprint(x: np.ndarray) -> Tuple:
    """Payload identity: shape/dtype + stable content digest.

    ``blake2b`` (not ``hash()``, which is salted per process) so the key is
    deterministic across processes and equal to the reference's.
    """
    digest = hashlib.blake2b(x.tobytes(), digest_size=16).hexdigest()
    return (x.shape, str(x.dtype), digest)


def _payload_bytes(x: np.ndarray) -> np.ndarray:
    """The array's own bytes, flat and contiguous, as uint8."""
    return np.ascontiguousarray(x.reshape(-1)).view(np.uint8)


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    if dt.name == "bfloat16":               # ml_dtypes; not a numpy type
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dt)).dtype


def _typed(raw: torch.Tensor, x: np.ndarray) -> torch.Tensor:
    """Reinterpret moved bytes as ``x``'s type and shape (no copy)."""
    return raw.view(_torch_dtype(x.dtype)).reshape(x.shape)


def _canonical(device: Optional[Any]) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _emit_transfer(session: Optional[TraceSession], rec: TransferRecord,
                   t: float) -> None:
    sess = resolve_session(session)
    if sess is not None:
        sess.emit("transfer", f"{rec.mode}_put", dur_s=rec.submit_s,
                  complete_s=rec.complete_s, payload_bytes=rec.nbytes, t=t,
                  mode=rec.mode, build_s=rec.build_s,
                  bandwidth_gib_s=rec.bandwidth_gib_s)


def _record(mode: str, nbytes: int, build_s: float, t1: float, t2: float,
            t3: float) -> TransferRecord:
    return TransferRecord(
        mode=mode, nbytes=nbytes, build_s=build_s, submit_s=t2 - t1,
        complete_s=t3 - t1,
        bandwidth_gib_s=nbytes / max(t3 - t1, 1e-12) / 2**30)


def inline_put(x: np.ndarray, device: Optional[Any] = None,
               _cache: bool = True,
               session: Optional[TraceSession] = None,
               ) -> Tuple[torch.Tensor, TransferRecord]:
    """Move ``x`` to the device via the *inline* protocol.

    The payload is baked into the parameters of captured kernel launches;
    replaying them materializes it on the device — inline DMA: the data
    travels inside the command stream and the compute path writes it out.
    ``device=None`` means ``cuda``.  The returned tensor is the cached
    materializer's output buffer (see :class:`_InlineMaterializer`).
    """
    x = np.asarray(x)
    dev = _canonical(device)
    # the destination is part of the staged launches, so it keys the cache
    key = _fingerprint(x) + (str(dev),)
    t0 = time.perf_counter()
    staged = _inline_cache.get(key) if _cache else None
    build_s = 0.0
    if staged is None:
        staged = _InlineMaterializer(_payload_bytes(x), dev)
        build_s = time.perf_counter() - t0
        if _cache:
            _inline_cache.put(key, staged)
    t1 = time.perf_counter()
    staged.dispatch()
    t2 = time.perf_counter()
    wait(dev)
    t3 = time.perf_counter()
    rec = _record("inline", x.nbytes, build_s, t1, t2, t3)
    _emit_transfer(session, rec, t=t1)
    return _typed(staged.out, x), rec


def direct_put(x: np.ndarray, device: Optional[Any] = None,
               session: Optional[TraceSession] = None,
               ) -> Tuple[torch.Tensor, TransferRecord]:
    """Move ``x`` to the device via the *direct* protocol: a host→device
    copy from pageable memory.  ``device=None`` means ``cuda``."""
    x = np.asarray(x)
    dev = _canonical(device)
    src = torch.from_numpy(_payload_bytes(x))
    t1 = time.perf_counter()
    out = src.to(dev) if dev.type == "cuda" else src.clone()
    t2 = time.perf_counter()
    wait(dev)
    t3 = time.perf_counter()
    rec = _record("direct", x.nbytes, 0.0, t1, t2, t3)
    _emit_transfer(session, rec, t=t1)
    return _typed(out, x), rec


class HybridMover:
    """Size-switched data movement with an *exposed, tunable* threshold.

    >>> mover = HybridMover(threshold=24 * 1024, device="cpu")
    >>> y, rec = mover.put(np.ones(128, np.float32))
    >>> rec.mode
    'inline'

    Payloads below ``threshold`` bytes go inline, the rest direct.
    ``threshold=None`` means :data:`INLINE_THRESHOLD_DEFAULT`: the port has
    no tuned policies yet (the reference resolves ``None`` through
    ``repro.tune.policy`` first), as the port's ``Server`` reads
    ``tokens_per_launch=None`` as 1.  Construction never touches the device;
    ``device`` (``None`` means ``cuda``) is resolved at each put.
    """

    def __init__(self, threshold: Optional[int] = None,
                 device: Optional[Any] = None,
                 session: Optional[TraceSession] = None) -> None:
        self.threshold = int(INLINE_THRESHOLD_DEFAULT if threshold is None
                             else threshold)
        self.device = device
        self.records: List[TransferRecord] = []
        self._session = session

    def put(self, x: np.ndarray) -> Tuple[torch.Tensor, TransferRecord]:
        x = np.asarray(x)
        if x.nbytes < self.threshold:
            out, rec = inline_put(x, self.device, session=self._session)
        else:
            out, rec = direct_put(x, self.device, session=self._session)
        self.records.append(rec)
        return out, rec

    def stats(self) -> Dict[str, int]:
        out = {"inline": 0, "direct": 0}
        for r in self.records:
            out[r.mode] += 1
        return out


def sweep_transfer(sizes_bytes: List[int], mode: str, iters: int = 20,
                   warmup: int = 5, dtype=np.uint8,
                   device: Optional[Any] = None) -> List[Dict[str, float]]:
    """Latency/bandwidth sweep for one protocol — Figure 6.

    For the inline path the launches are captured once per size (staging)
    and then replayed, so the measured time is the dispatch +
    materialization cost — the analogue of the paper's controlled command
    issuance measuring raw engine behaviour without per-call driver work.
    ``device=None`` means ``cuda``.
    """
    results = []
    put = inline_put if mode == "inline" else direct_put
    for nbytes in sizes_bytes:
        n = max(1, nbytes // np.dtype(dtype).itemsize)
        x = np.arange(n, dtype=np.int64).astype(dtype)
        for _ in range(warmup):
            put(x, device)
        lat = []
        for _ in range(iters):
            _, rec = put(x, device)
            lat.append(rec.complete_s)
        lat.sort()
        med = lat[len(lat) // 2]
        results.append({
            "mode": mode, "nbytes": int(x.nbytes),
            "latency_us": med * 1e6,
            "bandwidth_gib_s": x.nbytes / max(med, 1e-12) / 2**30,
        })
    return results
