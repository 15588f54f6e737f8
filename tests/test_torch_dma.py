"""The port's transfer protocols (``repro_torch.core.dma``) against the JAX
reference's (``repro.core.dma``), on the CPU.

The inline protocol's CUDA path (payload in kernel parameters, one graph
replay a put) runs only on a card: ``tests/test_torch_kernels.py`` has its
``cuda``-marked test, and ``chip_smoke.py`` phase D1 sweeps it.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import HybridMover as JaxHybridMover
from repro.core import TraceSession as JaxTraceSession
from repro.core.dma import _fingerprint as jax_fingerprint
from repro_torch.core import (INLINE_THRESHOLD_DEFAULT, HybridMover,
                              TraceSession, direct_put, inline_put,
                              sweep_transfer)
from repro_torch.core.dma import _fingerprint
from repro_torch.kernels import launches, reset_launches

# benchmarks/bench_dma.py's sizes
EXP_SIZES = [4 * (2 ** i) for i in range(13)]
LIN_SIZES = [1024 * i for i in range(1, 32, 3)]
LARGE_SIZES = [32 * 1024, 128 * 1024, 512 * 1024, 2 * 2**20, 8 * 2**20,
               32 * 2**20]

PAYLOADS = {
    "float32": np.arange(512, dtype=np.float32),
    "int32_2d": np.arange(4096, dtype=np.int32).reshape(64, 64),
    "uint8": np.random.default_rng(0).integers(0, 256, 999, dtype=np.uint8),
    "bool": np.arange(37) % 3 == 0,
    "bfloat16": np.linspace(-3, 3, 300).astype(ml_dtypes.bfloat16),
    "float16_scalar": np.array(1.5, np.float16),
    "empty": np.zeros((0, 4), np.float32),
}


@pytest.mark.parametrize("put", [inline_put, direct_put],
                         ids=["inline", "direct"])
@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_put_roundtrips_exactly(put, name):
    """Every payload moves as its own bytes: same shape, same bits, and the
    record counts the payload's size (bf16 is not widened)."""
    x = PAYLOADS[name]
    y, rec = put(x, device="cpu")
    assert tuple(y.shape) == x.shape and y.device.type == "cpu"
    assert rec.mode == put.__name__.split("_")[0]
    assert rec.nbytes == x.nbytes
    raw = np.ascontiguousarray(x.reshape(-1)).view(np.uint8)
    assert np.array_equal(y.reshape(-1).view(torch.uint8).numpy(), raw)


def test_inline_cache_stages_once_and_counts_no_launch():
    reset_launches()
    x = np.arange(77, dtype=np.int16)
    _, first = inline_put(x, device="cpu")
    _, again = inline_put(x, device="cpu")
    _, fresh = inline_put(x, device="cpu", _cache=False)
    assert first.build_s > 0 and again.build_s == 0.0 and fresh.build_s > 0
    assert launches["inline_put"] == 0        # CPU: a plain materialization


def test_hybrid_mover_threshold_switch():
    mover = HybridMover(threshold=1024, device="cpu")
    _, small = mover.put(np.zeros(16, np.float32))      # 64 B
    _, large = mover.put(np.zeros(4096, np.float32))    # 16 KiB
    assert small.mode == "inline"
    assert large.mode == "direct"
    assert mover.stats() == {"inline": 1, "direct": 1}


def test_hybrid_mover_direct_at_exact_threshold():
    """The switch is direct at nbytes == threshold (inline strictly below)."""
    mover = HybridMover(threshold=1024, device="cpu")
    _, below = mover.put(np.zeros(1023, np.uint8))
    _, at = mover.put(np.zeros(1024, np.uint8))
    assert below.mode == "inline"
    assert at.mode == "direct"


def test_threshold_is_tunable():
    always_direct = HybridMover(threshold=0, device="cpu")
    assert always_direct.put(np.zeros(4, np.uint8))[1].mode == "direct"
    always_inline = HybridMover(threshold=1 << 40, device="cpu")
    assert always_inline.put(np.zeros(1 << 16, np.uint8))[1].mode == "inline"
    assert HybridMover().threshold == INLINE_THRESHOLD_DEFAULT == 24 * 1024


@pytest.mark.parametrize("x", [np.arange(16, dtype=np.int32),
                               np.ones((3, 5), np.float64),
                               PAYLOADS["bfloat16"], PAYLOADS["bool"],
                               PAYLOADS["empty"]],
                         ids=["int32", "float64_2d", "bfloat16", "bool",
                              "empty"])
def test_fingerprint_equals_reference(x):
    assert _fingerprint(x) == jax_fingerprint(x)
    assert _fingerprint(x) == _fingerprint(x.copy())


def test_sweep_shapes():
    out = sweep_transfer([64, 1024], mode="direct", iters=3, warmup=1,
                         device="cpu")
    assert [r["nbytes"] for r in out] == [64, 1024]
    assert all(r["mode"] == "direct" and r["latency_us"] > 0
               and r["bandwidth_gib_s"] > 0 for r in out)
    out = sweep_transfer([6, 100], mode="inline", iters=2, warmup=1,
                         dtype=np.float32, device="cpu")
    assert [r["nbytes"] for r in out] == [4, 100]        # whole elements


def test_every_put_lands_one_transfer_event():
    with TraceSession("dma") as sess:
        sweep_transfer([8, 64], mode="inline", iters=3, warmup=2,
                       device="cpu")
        sweep_transfer([8], mode="direct", iters=2, warmup=1, device="cpu")
    evs = sess.timeline(kinds="transfer")
    assert len(evs) == 2 * 5 + 3
    assert [e.name for e in evs] == ["inline_put"] * 10 + ["direct_put"] * 3
    assert [e.payload_bytes for e in evs[:10]] == [8] * 5 + [64] * 5
    assert all({"mode", "build_s", "bandwidth_gib_s"} <= set(e.meta)
               for e in evs)


def test_mover_mode_sequence_matches_reference():
    """Over bench_dma.py's sizes both packages' default movers pick the same
    protocol for every payload."""
    ours, theirs = HybridMover(device="cpu"), JaxHybridMover()
    sizes = EXP_SIZES + LIN_SIZES + LARGE_SIZES[:4] + [24 * 1024 - 1,
                                                       24 * 1024]
    ours_modes = [ours.put(np.zeros(n, np.uint8))[1].mode for n in sizes]
    theirs_modes = [theirs.put(np.zeros(n, np.uint8))[1].mode for n in sizes]
    assert ours_modes == theirs_modes
    assert ours_modes == ["inline" if n < 24 * 1024 else "direct"
                          for n in sizes]
    assert ours.stats() == theirs.stats()


def test_session_put_mixed_sequence_matches_reference():
    """tests/test_session.py's mixed sequence (without the capture facade,
    which the port does not have yet): the same kinds, names and payload
    bytes in both packages."""
    def run(sess_cls, ones, zeros, f):
        with sess_cls("mix") as sess:
            if sess_cls is TraceSession:
                sess.mover.device = "cpu"
            g = sess.wrap(f, "f_dispatch")
            g(ones(4))
            sess.put(zeros(8))
            g(ones(4))
            tok = sess.progress.release(ones(2))
            sess.progress.wait(tok)
        evs = sess.timeline()
        assert [e.seq for e in evs] == list(range(len(evs)))
        return [(e.kind, e.name, e.payload_bytes) for e in evs]

    ours = run(TraceSession, torch.ones, lambda n: np.zeros(n, np.float32),
               lambda x: x * 2)
    theirs = run(JaxTraceSession, jnp.ones,
                 lambda n: np.zeros(n, np.float32), lambda x: x * 2)
    assert ours == theirs
    assert [k for k, _, _ in ours] == ["dispatch", "transfer", "dispatch",
                                      "progress", "progress"]


def test_no_device_means_cuda_and_raises_without_one(monkeypatch):
    """Construction never touches the device; a put without a device runs on
    cuda, and raises without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sess = TraceSession("no-card")
    mover = HybridMover()
    x = np.zeros(8, np.uint8)
    for put in (inline_put, direct_put, mover.put, sess.put):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            put(x)
    assert sess.n_events == 0 and mover.records == []
