#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. print the card (``nvidia-smi --query-gpu=name,power.limit``) and the
   torch/CUDA versions;
2. build the hand-written kernels (``src/repro_torch/kernels/csrc``) with
   ``nvcc`` for ``sm_90a``;
3. hold each kernel against its plain PyTorch version on the card, at the
   reference's tolerances (RMSNorm 2e-5 f32 / 2e-2 bf16, flash attention
   3e-5 / 3e-2, SSD scan 1e-3 / 6e-2; ``tests/test_kernels.py``), at the
   paths' shapes and at ragged ones;

then the paper's DMA case study (section 6.2):

D1. host->device transfers: ``sweep_transfer`` over the sizes of
    ``benchmarks/bench_dma.py`` (4 B-16 KiB by powers of two, 1-31 KiB by
    3 KiB; 32 KiB-32 MiB for direct only) for the inline protocol (payload
    carried in kernel parameters, one CUDA-graph replay a put) and the direct
    one (pageable ``cudaMemcpy``): every put round-trips exactly and lands
    one ``transfer`` event; latency and GiB/s per size (Figure 6), and
    whether the direct path shows a knee at 24 KiB; then ``HybridMover()``
    over the same sizes, inline below 24 KiB and direct above;
D2. the two DMA-copy kernels (pipelined, explicit TMA) held byte for byte
    against the plain tiled copy at the reference's test shapes (f32, bf16,
    int8), at tiles whose offsets are not multiples of 16, and at the path
    shape, [32768, 4096] bf16 (256 MiB); then the path: each copy at
    block_rows 8, 32, 128 and 256 bracketed by ``ProgressTracker`` releases
    on one session (counts zeroed just before, read just after), and the
    brackets held against torch.profiler's device time;

then, for each serving path, gemma-2b (dense, flash attention) and
mamba2-780m (SSD scan), both at full published width:

4. build the model from the port's seeded on-device init;
5. serve 4 ragged requests through ``Server.serve`` at tokens_per_launch 1
   and 4 (the main path): tokens equal, doorbells ``1 + ceil(31 / T)``, and
   the path's kernels launched during each serve (counts zeroed just before
   each serve and read just after);
6. hold the kernel route (``impl="cuda"``) against the plain route
   (``impl="ref"``) on the same weights: bf16 prefill logits, then the fp32
   variant's prefill logits and 8 greedy tokens.  The routes differ in the
   prefill's kernel (flash attention vs dense softmax; SSD kernel vs plain
   chunked scan); every norm goes through the RMSNorm kernel on both, which
   phase 3 holds against its plain version;
7. time the path (prefill, decode, tokens/s, device time by kernel);

and last, time each kernel at its path's shape beside its bound, its plain
version and one library call where there is one (the DMA-copy kernels are
timed in D2).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the
script exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import ARCHS, ModelConfig  # noqa: E402
from repro_torch.core import (H100_SXM, INLINE_THRESHOLD_DEFAULT,  # noqa: E402
                              HybridMover, TraceSession, direct_put,
                              inline_put, sweep_transfer)
from repro_torch.kernels import _build, launches, reset_launches  # noqa: E402
from repro_torch.kernels.dma_copy.ops import MODES, dma_copy  # noqa: E402
from repro_torch.kernels.dma_copy.ref import dma_copy_tiled  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.rms_norm.ops import rms_norm  # noqa: E402
from repro_torch.kernels.rms_norm.ref import rms_norm_ref  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import mamba as mamba_block_module  # noqa: E402
from repro_torch.runtime.server import Request, Server  # noqa: E402

TOL = {"rms_norm": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
       "flash_attention": {torch.float32: 3e-5, torch.bfloat16: 3e-2},
       "ssd_scan": {torch.float32: 1e-3, torch.bfloat16: 6e-2}}
NEW_TOKENS = 32


@dataclasses.dataclass(frozen=True)
class ServePath:
    """One serving path: 4 ragged prompts, left-padded to the longest."""
    arch: str
    prompt_lens: Tuple[int, ...]
    max_seq: int
    kernels: Tuple[str, ...]       # each launched in every serve
    # bf16 kernel route vs plain route, relative L2 error of prefill logits
    bf16_rel_tol: float
    # fp32 kernel route vs plain route, max |err| of prefill logits
    fp32_abs_tol: float
    # config fields of a control: the plain route with these fields changed
    # computes the same function with other roundings.  The bf16 kernel
    # route may then differ from the plain route by CONTROL_FACTOR times as
    # much as the control does, if that is more than bf16_rel_tol.
    control: Optional[Dict[str, Any]] = None


# gemma-2b: prompts left-padded to 255.  The routes differ only in attention
# arithmetic (fp32 probabilities in the kernel, bf16 in the dense route), a
# few bf16 roundings (2^-8) per layer; in fp32 both round at fp32 precision
# and 18 layers leave ~1e-5.
GEMMA = ServePath("gemma-2b", (61, 128, 200, 255), 512,
                  ("rms_norm", "flash_attention"), 3e-2, 1e-3)
# mamba2-780m: prompts left-padded to 1024, four chunks of 256, so the state
# is carried across chunks.  The routes differ only in the order of the
# scan's fp32 sums; in bf16 that flips a rounding of y (2^-8) here and
# there, and 48 layers of random weights amplify such flips to ~5e-2 on an
# H100 (PERF.md), above a fixed 3e-2.  The control halves the chunk: the
# same scan, exact in real arithmetic, with other roundings.  In fp32 the
# routes leave ~1e-5.
MAMBA = ServePath("mamba2-780m", (257, 512, 800, 1024), 1056,
                  ("rms_norm", "ssd_scan"), 3e-2, 1e-3,
                  control={"ssm_chunk": 128})
CONTROL_FACTOR = 3.0
PATHS = (GEMMA, MAMBA)

# D1: benchmarks/bench_dma.py's sizes (Figure 6; Table 2's right half)
EXP_SIZES = [4 * 2**i for i in range(13)]               # 4 B .. 16 KiB
LIN_SIZES = [1024 * i for i in range(1, 32, 3)]         # 1 KiB .. 31 KiB
LARGE_SIZES = [32 * 1024, 128 * 1024, 512 * 1024, 2 * 2**20, 8 * 2**20,
               32 * 2**20]
TRANSFER_ITERS, TRANSFER_WARMUP = 20, 5
# D2: (R, C, block_rows, dtype): tests/test_kernels.py's shapes and types,
# then tiles whose offsets are not multiples of 16 bytes (int8 [99, 37] in
# tiles of 3 rows, 111 bytes; bf16 [60, 7] in tiles of 4 rows, 56 bytes) and
# int8 [96, 33] in tiles of 32 rows (1056 bytes, aligned)
COPY_CASES = [(R, C, blk, dt) for R, C, blk in ((256, 64, 64), (1024, 128, 256),
                                                (128, 32, 128))
              for dt in (torch.float32, torch.bfloat16, torch.int8)] + [
    (96, 33, 32, torch.int8), (99, 37, 3, torch.int8), (60, 7, 4, torch.bfloat16)]
DMA_SHAPE = (32768, 4096)            # bf16: 256 MiB
DMA_DTYPE = torch.bfloat16
DMA_BLOCK_ROWS = 256                 # the reference's default
DMA_TILES = (8, 32, 128, 256)
DMA_REPS = 20
# a ProgressTracker bracket spans everything the stream runs between two
# releases (the copies, the gaps between their launches, the second fence's
# small kernels); torch.profiler sums the copy kernels alone
BRACKET_TOL = 0.15


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def time_ms(fn: Callable[[], Any], reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------- phase 1
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


# ---------------------------------------------------------------- phase 2
def build_kernels() -> None:
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s: {lib}")
    for line in lib.with_suffix(".so.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas: " + line.strip())


# ---------------------------------------------------------------- phase 3
def rms_inputs(rows: int, D: int, dtype: torch.dtype, device: torch.device,
               seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(rows, D, generator=g, device=device).to(dtype)
    s = (torch.randn(D, generator=g, device=device) * 0.1).to(dtype)
    return x, s


def flash_inputs(B: int, S: int, H: int, Hkv: int, hd: int,
                 dtype: torch.dtype, device: torch.device, seed: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(B, S, H, hd, generator=g, device=device).to(dtype)
    k = torch.randn(B, S, Hkv, hd, generator=g, device=device).to(dtype)
    v = torch.randn(B, S, Hkv, hd, generator=g, device=device).to(dtype)
    return q, k, v


def ssd_inputs(B: int, S: int, H: int, P: int, N: int, dtype: torch.dtype,
               device: torch.device, seed: int = 0):
    """x, B, C ~ N(0, 1) in ``dtype``; dt = |N(0, 1)| and A = -|N(0, 1)| in
    fp32, as the reference's sweep draws them."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)
    return (randn(B, S, H, P).to(dtype), randn(B, S, H).abs(),
            -randn(H).abs(), randn(B, S, N).to(dtype), randn(B, S, N).to(dtype))


def check_kernels(device: torch.device) -> None:
    dtypes = (torch.bfloat16, torch.float32)
    # the paths' shapes (gemma D=2048; mamba D=1536 and 3072, 4096 prefill
    # rows), plus rows wide enough for 4, 8 and 16 vectors a thread
    for rows, D in ((4, 2048), (1020, 2048), (1020, 256), (5, 8192),
                    (7, 16384), (4, 1536), (4096, 1536), (4, 3072),
                    (4096, 3072)):
        for dtype in dtypes:
            x, s = rms_inputs(rows, D, dtype, device)
            out, ref = rms_norm(x, s), rms_norm_ref(x, s)
            tol = TOL["rms_norm"][dtype]
            torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                       atol=tol)
            log(f"rms_norm rows={rows} D={D} {dtype}: max|err| "
                f"{max_err(out, ref):.3e} (tol {tol})")
    cases = [(S, Hkv, 256) for S in (255, 256, 1024) for Hkv in (1, 8)]
    cases += [(384, Hkv, hd) for hd in (64, 128) for Hkv in (1, 8)]
    for S, Hkv, hd in cases:
        for causal in (True, False):
            for dtype in dtypes:
                q, k, v = flash_inputs(4, S, 8, Hkv, hd, dtype, device)
                out = flash_attention(q, k, v, causal=causal)
                ref = flash_attention_ref(q, k, v, causal=causal)
                tol = TOL["flash_attention"][dtype]
                torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                           atol=tol)
                log(f"flash B=4 S={S} H=8 Hkv={Hkv} hd={hd} causal={causal} "
                    f"{dtype}: max|err| {max_err(out, ref):.3e} (tol {tol})")
    # (B, S, H, P, N, chunk): the mamba path's shape; one ragged chunk
    # (Q = S = 255); small chunks (Q = 16); H = 3; P < 64 and N < 128
    for B, S, H, P, N, chunk in ((4, 1024, 48, 64, 128, 256),
                                 (4, 255, 48, 64, 128, 256),
                                 (4, 64, 48, 64, 128, 16),
                                 (2, 512, 3, 64, 128, 256),
                                 (2, 96, 5, 16, 8, 32)):
        for dtype in dtypes:
            args = ssd_inputs(B, S, H, P, N, dtype, device)
            out, none = ssd_scan(*args, chunk=chunk)
            ref, _ = ssd_chunked(*args, chunk=min(chunk, S))
            tol = TOL["ssd_scan"][dtype]
            if none is not None or not torch.isfinite(out).all():
                raise AssertionError("ssd_scan: non-finite y or a state")
            torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                       atol=tol)
            log(f"ssd_scan B={B} S={S} H={H} P={P} N={N} chunk="
                f"{min(chunk, S)} {dtype}: max|err| {max_err(out, ref):.3e} "
                f"(rtol=atol={tol}), max|y| "
                f"{ref.float().abs().max().item():.2f}")
    if device.type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------- DMA path
def random_bytes(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8)


def direct_knee(rows: List[Dict[str, float]]) -> Dict[str, Any]:
    """The direct path's latency step across 24 KiB (22 -> 25 KiB) against
    the median of its other 3 KiB steps; a knee shows if it is more than 3x
    that median and more than 1 us."""
    by_size = {r["nbytes"]: r["latency_us"] for r in rows}
    lat = [by_size[n] for n in LIN_SIZES]
    steps = [b - a for a, b in zip(lat, lat[1:])]
    at = steps.pop(next(i for i, n in enumerate(LIN_SIZES)
                        if n >= INLINE_THRESHOLD_DEFAULT) - 1)
    med = sorted(map(abs, steps))[len(steps) // 2]
    return {"step_us": at, "median_step_us": med,
            "knee": at > max(3 * med, 1.0)}


def transfers(card: str, device: torch.device) -> None:
    """D1.  Every put goes through one session."""
    sizes = {"inline": EXP_SIZES + LIN_SIZES,
             "direct": EXP_SIZES + LIN_SIZES + LARGE_SIZES}
    sweeps: Dict[str, Any] = {}
    puts = 0
    reset_launches()
    with TraceSession("dma.transfers") as sess:
        for mode, put in (("inline", inline_put), ("direct", direct_put)):
            for n in sizes[mode]:
                x = random_bytes(n, seed=n)
                y, rec = put(x, device)
                puts += 1
                if (rec.mode != mode or rec.nbytes != n
                        or not torch.equal(y.cpu(), torch.from_numpy(x))):
                    raise AssertionError(f"{mode}_put of {n} B did not "
                                         f"round-trip")
            rows = sweep_transfer(sizes[mode], mode, iters=TRANSFER_ITERS,
                                  warmup=TRANSFER_WARMUP, device=device)
            puts += len(rows) * (TRANSFER_ITERS + TRANSFER_WARMUP)
            for r in rows:
                log(f"{card} | {mode}_put {r['nbytes']:>8d} B: median "
                    f"{r['latency_us']:9.3f} us, {r['bandwidth_gib_s']:9.4f} "
                    f"GiB/s")
            sweeps[mode] = rows
        mover = HybridMover(device=device)
        want = []
        for n in sizes["direct"]:
            x = random_bytes(n, seed=n + 1)
            y, rec = mover.put(x)
            puts += 1
            want.append("inline" if n < INLINE_THRESHOLD_DEFAULT else "direct")
            if rec.mode != want[-1] or not torch.equal(y.cpu(),
                                                       torch.from_numpy(x)):
                raise AssertionError(f"HybridMover put of {n} B: mode "
                                     f"{rec.mode}, expected {want[-1]}, or "
                                     f"no round trip")
        stats = mover.stats()
        if stats != {m: want.count(m) for m in ("inline", "direct")}:
            raise AssertionError(f"HybridMover stats {stats} disagree with "
                                 f"its puts {want}")
        events = sess.summary()["by_kind"].get("transfer", 0)
    if events != puts:
        raise AssertionError(f"{puts} puts landed {events} transfer events")
    if device.type == "cuda" and launches["inline_put"] < 1:
        raise AssertionError("the inline materializer was not launched")
    knee = direct_knee(sweeps["direct"])
    log(f"{card} | direct latency step 22 -> 25 KiB {knee['step_us']:.3f} us "
        f"against a median 3 KiB step of {knee['median_step_us']:.3f} us: "
        f"knee at 24 KiB {'shows' if knee['knee'] else 'does not show'}")
    log(f"D1: {puts} puts, {events} transfer events, {launches['inline_put']}"
        f" inline graph replays; HybridMover {stats}")


def copy_input(R: int, C: int, dtype: torch.dtype, device: torch.device,
               seed: int = 0) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    if dtype == torch.int8:
        return torch.randint(-128, 128, (R, C), generator=g, device=device,
                             dtype=torch.int8)
    return torch.randn(R, C, generator=g, device=device).to(dtype)


def same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.uint8),
                                              b.view(torch.uint8))


def copy_checks(device: torch.device) -> None:
    """D2: both kernels byte for byte against the plain tiled copy."""
    cases = COPY_CASES + [(*DMA_SHAPE, blk, DMA_DTYPE) for blk in DMA_TILES]
    for R, C, blk, dtype in cases:
        x = copy_input(R, C, dtype, device)
        ref = dma_copy_tiled(x, min(blk, R))
        if not same_bytes(ref, x):
            raise AssertionError("the plain tiled copy is not the identity")
        for mode in MODES:
            if not same_bytes(dma_copy(x, mode, blk), ref):
                raise AssertionError(f"dma_copy {mode} [{R}, {C}] {dtype} "
                                     f"block_rows={blk} differs from the "
                                     f"plain copy")
        log(f"dma_copy [{R}, {C}] {dtype} block_rows={blk}: both modes equal "
            f"the plain tiled copy, byte for byte")
    if device.type == "cuda":
        torch.cuda.synchronize()


def copy_path(card: str, device: torch.device) -> List[Dict[str, Any]]:
    """D2's path: the controlled-DMA benchmark on one session, then the
    kernels' entries at the path shape."""
    R, C = DMA_SHAPE
    x = copy_input(R, C, DMA_DTYPE, device, seed=1)
    nbytes = 2 * x.numel() * x.element_size()
    bracket: Dict[Tuple[str, int], float] = {}
    reset_launches()
    with TraceSession("dma.copy") as sess:
        for blk in DMA_TILES:
            for mode in MODES:
                y = dma_copy(x, mode, blk)              # warm-up
                a = sess.progress.release(y)
                for _ in range(DMA_REPS):
                    y = dma_copy(x, mode, blk)
                b = sess.progress.release(y)
                bracket[mode, blk] = sess.progress.elapsed(a, b) / DMA_REPS * 1e3
                if not same_bytes(y, x):
                    raise AssertionError(f"dma_copy {mode} block_rows={blk}: "
                                         f"the path's copy differs from x")
    counts = {m: launches[f"dma_copy_{m}"] for m in MODES}
    want = len(DMA_TILES) * (DMA_REPS + 1) if device.type == "cuda" else 0
    if any(c != want for c in counts.values()):
        raise AssertionError(f"dma_copy launches {counts} in the path, "
                             f"expected {want} each")
    bound = roofline(nbytes, 0)
    prof = {}
    for blk in DMA_TILES:
        for mode in MODES:
            prof[mode, blk] = ms = device_ms(lambda: dma_copy(x, mode, blk))
            br = bracket[mode, blk]
            log(f"{card} | dma_copy_{mode} [{R}, {C}] bf16 block_rows={blk}: "
                f"{ms:.5f} ms (profiler), {br:.5f} ms (semaphore bracket), "
                f"{bound['bound_ms'] / ms:.1%} of the {bound['bound_ms']:.5f} "
                f"ms bound, {nbytes / ms / 1e6:.1f} GB/s read+written")
            if abs(br - ms) > BRACKET_TOL * ms:
                raise AssertionError(f"semaphore bracket {br:.5f} ms and "
                                     f"profiler {ms:.5f} ms disagree by more "
                                     f"than {BRACKET_TOL:.0%}")
    plain_ms = device_ms(lambda: dma_copy_tiled(x, DMA_BLOCK_ROWS), reps=5)
    library_ms = device_ms(lambda: torch.empty_like(x).copy_(x))
    log(f"{card} | plain tiled copy (block_rows={DMA_BLOCK_ROWS}) "
        f"{plain_ms:.5f} ms; torch.empty_like(x).copy_(x) {library_ms:.5f} ms")
    entries = []
    for mode, line in (("pipelined", 36), ("explicit", 64)):
        out = dma_copy(x, mode, DMA_BLOCK_ROWS)
        entries.append({
            "name": f"dma_copy_{mode}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dma_copy.cu",
            "replaces": f"src/repro/kernels/dma_copy/kernel.py:{line}",
            "max_abs_err": max_err(out, dma_copy_tiled(x, DMA_BLOCK_ROWS)),
            "ms": prof[mode, DMA_BLOCK_ROWS],
            "plain_ms": plain_ms,
            "call_ms": time_ms(lambda: dma_copy(x, mode, DMA_BLOCK_ROWS)),
            **bound,
            "library_ms": library_ms,
            "shape": f"R={R} C={C} bf16 block_rows={DMA_BLOCK_ROWS}",
            "bracket_ms": bracket[mode, DMA_BLOCK_ROWS],
            "tiles_ms": {str(blk): prof[mode, blk] for blk in DMA_TILES},
            "launches_by_path": {"dma": counts[mode]},
            "launches": counts[mode]})
        del out
    del x, y
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------- phase 5
def requests(path: ServePath, vocab: int, seed: int = 0) -> List[Request]:
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, vocab, size=n).astype(np.int32),
                    max_new_tokens=NEW_TOKENS)
            for i, n in enumerate(path.prompt_lens)]


def padded_prompts(reqs: List[Request], device: torch.device) -> torch.Tensor:
    S = max(len(r.prompt) for r in reqs)
    toks = np.zeros((len(reqs), S), np.int32)
    for i, r in enumerate(reqs):
        toks[i, S - len(r.prompt):] = r.prompt
    return torch.from_numpy(toks).to(device)


def serve_main_path(path: ServePath, cfg: ModelConfig, params,
                    device: torch.device
                    ) -> Dict[int, Tuple[Dict[str, Any], Dict[str, int], list]]:
    """Serve at T=1 and T=4; counters are zeroed just before each serve."""
    runs = {}
    for T in (1, 4):
        srv = Server(cfg, batch_size=len(path.prompt_lens),
                     max_seq=path.max_seq, tokens_per_launch=T, device=device,
                     params=params)
        reqs = requests(path, cfg.vocab_size)
        reset_launches()
        metrics = srv.serve(reqs)
        counts = dict(launches)
        runs[T] = (metrics, counts, [r.tokens for r in reqs])
        log(f"{cfg.name} serve T={T}: {metrics} kernel launches {counts}")
    if runs[1][2] != runs[4][2]:
        raise AssertionError(f"{cfg.name}: tokens differ between T=1 and T=4")
    for T, (m, c, toks) in runs.items():
        want = 1 + math.ceil((NEW_TOKENS - 1) / T)
        if m["doorbells"] != want:
            raise AssertionError(f"{cfg.name} T={T}: {m['doorbells']} "
                                 f"doorbells, expected {want}")
        for name in path.kernels:
            if c.get(name, 0) < 1:
                raise AssertionError(f"{cfg.name} T={T}: kernel {name} was "
                                     f"not launched")
        if any(len(t) != NEW_TOKENS or not all(0 <= x < cfg.vocab_size
                                               for x in t) for t in toks):
            raise AssertionError(f"{cfg.name} T={T}: tokens out of range or "
                                 f"short")
    return runs


# ---------------------------------------------------------------- phase 6
def greedy(model, params, toks: torch.Tensor, n: int, max_seq: int
           ) -> Tuple[torch.Tensor, List[List[int]]]:
    state, logits = model.prefill(params, toks, max_seq)
    first = logits
    out = []
    for _ in range(n):
        nxt = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
        out.append(nxt[:, 0])
        if len(out) < n:
            state, logits = model.decode_step(params, state, nxt)
    return first, torch.stack(out, dim=1).tolist()


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@contextlib.contextmanager
def ssd_held_to_plain(errors: List[Tuple[float, float]]) -> Iterator[None]:
    """While open, every SSD-kernel call of the Mamba block is also run
    through the plain version on the same inputs; each call's max |err| and
    the largest |y| are appended to ``errors``."""
    kernel = mamba_block_module.ssd_scan

    def held(xh, dt, A, Bc, Cc, chunk):
        y, none = kernel(xh, dt, A, Bc, Cc, chunk=chunk)
        ref, _ = ssd_chunked(xh, dt, A, Bc, Cc, min(chunk, xh.shape[1]))
        tol = TOL["ssd_scan"][xh.dtype]
        torch.testing.assert_close(y.float(), ref.float(), rtol=tol, atol=tol)
        errors.append((max_err(y, ref), ref.float().abs().max().item()))
        return y, none

    mamba_block_module.ssd_scan = held
    try:
        yield
    finally:
        mamba_block_module.ssd_scan = kernel


def compare_routes(path: ServePath, cfg: ModelConfig, params,
                   device: torch.device, seed: int = 0) -> Dict[str, float]:
    """Kernel route against plain route; every reading is logged before any
    check fails."""
    toks = padded_prompts(requests(path, cfg.vocab_size), device)
    kern = get_model(cfg, impl="cuda", device=device)
    plain = get_model(cfg, impl="ref", device=device)
    ssd_errors: List[Tuple[float, float]] = []
    with ssd_held_to_plain(ssd_errors):
        _, lk = kern.prefill(params, toks, path.max_seq)
    if ssd_errors:
        worst = max(ssd_errors)
        log(f"{cfg.name} ssd_scan held to its plain version on each layer's "
            f"own inputs: {len(ssd_errors)} layers, max|err| {worst[0]:.3e} "
            f"(|y| up to {max(m for _, m in ssd_errors):.2f}; rtol=atol="
            f"{TOL['ssd_scan'][getattr(torch, cfg.param_dtype)]})")
    _, lp = plain.prefill(params, toks, path.max_seq)
    if not (torch.isfinite(lk).all() and lk.shape == (toks.shape[0], 1,
                                                       cfg.vocab_padded)):
        raise AssertionError(f"bf16 prefill logits: shape {tuple(lk.shape)} "
                             f"or non-finite values")
    rel = rel_l2(lk, lp)
    limit = path.bf16_rel_tol
    out = {"bf16_logits_rel_l2": rel}
    if path.control:
        ctrl = get_model(dataclasses.replace(cfg, **path.control), impl="ref",
                         device=device)
        _, lc = ctrl.prefill(params, toks, path.max_seq)
        out["bf16_control_rel_l2"] = rel_c = rel_l2(lc, lp)
        limit = max(limit, CONTROL_FACTOR * rel_c)
        log(f"{cfg.name} bf16 prefill logits, control (plain route with "
            f"{path.control}) vs plain route: relative L2 {rel_c:.3e}, "
            f"max|err| {max_err(lc, lp):.3e}")
        del lc
    log(f"{cfg.name} bf16 prefill logits, kernel vs plain route: relative L2 "
        f"{rel:.3e} (limit {limit:.3e}), max|err| {max_err(lk, lp):.3e}")
    del lk, lp

    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    kern32 = get_model(cfg32, impl="cuda", device=device)
    plain32 = get_model(cfg32, impl="ref", device=device)
    params32 = kern32.init_params(seed)
    lk, tk = greedy(kern32, params32, toks, 8, path.max_seq)
    lp, tp = greedy(plain32, params32, toks, 8, path.max_seq)
    out["fp32_logits_max_err"] = err = max_err(lk, lp)
    log(f"{cfg.name} fp32 prefill logits max|err| {err:.3e} (tol "
        f"{path.fp32_abs_tol}); greedy tokens kernel {tk} plain {tp}")
    if rel > limit:
        raise AssertionError("bf16 prefill logits disagree between routes")
    if err > path.fp32_abs_tol or tk != tp:
        raise AssertionError("fp32 routes disagree")
    return out


# ---------------------------------------------------------------- phase 7
def _profile(fn: Callable[[], Any], reps: int = 1):
    """Kernel rows of torch.profiler over ``reps`` calls of ``fn`` (after one
    warm-up call), and the host wall time of the window in us."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return rows, wall_us


def device_ms(fn: Callable[[], Any], reps: int = 20) -> float:
    """Device time per call: the kernels' own time, without host gaps."""
    rows, _ = _profile(fn, reps)
    if not rows:
        raise RuntimeError("torch.profiler recorded no kernel on the card")
    return sum(e.self_device_time_total for e in rows) / reps / 1e3


def profile_window(fn: Callable[[], Any], label: str, top: int = 8) -> None:
    """Device time by kernel over one call of ``fn``, and the device's busy
    share of the window's wall time (one stream: kernels do not overlap)."""
    rows, wall_us = _profile(fn)
    busy_us = sum(e.self_device_time_total for e in rows)
    log(f"{label}: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f}"
        f" ms ({busy_us / wall_us:.1%}), {sum(e.count for e in rows)} kernel "
        f"launches")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")


def time_path(path: ServePath, cfg: ModelConfig, params,
              device: torch.device) -> Dict[str, float]:
    model = get_model(cfg, impl="cuda", device=device)
    toks = padded_prompts(requests(path, cfg.vocab_size), device)
    prefill_ms = time_ms(lambda: model.prefill(params, toks, path.max_seq),
                         reps=5)
    state, logits = model.prefill(params, toks, path.max_seq)
    nxt = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
    step = {"state": state}

    def one_step():
        step["state"], _ = model.decode_step(params, step["state"], nxt)
    decode_ms = time_ms(one_step, reps=16, warmup=2)
    profile_window(lambda: model.prefill(params, toks, path.max_seq),
                   f"{cfg.name} prefill profile")
    profile_window(one_step, f"{cfg.name} decode step profile")
    srv = Server(cfg, batch_size=len(path.prompt_lens), max_seq=path.max_seq,
                 tokens_per_launch=1, device=device, params=params)
    m = srv.serve(requests(path, cfg.vocab_size))
    return {"prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
            "serve_wall_s": m["wall_s"],
            "tokens_per_s": m["new_tokens"] / m["wall_s"]}


def drive_path(path: ServePath, card: str, device: torch.device
               ) -> Dict[int, Dict[str, int]]:
    """Phases 4-7 for one path; returns the kernel launches of its T=1 and
    T=4 serves."""
    log(f"phase 4: {path.arch} at full width, seeded on-device init")
    cfg = ARCHS[path.arch]
    params = get_model(cfg, impl="cuda", device=device).init_params(seed=0)
    leaves = _leaves(params)
    log(f"{cfg.name}: {sum(t.numel() for t in leaves) / 1e9:.3f} B parameters, "
        f"{sum(t.numel() * t.element_size() for t in leaves) / 1e9:.2f} GB "
        f"({cfg.param_dtype}, fp32 where the reference keeps fp32)")
    log(f"phase 5: {path.arch} Server.serve, the main path")
    runs = serve_main_path(path, cfg, params, device)
    log(f"phase 6: {path.arch} kernel route against the plain route")
    compare_routes(path, cfg, params, device)
    log(f"phase 7: {path.arch} timings")
    t = time_path(path, cfg, params, device)
    B = len(path.prompt_lens)
    log(f"{card} | {cfg.name} B={B} prompts {path.prompt_lens} new "
        f"{NEW_TOKENS}: prefill {t['prefill_ms']:.3f} ms, decode "
        f"{t['decode_ms_per_step']:.3f} ms/step ({B} tokens), "
        f"{t['tokens_per_s']:.1f} tokens/s (serve wall "
        f"{t['serve_wall_s']:.3f} s, T=1)")
    del params, leaves
    torch.cuda.empty_cache()
    return {T: counts for T, (_, counts, _) in runs.items()}


# ---------------------------------------------------------------- kernels
def roofline(nbytes: int, flops: int) -> Dict[str, Any]:
    """Bound of bf16 work on one H100 SXM (NVIDIA's published peaks)."""
    byte_s, flop_s = nbytes / H100_SXM.hbm_bw, flops / H100_SXM.peak_flops
    return {"bound_ms": max(byte_s, flop_s) * 1e3,
            "bound_by": "bytes" if byte_s >= flop_s else "operations"}


def rms_entry(device: torch.device) -> Dict[str, Any]:
    rows, D, dtype = len(GEMMA.prompt_lens) * max(GEMMA.prompt_lens), 2048, \
        torch.bfloat16
    x, s = rms_inputs(rows, D, dtype, device, seed=1)
    err = max_err(rms_norm(x, s), rms_norm_ref(x, s))
    item = x.element_size()
    library_ms = None
    if hasattr(F, "rms_norm"):
        w = (1.0 + s.float()).to(dtype)
        library_ms = device_ms(lambda: F.rms_norm(x, (D,), w, 1e-6))
    return {"name": "rms_norm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rms_norm.cu",
            "replaces": "src/repro/kernels/rms_norm/kernel.py:31",
            "max_abs_err": err,
            "ms": device_ms(lambda: rms_norm(x, s)),
            "plain_ms": device_ms(lambda: rms_norm_ref(x, s)),
            "call_ms": time_ms(lambda: rms_norm(x, s), reps=100),
            **roofline(2 * rows * D * item + D * item, 0),
            "library_ms": library_ms,
            "shape": f"rows={rows} D={D} bf16 (gemma-2b prefill)"}


def flash_entry(device: torch.device) -> Dict[str, Any]:
    cfg = ARCHS[GEMMA.arch]
    B, S, H, Hkv, hd = (len(GEMMA.prompt_lens), max(GEMMA.prompt_lens),
                        cfg.n_heads, cfg.n_kv_heads, cfg.hd)
    dtype = torch.bfloat16
    q, k, v = flash_inputs(B, S, H, Hkv, hd, dtype, device, seed=1)
    err = max_err(flash_attention(q, k, v), flash_attention_ref(q, k, v))
    item = q.element_size()
    nbytes = (2 * B * S * H * hd + 2 * B * S * Hkv * hd) * item
    flops = 4 * B * H * hd * S * (S + 1) // 2     # causal pairs only
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:77",
            "max_abs_err": err,
            "ms": device_ms(lambda: flash_attention(q, k, v)),
            "plain_ms": device_ms(lambda: flash_attention_ref(q, k, v)),
            "call_ms": time_ms(lambda: flash_attention(q, k, v), reps=50),
            **roofline(nbytes, flops),
            "library_ms": library_ms,
            "shape": f"B={B} S={S} H={H} Hkv={Hkv} hd={hd} causal bf16"}


def ssd_entry(device: torch.device) -> Dict[str, Any]:
    cfg = ARCHS[MAMBA.arch]
    B, S, H, P, N, Q = (len(MAMBA.prompt_lens), max(MAMBA.prompt_lens),
                        cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                        cfg.ssm_chunk)
    dtype = torch.bfloat16
    args = ssd_inputs(B, S, H, P, N, dtype, device, seed=1)
    err = max_err(ssd_scan(*args, chunk=Q)[0], ssd_chunked(*args, chunk=Q)[0])
    item = args[0].element_size()
    # x read, y written; dt, A, B and C read
    nbytes = 2 * B * S * H * P * item + (B * S * H + H) * 4 + 2 * B * S * N * item
    # the products this run needs: per (b, chunk) C B^T over the causal pairs,
    # once for all heads; per head the intra term over the causal pairs, the
    # inter term C h^T and the state update x^T B
    pairs = Q * (Q + 1) // 2
    flops = 2 * B * (S // Q) * (pairs * N + H * (pairs * P + 2 * Q * N * P))
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:84",
            "max_abs_err": err,
            "ms": device_ms(lambda: ssd_scan(*args, chunk=Q)),
            "plain_ms": device_ms(lambda: ssd_chunked(*args, chunk=Q), reps=5),
            "call_ms": time_ms(lambda: ssd_scan(*args, chunk=Q), reps=20),
            **roofline(nbytes, flops),
            "library_ms": None,    # no single PyTorch call computes SSD
            "shape": f"B={B} S={S} H={H} P={P} N={N} chunk={Q} bf16"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    device = resolve_device("cuda")
    card = card_line()
    print(card)
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()}")

    log("phase 2: build kernels")
    build_kernels()
    log("phase 3: kernels against their plain versions")
    check_kernels(device)
    log("phase D1: host->device transfers, inline vs direct")
    transfers(card, device)
    log("phase D2: the DMA-copy kernels against the plain tiled copy")
    copy_checks(device)
    dma_kernels = copy_path(card, device)

    counts = {path.arch: drive_path(path, card, device) for path in PATHS}

    log("kernels at their paths' shapes")
    kernels = [rms_entry(device), flash_entry(device), ssd_entry(device)]
    for e in kernels:
        # launches: the T=1 serves of every path that runs the kernel
        e["launches_by_path"] = {
            arch: {f"T={T}": c.get(e["name"], 0) for T, c in by_T.items()}
            for arch, by_T in counts.items() if by_T[1].get(e["name"], 0)}
        e["launches"] = sum(v["T=1"] for v in e["launches_by_path"].values())
        log(f"{card} | {e['name']} at {e['shape']}: device {e['ms']:.5f} ms "
            f"(per call with host {e['call_ms']:.5f} ms), bound "
            f"{e['bound_ms']:.5f} ms ({e['bound_by']}), plain "
            f"{e['plain_ms']:.5f} ms, library {e['library_ms']}, launches "
            f"{e['launches_by_path']}")
    kernels += dma_kernels
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


if __name__ == "__main__":
    sys.exit(main())
