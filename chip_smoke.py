#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. print the card (``nvidia-smi --query-gpu=name,power.limit``) and the
   torch/CUDA versions;
2. build the hand-written kernels (``src/repro_torch/kernels/csrc``) with
   ``nvcc`` for ``sm_90a``;
3. hold each kernel against its plain PyTorch version on the card, at the
   reference's tolerances (RMSNorm 2e-5 f32 / 2e-2 bf16,
   ``tests/test_kernels.py``; flash attention 3e-5 / 3e-2);
4. build gemma-2b at full published width from the port's seeded on-device
   init;
5. serve 4 ragged requests through ``Server.serve`` at tokens_per_launch 1
   and 4 (the main path): tokens equal, doorbells ``1 + ceil(31 / T)``, and
   both kernels launched during each serve;
6. hold the kernel route (``impl="cuda"``) against the plain route
   (``impl="ref"``) on the same weights: bf16 prefill logits, then the fp32
   variant's prefill logits and 8 greedy tokens.  The routes differ in the
   prefill attention (flash kernel vs dense softmax); every norm goes
   through the RMSNorm kernel on both, which phase 3 holds against its
   plain version;
7. time the path (prefill, decode, tokens/s) and each kernel at the path's
   shapes beside its bound, its plain version and one library call.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the
script exits non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import _build, launches, reset_launches  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.rms_norm.ops import rms_norm  # noqa: E402
from repro_torch.kernels.rms_norm.ref import rms_norm_ref  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.runtime.server import Request, Server  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {"rms_norm": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
       "flash_attention": {torch.float32: 3e-5, torch.bfloat16: 3e-2}}

# The main path: 4 ragged prompts, left-padded to 255, 32 new tokens.
PROMPT_LENS = (61, 128, 200, 255)
MAX_SEQ = 512
NEW_TOKENS = 32
# bf16 kernel route vs plain route, relative L2 error of the prefill logits:
# the routes differ only in attention arithmetic (fp32 probabilities in the
# kernel, bf16 in the dense route), a few bf16 roundings (2^-8) per layer.
BF16_LOGITS_REL_TOL = 3e-2
# fp32: both routes round at fp32 precision; 18 layers leave ~1e-5.
FP32_LOGITS_ABS_TOL = 1e-3


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


def check_kernels(device: torch.device) -> None:
    dtypes = (torch.bfloat16, torch.float32)
    # the path's shapes, plus rows wide enough for 4, 8 and 16 vectors a thread
    for rows, D in ((4, 2048), (1020, 2048), (1020, 256), (5, 8192),
                    (7, 16384)):
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
    if device.type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------- phase 5
def requests(vocab: int, seed: int = 0) -> List[Request]:
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, vocab, size=n).astype(np.int32),
                    max_new_tokens=NEW_TOKENS)
            for i, n in enumerate(PROMPT_LENS)]


def padded_prompts(reqs: List[Request], device: torch.device) -> torch.Tensor:
    S = max(len(r.prompt) for r in reqs)
    toks = np.zeros((len(reqs), S), np.int32)
    for i, r in enumerate(reqs):
        toks[i, S - len(r.prompt):] = r.prompt
    return torch.from_numpy(toks).to(device)


def serve_main_path(cfg, params, device: torch.device
                    ) -> Dict[int, Tuple[Dict[str, Any], Dict[str, int], list]]:
    """Serve at T=1 and T=4; counters are zeroed just before each serve."""
    runs = {}
    for T in (1, 4):
        srv = Server(cfg, batch_size=len(PROMPT_LENS), max_seq=MAX_SEQ,
                     tokens_per_launch=T, device=device, params=params)
        reqs = requests(cfg.vocab_size)
        reset_launches()
        metrics = srv.serve(reqs)
        counts = dict(launches)
        runs[T] = (metrics, counts, [r.tokens for r in reqs])
        log(f"serve T={T}: {metrics} kernel launches {counts}")
    (m1, c1, tok1), (m4, c4, tok4) = runs[1], runs[4]
    if tok1 != tok4:
        raise AssertionError("tokens differ between T=1 and T=4")
    for T, (m, c, toks) in runs.items():
        want = 1 + math.ceil((NEW_TOKENS - 1) / T)
        if m["doorbells"] != want:
            raise AssertionError(f"T={T}: {m['doorbells']} doorbells, "
                                 f"expected {want}")
        for name in ("rms_norm", "flash_attention"):
            if c.get(name, 0) < 1:
                raise AssertionError(f"T={T}: kernel {name} was not launched")
        if any(len(t) != NEW_TOKENS or not all(0 <= x < cfg.vocab_size
                                               for x in t) for t in toks):
            raise AssertionError(f"T={T}: tokens out of range or short")
    return runs


# ---------------------------------------------------------------- phase 6
def greedy(model: TransformerLM, params, toks: torch.Tensor, n: int
           ) -> Tuple[torch.Tensor, List[List[int]]]:
    state, logits = model.prefill(params, toks, MAX_SEQ)
    first = logits
    out = []
    for _ in range(n):
        nxt = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
        out.append(nxt[:, 0])
        if len(out) < n:
            state, logits = model.decode_step(params, state, nxt)
    return first, torch.stack(out, dim=1).tolist()


def compare_routes(cfg, params, device: torch.device, seed: int = 0) -> None:
    toks = padded_prompts(requests(cfg.vocab_size), device)
    kern = TransformerLM(cfg, impl="cuda", device=device)
    plain = TransformerLM(cfg, impl="ref", device=device)
    _, lk = kern.prefill(params, toks, MAX_SEQ)
    _, lp = plain.prefill(params, toks, MAX_SEQ)
    if not (torch.isfinite(lk).all() and lk.shape == (toks.shape[0], 1,
                                                       cfg.vocab_padded)):
        raise AssertionError(f"bf16 prefill logits: shape {tuple(lk.shape)} "
                             f"or non-finite values")
    rel = ((lk.float() - lp.float()).norm() / lp.float().norm()).item()
    log(f"{cfg.name} bf16 prefill logits, kernel vs plain route: relative L2 "
        f"{rel:.3e} (tol {BF16_LOGITS_REL_TOL}), max|err| {max_err(lk, lp):.3e}")
    if rel > BF16_LOGITS_REL_TOL:
        raise AssertionError("bf16 prefill logits disagree between routes")
    del lk, lp

    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    kern32 = TransformerLM(cfg32, impl="cuda", device=device)
    plain32 = TransformerLM(cfg32, impl="ref", device=device)
    params32 = kern32.init_params(seed)
    lk, tk = greedy(kern32, params32, toks, 8)
    lp, tp = greedy(plain32, params32, toks, 8)
    err = max_err(lk, lp)
    log(f"{cfg.name} fp32 prefill logits max|err| {err:.3e} (tol "
        f"{FP32_LOGITS_ABS_TOL}); greedy tokens kernel {tk} plain {tp}")
    if err > FP32_LOGITS_ABS_TOL or tk != tp:
        raise AssertionError("fp32 routes disagree")


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


def time_path(cfg, params, device: torch.device) -> Dict[str, float]:
    model = TransformerLM(cfg, impl="cuda", device=device)
    toks = padded_prompts(requests(cfg.vocab_size), device)
    prefill_ms = time_ms(lambda: model.prefill(params, toks, MAX_SEQ), reps=5)
    state, logits = model.prefill(params, toks, MAX_SEQ)
    nxt = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
    step = {"state": state}

    def one_step():
        step["state"], _ = model.decode_step(params, step["state"], nxt)
    decode_ms = time_ms(one_step, reps=16, warmup=2)
    profile_window(lambda: model.prefill(params, toks, MAX_SEQ),
                   f"{cfg.name} prefill profile")
    profile_window(one_step, f"{cfg.name} decode step profile")
    srv = Server(cfg, batch_size=len(PROMPT_LENS), max_seq=MAX_SEQ,
                 tokens_per_launch=1, device=device, params=params)
    m = srv.serve(requests(cfg.vocab_size))
    return {"prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
            "serve_wall_s": m["wall_s"],
            "tokens_per_s": m["new_tokens"] / m["wall_s"]}


def rms_entry(device: torch.device, n_launches: int) -> Dict[str, Any]:
    rows, D, dtype = len(PROMPT_LENS) * max(PROMPT_LENS), 2048, torch.bfloat16
    x, s = rms_inputs(rows, D, dtype, device, seed=1)
    err = max_err(rms_norm(x, s), rms_norm_ref(x, s))
    item = x.element_size()
    bound_s = (2 * rows * D * item + D * item) / PEAK_BYTES_PER_S
    library_ms = None
    if hasattr(F, "rms_norm"):
        w = (1.0 + s.float()).to(dtype)
        library_ms = device_ms(lambda: F.rms_norm(x, (D,), w, 1e-6))
    return {"name": "rms_norm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rms_norm.cu",
            "replaces": "src/repro/kernels/rms_norm/kernel.py:31",
            "launches": n_launches, "max_abs_err": err,
            "ms": device_ms(lambda: rms_norm(x, s)),
            "plain_ms": device_ms(lambda: rms_norm_ref(x, s)),
            "call_ms": time_ms(lambda: rms_norm(x, s), reps=100),
            "bound_ms": bound_s * 1e3, "bound_by": "bytes",
            "library_ms": library_ms,
            "shape": f"rows={rows} D={D} bf16"}


def flash_entry(cfg, device: torch.device, n_launches: int) -> Dict[str, Any]:
    B, S, H, Hkv, hd = (len(PROMPT_LENS), max(PROMPT_LENS), cfg.n_heads,
                        cfg.n_kv_heads, cfg.hd)
    dtype = torch.bfloat16
    q, k, v = flash_inputs(B, S, H, Hkv, hd, dtype, device, seed=1)
    err = max_err(flash_attention(q, k, v), flash_attention_ref(q, k, v))
    item = q.element_size()
    nbytes = (2 * B * S * H * hd + 2 * B * S * Hkv * hd) * item
    flops = 4 * B * H * hd * S * (S + 1) // 2     # causal pairs only
    byte_s, flop_s = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:77",
            "launches": n_launches, "max_abs_err": err,
            "ms": device_ms(lambda: flash_attention(q, k, v)),
            "plain_ms": device_ms(lambda: flash_attention_ref(q, k, v)),
            "call_ms": time_ms(lambda: flash_attention(q, k, v), reps=50),
            "bound_ms": max(byte_s, flop_s) * 1e3,
            "bound_by": "bytes" if byte_s >= flop_s else "operations",
            "library_ms": library_ms,
            "shape": f"B={B} S={S} H={H} Hkv={Hkv} hd={hd} causal bf16"}


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

    log("phase 4: gemma-2b at full width, seeded on-device init")
    cfg = ARCHS["gemma-2b"]
    model = TransformerLM(cfg, impl="cuda", device=device)
    params = model.init_params(seed=0)
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{cfg.name}: {n_params / 1e9:.3f} B parameters, "
        f"{sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9:.2f}"
        f" GB in {cfg.param_dtype}")

    log("phase 5: Server.serve, the main path")
    runs = serve_main_path(cfg, params, device)

    log("phase 6: kernel route against the plain route")
    compare_routes(cfg, params, device)

    log("phase 7: timings")
    path = time_path(cfg, params, device)
    log(f"{card} | {cfg.name} B={len(PROMPT_LENS)} prompts {PROMPT_LENS} "
        f"new {NEW_TOKENS}: prefill {path['prefill_ms']:.3f} ms, decode "
        f"{path['decode_ms_per_step']:.3f} ms/step ({len(PROMPT_LENS)} tokens), "
        f"{path['tokens_per_s']:.1f} tokens/s (serve wall "
        f"{path['serve_wall_s']:.3f} s, T=1)")
    counts = runs[1][1]
    kernels = [rms_entry(device, counts["rms_norm"]),
               flash_entry(cfg, device, counts["flash_attention"])]
    for e in kernels:
        log(f"{card} | {e['name']} at {e['shape']}: device {e['ms']:.5f} ms "
            f"(per call with host {e['call_ms']:.5f} ms), bound "
            f"{e['bound_ms']:.5f} ms ({e['bound_by']}), plain "
            f"{e['plain_ms']:.5f} ms, library {e['library_ms']}, launches per "
            f"T=1 serve {e['launches']} (T=4: {runs[4][1][e['name']]})")
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
