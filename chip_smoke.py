#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. print the card (``nvidia-smi --query-gpu=name,power.limit``) and the
   torch/CUDA versions;
2. build the hand-written kernels (``src/repro_torch/kernels/csrc``) with
   ``nvcc`` for ``sm_90a``, one process per source, and print each kernel's
   registers, static shared memory and spills from ``-Xptxas -v``;
3. hold each kernel against its plain PyTorch version on the card, at the
   reference's tolerances (RMSNorm 2e-5 f32 / 2e-2 bf16, flash attention
   3e-5 / 3e-2, SSD scan 1e-3 / 6e-2; ``tests/test_kernels.py``), at the
   paths' shapes and at ragged ones (flash: S of 1, 17, 100 and 1000, which
   are not multiples of the 16x8 fragments or the 64-key tiles, at hd 64,
   128 and 256 and Hkv 1, 2 and 8; SSD: a ragged chunk, chunks of 16 and 64,
   16 chunks, H = 3 and 11, P < 64 and N < 128), and at the continuous
   engine's batch-1 prefills (flash at S = 4, 8, 128, 256 and 512 with
   gemma-2b's heads; the SSD scan at chunk = S = 4 and 8 and at S = 128,
   256 and 512), and at phase Z's shapes (flash at qwen2-moe's, jamba's and
   grok's heads, B=4 and batch 1; the SSD scan at jamba's N = 16);

then the paper's DMA case study (section 6.2):

D1. host->device transfers: ``sweep_transfer`` over the sizes of
    ``benchmarks/bench_dma.py`` (4 B-16 KiB by powers of two, 1-31 KiB by
    3 KiB; 32 KiB-32 MiB for direct only) for the inline protocol (payload
    carried in kernel parameters, one CUDA-graph replay a put) and the direct
    one (pageable ``cudaMemcpy``): every put round-trips exactly and lands
    one ``transfer`` event; latency and GiB/s per size (Figure 6), and
    whether the direct path shows a knee at 24 KiB; then ``HybridMover()``
    over the same sizes, inline below 24 KiB and direct above; then the
    1-31 KiB sizes interleaved over 8 passes (each pass in its own order,
    the protocols in turn: inline, direct from pageable and from
    page-locked memory), each put timed on the host and between CUDA events
    on the device: medians, and whether a knee shows at 24 KiB on either
    clock;
D2. the two DMA-copy kernels (pipelined, explicit TMA) held byte for byte
    against the plain tiled copy at the reference's test shapes (f32, bf16,
    int8), at tiles whose offsets are not multiples of 16, at tiles of one
    pipelined slice and one byte more, and at the path shape, [32768, 4096]
    bf16 (256 MiB); then the path: each copy at block_rows 8, 32, 128 and
    256 bracketed by ``ProgressTracker`` releases on one session (counts
    zeroed just before, read just after), three brackets of 20 copies a
    tile, each opened behind a 2 ms device-side spin so that no host stall
    lands inside it, and their median held against torch.profiler's device
    time within 15%, with each copy's grid and blocks resident per SM and
    its time against ``copy_``;

G. ``ExecGraph``'s three launch modes (``src/repro_torch/core/graphs.py``),
   a chain of K identical nodes of the hand-written node kernel
   (``kernels/csrc/exec_graph.cu``) at width 4096: each mode's result
   against ``reference()`` to rtol 1e-5, doorbells K / 1 / 1, and the
   footprint law of ``tests/test_core_graphs.py`` at K = 8 and 32 (per_op
   bytes x4, graphed growing, multistep below 1.1x), the footprint read from
   the graphs themselves; then the paper's Figure 7 sweep
   (``benchmarks/bench_graphs.py``'s chains, K = 1-2000, per_op to 500): one
   line per (mode, K) with launch and completion us, bytes, nodes,
   doorbells and upload ms, and a fit of launch time over footprint per
   mode;

S. the paper's instrument, command-stream capture (``core/capture.py``,
   ``core/stream.py``): S1, ``benchmarks/bench_submission.py``'s stage split
   (``tanh(x @ W).sum()``, 1024 wide, batch 8, fp32, one TraceSession): the
   recorded eager run, capture+instantiate+upload, the first replay's
   dispatch and completion, the median of 20 steady replays; S4,
   ``ExecGraph``'s graphed chain of 10 and its multistep graph decoded node
   by node (10 kernel nodes of the node kernel; memset, conditional and a
   body of 2 kernels), held to phase G's footprints' node counts; S2 and
   S3 run after
   phase 7 of each serving path, below;

then, for each serving path, gemma-2b (dense, flash attention) and
mamba2-780m (SSD scan), both at full published width (and phase Z's, below):

4. build the model from the port's seeded on-device init;
5. serve 4 ragged requests through ``Server.serve`` at tokens_per_launch 1
   and 4 (the main path), twice per Server: the first serve captures its
   CUDA graphs, the second replays them under torch.profiler.  Tokens of
   both serves equal an eager greedy loop's, doorbells ``1 + ceil(31 / T)``,
   the path's kernels launched during each serve (counts zeroed just before
   each serve and read just after), and the replayed serve's counted
   launches equal the profiler's count of the same kernels, by name; each
   graph's node count a replay;
6. hold the kernel route (``impl="cuda"``) against the plain route
   (``impl="ref"``) on the same weights: bf16 prefill logits; last in the
   path, once its bf16 weights are released, the fp32 variant's prefill
   logits and 8 greedy tokens.  The routes differ in the prefill's kernel
   (flash attention vs dense softmax; SSD kernel vs plain chunked scan);
   every norm goes through the RMSNorm kernel on both, which phase 3 holds
   against its plain version.  An MoE router's expert choices are held to
   the kernel route's (a flip at a near-tie moves a token's output whole),
   and the choices a route would have made otherwise are counted;
7. time both routes: the model's eager calls (prefill, decode) and the
   servers' graph replays (prefill, decode per step at T = 1 and 4, device
   busy over one decode replay), device time by kernel and the path's
   kernels' share of it; then one warm serve per Server (tokens/s) beside
   the capturing serve's wall time and the op recorder's share of it;
S2. decode phase 5's graphs (gemma-2b: each decode and prefill graph at
    T = 1 and 4; mamba2-780m: each decode graph) through the driver: the
    port's kernel nodes equal the step's counted launches, every kernel
    node by function equals torch.profiler's records of one replay, copy
    and fill nodes its memcpy and memset records, and the decoded nodes the
    footprint's node count (the decoded bytes are the footprint's by
    definition); node counts by type and the top kernels of each,
    and gemma-2b's T=1 decode graph as Listing 1 (first 40 nodes);
S3. each decode graph's roofline (``core/roofline.py::analyze`` on its
    op-level stream, model FLOPs 2 N tokens) beside phase 7's replay time;

then phase C, continuous batching (``ContinuousBatchingServer`` on
``DenseKV``: one prefill graph per prompt length, one decode graph over all
slots for the engine's life), for gemma-2b and mamba2-780m at full width in
bf16:

C1. ``benchmarks/bench_loadtest.py``'s traffic and engine (32 requests,
    prompts of 4 and 8, budgets of 5 and 9, 4 slots, max_seq 64) at T = 1,
    4 and 8: a warm replay, then the measured one (counts zeroed just
    before, read just after), both synchronous: 32 completed, 224 tokens,
    doorbells 84 / 45 / 40 (the reference's BENCH_10 rows), prefills plus
    decodes, two prefill graphs and the decode graph never captured again;
    the counted launches equal torch.profiler's over the same traffic
    replayed again in one profiler window; at T=1 the
    first 4 requests against a one-shot ``Server(batch_size=1)`` on the
    engine's params (equal tokens, or a first difference at a near-tie:
    the one-shot's top-2 logit gap below one bf16 step of its top logit);
C2. realistic traffic (prompts of 128, 256 and 512, budgets of 32, 64 and
    128, 8 slots, max_seq 1024; 64 requests for gemma-2b, 32 for
    mamba2-780m) at T = 1 and 4: a synchronous replay, device busy over one
    decode replay and the host gap between decode launches (the
    ``serve.decode_iter`` spans and launch-to-launch times against one
    replay), at T=1 the one-shot check, then a realtime replay at half the
    requests/s the synchronous one sustained with the live endpoint polled
    once on 127.0.0.1 from the decode loop, once 4 of the replay's requests
    have finished: the snapshot's active slots, done tickets,
    ``serve.finish`` events, tokens and dispatches equal the engine's at
    that moment;
C1 fp32: gemma-2b in fp32 on C1's spec at T=1, its first 8 requests equal
    to the one-shot's exactly;

then phase K, chunked prefill and the paged KV backend (``PagedKV``: a page
pool, block tables, shared-prefix pages), gemma-2b at full width in bf16;
every prefill chunk and every decode launch one graph replay.  Each engine
runs a warm replay of the schedule behind another shared prefix (it
captures every graph and leaves no page the measured replay could share),
then the measured one, in which no graph may be captured, then the
schedule once more under torch.profiler.  Its counted launches must equal
the measured replay's and, exactly, the decoded graphs' nodes of each
kernel times the graphs' replays; the profiler may record under each graph
launch only kernels of that graph's nodes, and its count of each kernel
plus the records missing under the launches must equal the counted
launches (records missing under a launch are reported as the tracer's
loss, beside CUPTI's dropped-record count):

K1. ``benchmarks/bench_kv.py``'s traffic and engine (8 requests, prompts of
    4 or 8 after a shared 24-token prefix, budgets of 5 or 9; 4 slots,
    max_seq 64, T=4) in its two modes, ``dense_chunk8`` and
    ``paged_pt8_chunk8``: each gives the reference's BENCH_10 kv row
    (doorbells 43 / 29, prefill doorbells 32 / 20, prefill payload 960 /
    576 B, pages allocated / peak / reused 26 / 17 / 12 and 4 prefix hits
    for paged), and paged tokens equal dense's request by request;
K2. C2's gemma-2b chat traffic behind a 64-token shared system prompt
    (prompts of 192, 320 and 576) in four modes: dense whole-prompt (the
    control) at T=1, dense with chunks of 128 at T=1, paged (pages of 16)
    with chunks of 128 at T=1 and T=4: every request completes, the first
    4 requests equal the control's tokens up to near-ties, paged reuses 4
    pages a prefix hit and hits at least 56 times; one line per replay with
    the host gap between decode launches, the prefill launches and the
    largest, pages and one replay of each prefill and extend graph;
K3. K2's paged engine at T=1 with a pool of two slots' pages: requests are
    evicted for pages, and every survivor's tokens equal its tokens in K2's
    paged mode, or first differ at a near-tie;

one ``<card> | loadtest <arch> T=<T> spec=<spec>: ...`` line per replay
(``spec=K<n> kv=<mode>`` in phase K);

then phase T, training (``Trainer``: every launch of K steps one CUDA Graph
replay, the first the capture's eager warm-up; the train route,
``impl="ref"``, launches none of the port's kernels, and a counted launch
fails the phase):

T1. gemma-2b at full width (bf16 params, fp32 master weights and moments,
    remat), ``launch/train.py``'s B=8, S=256, at K=1 (6 launches) and K=4
    (2 launches), then mamba2-780m at K=1 (4 launches, plain SSD), each
    from the seeded start and held step by step to an eager, uncaptured
    control from the same start within 2^-8 relative; one ``<card> |
    train <arch> K=<k> ...`` line a run: step ms (CUDA events around each
    replay), tokens/s, losses, doorbells, graph nodes, footprint, capture
    s, pool and peak GiB;
T3. the K=1 gemma-2b train graph decoded and held to torch.profiler's
    records of one replay (as S2), its node types and top kernels, the
    op-level FLOPs and bytes recorded at its capture and its roofline;
T2. ``benchmarks/bench_submission.py``'s ``_multistep_economy``
    (deepseek-7b's smoke config, B=4, S=64, K = 1, 4, 16 over 16 steps,
    then 16 more): host us per step with and without the capturing launch,
    doorbells 16 / 4 / 1, final loss, graph nodes and footprint; K=4's
    losses equal K=1's within 1e-3 relative;

then phase P, the submission-policy tuner (``repro_torch.tune``) at
gemma-2b's full width:

P0. the parent releases phase T's state and its cuBLAS workspaces and
    keeps under 2 GiB reserved;
P1. ``python -m repro_torch.tune --arch gemma-2b --full --workloads
    dma,serve,train,kv --rounds 2 --batch 8 --new-tokens 64 --max-seq 128
    --train-steps 16 --cuda-env CUDA_MODULE_LOADING=LAZY`` in a subprocess
    (the preset applied before CUDA starts; ``--verify`` on): the policy
    holds the five knobs, after <= before, a trial log, the workload spec
    and the preset; one ``<card> | P1 <workload> <knobs>: objective,
    doorbells/token, dispatch, transfer, <unit>/s`` line per measured
    candidate (from the trial log), the chosen knobs and the ``verify:``
    lines;
P2. every knob owner (``Server``, the paged ``ContinuousBatchingServer``,
    ``Trainer``, ``HybridMover``) at full width picks the policy up with
    its knob unset, explicit values win, and ``REPRO_POLICY_DISABLE=1``
    restores the defaults (1, 16, 0, 1, 24 KiB);
P3. ``benchmarks/bench_policy.py``, in a fresh process (``chip_smoke.py
    --policy-bench``): the serve workload at T=1 and at the tuned T
    through the tuner's evaluator on P1's spec, one ``<card> | P3
    policy_serve_<baseline|tuned>`` line each (with the path kernels'
    launches), and the recorded before/after;
P4. the phase's wall time;

then phase Z, the MoE and hybrid families at full width (each model
released before the next):

Z1. qwen2-moe-a2.7b, all 24 layers (60 routed experts top-4, 4 shared;
    RMSNorm and flash at H = Hkv = 16, hd 128) through phases 4-7 and
    S2-S3 on gemma-2b's traffic; ``moe_sorted`` against ``moe_dense`` at
    capacity_factor E/k (no slot dropped) on layer 0's weights, in bf16 and
    fp32; C1 at T=4 on ``DenseKV`` (the reference's 45 doorbells), and K1
    in ``dense_chunk8`` and ``paged_pt8_chunk8`` (BENCH_10's rows, paged
    tokens equal dense-chunked ones);
Z2. jamba-v0.1-52b at full width on one period (8 of 32 layers: attention
    at 4, Mamba2 elsewhere, MoE of 16 experts top-2 every second layer;
    RMSNorm, flash at H=32, Hkv=8, and SSD at N=16) through phases 4-7 and
    S2-S3 on prompts of 257-512 left-padded to 512 (two chunks of 256),
    max_seq 544, the bf16 tolerance set by a chunk-128 control; C1 at T=4
    on ``DenseKV``;
Z3. grok-1-314b at full width on 2 of 64 layers (gelu experts, top-2 of 8,
    GQA 48/8): phase 6;

every profiler window of the script (phase 5, C1, S2, K1-K2, T3 and the
device times) matches torch.profiler's records to their launches by
correlation id: a graph launch to its decoded nodes, an eager kernel
launch to one record.  Records missing under a launch are the tracer's
loss, printed as a ``tracer loss`` line with CUPTI's dropped-record count
and counted with the profiler's records; any other mismatch raises, and a
device time is never read from a window with a loss (it is taken again, up
to 3 times);

and last, time each kernel at its path's shape beside its bound, its plain
version and one library call where there is one (the DMA-copy kernels are
timed in D2), the flash kernel at B=1, S=4096 beside
``scaled_dot_product_attention`` and its bound (one ``flash_attention
long`` line), and flash at Z1's and Z2's prefill shapes and the SSD scan
at Z2's the same way, then the whole script's wall time.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the
script exits non-zero before printing any result.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import urllib.request
from unittest import mock
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import ARCHS, SMOKE_ARCHS, ModelConfig  # noqa: E402
from repro_torch.configs.shapes import ShapeConfig  # noqa: E402
from repro_torch.core import (H100_SXM, INLINE_THRESHOLD_DEFAULT,  # noqa: E402
                              SPAN_EVENT, CommandStreamCapture, HybridMover,
                              TraceSession, analyze, direct_put, inline_put,
                              render_roofline_row, render_submission,
                              sweep_transfer)
from repro_torch.core.graphs import (LAUNCH_MODES, ExecGraph,  # noqa: E402
                                     MultiStepLauncher, node_cost,
                                     record_captures)
from repro_torch.core.stream import (decode_graph, kernel_base,  # noqa: E402
                                     kernel_label)
from repro_torch.kernels import (KernelCost, _build, launches,  # noqa: E402
                                 reset_launches)
from repro_torch.kernels.dma_copy.ops import (MODES, dma_copy,  # noqa: E402
                                              dma_copy_cost, occupancy)
from repro_torch.kernels.dma_copy.ref import dma_copy_tiled  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention, flash_attention_cost)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.rms_norm.ops import rms_norm, rms_norm_cost  # noqa: E402
from repro_torch.kernels.rms_norm.ref import rms_norm_ref  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_cost  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import mamba as mamba_block_module  # noqa: E402
from repro_torch.models import moe as moe_module  # noqa: E402
from repro_torch.models.layers import layer_params, map_params  # noqa: E402
from repro_torch.models.moe import capacity, moe_dense, moe_sorted  # noqa: E402
from repro_torch.runtime.server import (ContinuousBatchingServer,  # noqa: E402
                                        Request, Server)
from repro_torch.runtime.trainer import Trainer  # noqa: E402
from repro_torch.runtime.traffic import (Arrival, TrafficSpec,  # noqa: E402
                                         generate, replay)
from repro_torch.tune import Objective, clear_active_policy  # noqa: E402
from repro_torch.tune.autotune import (KNOB_WORKLOADS,  # noqa: E402
                                       CandidateEvaluator, WorkloadSpec,
                                       default_knobs)

TOL = {"rms_norm": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
       "flash_attention": {torch.float32: 3e-5, torch.bfloat16: 3e-2},
       "ssd_scan": {torch.float32: 1e-3, torch.bfloat16: 6e-2}}
NEW_TOKENS = 32
# phase G: benchmarks/bench_graphs.py's chains and width (Figure 7)
GRAPH_WIDTH = 4096
GRAPH_LAW_CHAINS = (8, 32)                  # tests/test_core_graphs.py
GRAPH_CHAINS = [1, 10, 25, 50, 100, 200, 500, 1000, 2000]
GRAPH_PER_OP_MAX = 500
GRAPH_REPS = 20
# phase S: benchmarks/bench_submission.py's stage split (width, batch,
# steady replays), ExecGraph's decoded chain, Listing 1's first nodes
S_WIDTH, S_BATCH, S_STEADY = 1024, 8, 20
S_CHAIN = 10
S_REPORT_NODES = 40
# torch.profiler's records of a graph's copy and fill nodes: a copy engine's
# ("Memcpy DtoD (Device -> Device)", "Memset (Device)") or the driver's own
# copy kernel ("memcpy32_post")
DRIVER_COPY = re.compile(r"^(Memcpy|Memset) |^(?=(memcpy|memset))\w+$")
PROFILE_MARGIN_S = 0.05
SENTINELS, SENTINEL = 64, "spin_kernel"     # torch.cuda._sleep's kernel


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
    # the depth served, where the published one does not fit on one card
    n_layers: Optional[int] = None

    @property
    def cfg(self) -> ModelConfig:
        cfg = ARCHS[self.arch]
        return (cfg if self.n_layers is None
                else dataclasses.replace(cfg, n_layers=self.n_layers))


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
# phase Z, the MoE and hybrid families at full width.  Both routes run the
# same MoE arithmetic, but a rounding that differs before the router can
# flip an expert choice at a near-tie, and a flipped choice moves that
# token's output whole: phase 6 holds every route to the kernel route's
# expert choices (``experts_held``) and counts the choices a route would
# have made otherwise.  qwen2-moe-a2.7b: all 24 layers (28.6 GB in bf16),
# gemma-2b's traffic; flash at H = Hkv = 16, hd 128.
QWEN_MOE = ServePath("qwen2-moe-a2.7b", (61, 128, 200, 255), 512,
                     ("rms_norm", "flash_attention"), 5e-2, 1e-3)
# jamba-v0.1-52b: one period of its 32 layers (1 attention, 7 Mamba2, 4 MoE
# of 16 experts; 26.5 GB), prompts left-padded to 512, two SSD chunks of
# 256, N = 16; the control halves the chunk, as mamba2-780m's
JAMBA = ServePath("jamba-v0.1-52b", (257, 300, 400, 512), 544,
                  ("rms_norm", "flash_attention", "ssd_scan"), 5e-2, 1e-3,
                  control={"ssm_chunk": 128}, n_layers=8)
# grok-1-314b: 2 of its 64 layers (22.9 GB), phase 6 only: gelu experts,
# top-2 of 8, GQA 48/8
GROK = ServePath("grok-1-314b", (61, 128, 200, 255), 512,
                 ("rms_norm", "flash_attention"), 5e-2, 1e-3, n_layers=2)
ZOO_PATHS = (QWEN_MOE, JAMBA)
# Z1: moe_sorted at capacity_factor E/k (no slot dropped) against
# moe_dense on layer 0's weights: in fp32 the two differ in the order of
# their sums; in bf16 the sorted path rounds each expert's weighted output
# and adds the k of them in bf16, the dense one sums in its product
MOE_PATHS_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# the kernels behind each counted name, as torch.profiler names them: one
# launch of each per counted launch (an SSD call at the path's shape, four
# chunks, launches all five)
KERNEL_SYMBOLS = {"rms_norm": ("rms_norm_kernel",),
                  "flash_attention": ("flash_attention_",),
                  "ssd_scan": ("ssd_scan_cumsum_kernel", "ssd_scan_cb_kernel",
                               "ssd_scan_state_kernel", "ssd_scan_pass_kernel",
                               "ssd_scan_out_kernel")}
# an SSD call over one chunk (every prefill of C1, prompts of 4 and 8) runs
# no state or state-passing kernel
MULTI_CHUNK_ONLY = ("ssd_scan_state_kernel", "ssd_scan_pass_kernel")

# phase C: continuous batching.  C1 is benchmarks/bench_loadtest.py's
# traffic and engine; the doorbells are the reference's BENCH_10 loadtest
# rows (the schedule depends only on the drawn lengths and budgets, which do
# not depend on the vocabulary).  C2 is realistic traffic at full width.
C1_SPEC = dict(n_requests=32, rate=200.0, prompt_lens=(4, 8),
               new_tokens=(5, 9), seed=0)
C1_ENGINE = dict(batch_size=4, max_seq=64)
C1_TS = (1, 4, 8)
C1_DOORBELLS = {1: 84, 4: 45, 8: 40}
C1_NEW_TOKENS = 224
C2_SPEC = dict(prompt_lens=(128, 256, 512), new_tokens=(32, 64, 128), seed=0)
C2 = {"gemma-2b": (dict(n_requests=64, **C2_SPEC),
                   dict(batch_size=8, max_seq=1024)),
      "mamba2-780m": (dict(n_requests=32, **C2_SPEC),
                      dict(batch_size=8, max_seq=1024))}
C2_TS = (1, 4)
C_KERNELS = {"gemma-2b": ("rms_norm", "flash_attention"),
             "mamba2-780m": ("rms_norm", "ssd_scan"),
             "qwen2-moe-a2.7b": ("rms_norm", "flash_attention"),
             "jamba-v0.1-52b": ("rms_norm", "flash_attention", "ssd_scan")}
Z_C1_TS = (4,)
C_RING = 1 << 16                     # session events kept for the spans
LIVE_POLL_AFTER = 4                  # C2 realtime: poll once 4 have finished
# phase K: chunked prefill and the paged KV backend, gemma-2b.  K1 is
# benchmarks/bench_kv.py's traffic, engine and modes, held to the
# reference's BENCH_10 kv rows; K2 is C2's gemma-2b chat traffic behind a
# 64-token shared system prompt (prompts of 192, 320 and 576); K3 is K2's
# paged engine with a pool of two slots' pages.
K1_SPEC = dict(n_requests=8, rate=1000.0, prompt_lens=(4, 8),
               new_tokens=(5, 9), seed=0, prefix_len=24)
K1_ENGINE = dict(batch_size=4, max_seq=64, tokens_per_launch=4)
K1_MODES = {"dense_chunk8": dict(kv="dense", prefill_chunk=8),
            "paged_pt8_chunk8": dict(kv="paged", kv_page_tokens=8,
                                     prefill_chunk=8)}
# requests, new tokens, doorbells, prefill doorbells, prefill payload
# bytes, pages allocated / peak / reused, prefix hits
K1_ROWS = {"dense_chunk8": (8, 56, 43, 32, 960, 0, 0, 0, 0),
           "paged_pt8_chunk8": (8, 56, 29, 20, 576, 26, 17, 12, 4)}
K2_SPEC = dict(C2["gemma-2b"][0], prefix_len=64)
K2_ENGINE = C2["gemma-2b"][1]
K2_PAGED = dict(kv="paged", kv_page_tokens=16, prefill_chunk=128)
# (mode, T, engine options); the control, whole-prompt dense, first
K2_MODES = (("dense", 1, {}),
            ("dense_chunk128", 1, dict(kv="dense", prefill_chunk=128)),
            ("paged_pt16_chunk128", 1, K2_PAGED),
            ("paged_pt16_chunk128", 4, K2_PAGED))
K2_PREFIX_PAGES = K2_SPEC["prefix_len"] // K2_PAGED["kv_page_tokens"]
# all 64 requests less the first admission round, which begins before any
# prefix page is registered
K2_MIN_HITS = K2_SPEC["n_requests"] - K2_ENGINE["batch_size"]
K3_PAGES = 2 * (K2_ENGINE["max_seq"] // K2_PAGED["kv_page_tokens"])
K_NEAR_TIES = 4                      # K2: the first 4 requests against (a)
# K2's profiler check replays the schedule's first 12 requests (the first
# admission round and 4 prefix hits): under torch.profiler a whole replay of
# 64 took ~70 s a mode on the card
K2_PROFILED = 12
K_KV_COUNTERS = ("prefill_launches", "prefill_payload_bytes",
                 "pages_allocated", "pages_reused", "prefix_hits")
# phase 3: the engine's per-request prefills, batch 1 (gemma-2b's heads for
# flash; the mamba2-780m scan at chunk = min(256, S))
PREFILL_LENS = (4, 8, 128, 256, 512)

# D1: benchmarks/bench_dma.py's sizes (Figure 6; Table 2's right half)
EXP_SIZES = [4 * 2**i for i in range(13)]               # 4 B .. 16 KiB
LIN_SIZES = [1024 * i for i in range(1, 32, 3)]         # 1 KiB .. 31 KiB
LARGE_SIZES = [32 * 1024, 128 * 1024, 512 * 1024, 2 * 2**20, 8 * 2**20,
               32 * 2**20]
TRANSFER_ITERS, TRANSFER_WARMUP = 20, 5
# D1's interleaved sweep over LIN_SIZES: passes, and puts a size, a pass and
# a protocol
TRANSFER_PASSES, TRANSFER_PASS_REPS = 8, 3
# D2: (R, C, block_rows, dtype): tests/test_kernels.py's shapes and types,
# then tiles whose offsets are not multiples of 16 bytes (int8 [99, 37] in
# tiles of 3 rows, 111 bytes; bf16 [60, 7] in tiles of 4 rows, 56 bytes) and
# int8 [96, 33] in tiles of 32 rows (1056 bytes, aligned); then tiles of two
# 32 KiB TMA pieces, fewer than the explicit kernel's ring of four (bf16
# [40, 4104] in tiles of 5 rows, 41040 bytes), and tiles of eight pieces
# with unaligned heads and tails, where the ring wraps (int8 [60, 40001] in
# tiles of 6 rows, 240006 bytes); then tiles of exactly one and four 16 KiB
# pipelined slices (int8 [8, 16384] in tiles of 1 row, [8, 32768] in tiles of
# 2) and of one byte more (int8 [3, 16385] and [3, 65537] in tiles of 1 row:
# a last slice of 1 byte, and tiles at odd offsets)
COPY_CASES = [(R, C, blk, dt) for R, C, blk in ((256, 64, 64), (1024, 128, 256),
                                                (128, 32, 128))
              for dt in (torch.float32, torch.bfloat16, torch.int8)] + [
    (96, 33, 32, torch.int8), (99, 37, 3, torch.int8), (60, 7, 4, torch.bfloat16),
    (40, 4104, 5, torch.bfloat16), (60, 40001, 6, torch.int8),
    (8, 16384, 1, torch.int8), (3, 16385, 1, torch.int8),
    (8, 32768, 2, torch.int8), (3, 65537, 1, torch.int8)]
DMA_SHAPE = (32768, 4096)            # bf16: 256 MiB
DMA_DTYPE = torch.bfloat16
DMA_BLOCK_ROWS = 256                 # the reference's default
DMA_TILES = (8, 32, 128, 256)
DMA_REPS = 20
DMA_WARMUP = 3
# each bracket opens behind a device-side spin (torch.cuda._sleep) longer
# than the host's enqueue of the DMA_REPS bracketed copies, so the card is
# still busy when the last of them is queued and no host stall leaves it
# idle inside the bracket; the median of DMA_BRACKETS brackets is held to
# the profiler's time
DMA_SPIN_MS = 2.0
DMA_BRACKETS = 3
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
# the kernels redesigned for Hopper after their first port (tensor cores; a
# ring of TMA pieces; the chunk-parallel SSD steps; the pipelined copy's
# slices), whose registers and spills go into the kernels line
REDESIGNED = ("flash_attention_mma_kernel", "dma_copy_explicit_kernel",
              "ssd_scan_cumsum_kernel", "ssd_scan_cb_kernel",
              "ssd_scan_state_kernel", "ssd_scan_pass_kernel",
              "ssd_scan_out_kernel", "dma_copy_pipelined_kernel")


def ptxas_report(log_text: str) -> Dict[str, Dict[str, int]]:
    """Registers, static shared memory and spill bytes of every kernel in an
    ``-Xptxas -v`` log, by kernel label."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_label(m.group(1))
            out[name] = {"registers": 0, "smem_static_bytes": 0,
                         "spill_store_bytes": 0, "spill_load_bytes": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_store_bytes"] = int(m.group(1))
            out[name]["spill_load_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_static_bytes"] = int(sm.group(1)) if sm else 0
    return out


def build_kernels() -> Dict[str, Dict[str, int]]:
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s: {lib}")
    report = ptxas_report(lib.with_suffix(".so.log").read_text())
    for name, r in sorted(report.items()):
        mark = "  (redesigned)" if name.split("<")[0] in REDESIGNED else ""
        log(f"  ptxas {name}: {r['registers']} registers, "
            f"{r['smem_static_bytes']} B static smem, spills "
            f"{r['spill_store_bytes']} B stored / {r['spill_load_bytes']} B "
            f"loaded{mark}")
    return report


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
    # the paths' shapes (gemma and qwen2-moe D=2048; mamba D=1536 and 3072,
    # 4096 prefill rows; jamba D=4096 and its Mamba norm's 8192, 2048
    # prefill rows; grok D=6144), plus rows wide enough for 4, 8 and 16
    # vectors a thread
    for rows, D in ((4, 2048), (1020, 2048), (1020, 256), (5, 8192),
                    (7, 16384), (4, 1536), (4096, 1536), (4, 3072),
                    (4096, 3072), (4, 4096), (2048, 4096), (2048, 8192),
                    (1020, 6144)):
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
    # lengths that cut a 16x8 fragment or a 64-key tile
    cases += [(S, Hkv, hd) for S in (1, 17, 100, 1000) for hd in (64, 128, 256)
              for Hkv in (1, 2, 8)]
    cases = [(4, S, 8, Hkv, hd) for S, Hkv, hd in cases]
    # the continuous engine's prefills: one request, gemma-2b's heads
    gemma = ARCHS[GEMMA.arch]
    cases += [(1, S, 8, gemma.n_kv_heads, gemma.hd) for S in PREFILL_LENS]
    # phase Z's prefills (qwen2-moe H = Hkv = 16, jamba 32/8, grok 48/8, hd
    # 128) and their engines' batch-1 prefills of C1 and K1
    for path in ZOO_PATHS + (GROK,):
        B, S, H, Hkv, hd = path_flash_shape(path)
        cases += [(B, S, H, Hkv, hd)] + [(1, s, H, Hkv, hd) for s in (4, 8)]
    for B, S, H, Hkv, hd in cases:
        for causal in (True, False):
            for dtype in dtypes:
                q, k, v = flash_inputs(B, S, H, Hkv, hd, dtype, device)
                out = flash_attention(q, k, v, causal=causal)
                ref = flash_attention_ref(q, k, v, causal=causal)
                tol = TOL["flash_attention"][dtype]
                torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                           atol=tol)
                log(f"flash B={B} S={S} H={H} Hkv={Hkv} hd={hd} "
                    f"causal={causal} {dtype}: max|err| "
                    f"{max_err(out, ref):.3e} (tol {tol})")
    # (B, S, H, P, N, chunk): the mamba path's shape; one ragged chunk
    # (Q = S = 255); small chunks (Q = 16); H = 3; P < 64 and N < 128; 16
    # chunks, so the state is passed 15 times; chunks of 64 (one tile); 165
    # (batch, chunk, head) items, not a multiple of the 132 SMs; then the
    # continuous engine's prefills, one request at chunk = min(256, S): one
    # chunk of 4 or 8 rows (a fraction of a 64-row tile), of 128 and 256,
    # and two chunks of 256
    mamba = ARCHS[MAMBA.arch]
    jamba = JAMBA.cfg
    # jamba's prefill (two chunks of 256 at N = 16) and its engine's
    # batch-1 prefills of 4 and 8 rows
    zoo = ((len(JAMBA.prompt_lens), max(JAMBA.prompt_lens), jamba.ssm_heads,
            jamba.ssm_head_dim, jamba.ssm_state, jamba.ssm_chunk),) + tuple(
        (1, S, jamba.ssm_heads, jamba.ssm_head_dim, jamba.ssm_state,
         jamba.ssm_chunk) for S in (4, 8))
    for B, S, H, P, N, chunk in zoo + ((4, 1024, 48, 64, 128, 256),
                                 (4, 255, 48, 64, 128, 256),
                                 (4, 64, 48, 64, 128, 16),
                                 (2, 512, 3, 64, 128, 256),
                                 (2, 96, 5, 16, 8, 32),
                                 (1, 4096, 48, 64, 128, 256),
                                 (2, 512, 48, 64, 128, 64),
                                 (3, 1280, 11, 64, 128, 256)) + tuple(
            (1, S, mamba.ssm_heads, mamba.ssm_head_dim, mamba.ssm_state,
             mamba.ssm_chunk) for S in PREFILL_LENS):
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


def direct_knee(by_size: Dict[int, float]) -> Dict[str, Any]:
    """A latency curve's step across 24 KiB (22 -> 25 KiB), in us by size,
    against the median of its other 3 KiB steps; a knee shows if it is more
    than 3x that median and more than 1 us."""
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
    knee = direct_knee({r["nbytes"]: r["latency_us"]
                        for r in sweeps["direct"]})
    log(f"{card} | direct latency step 22 -> 25 KiB {knee['step_us']:.3f} us "
        f"against a median 3 KiB step of {knee['median_step_us']:.3f} us: "
        f"knee at 24 KiB {'shows' if knee['knee'] else 'does not show'}")
    log(f"D1: {puts} puts, {events} transfer events, {launches['inline_put']}"
        f" inline graph replays; HybridMover {stats}")


def transfer_passes(card: str, device: torch.device) -> None:
    """D1's interleaved sweep: TRANSFER_PASSES passes over the 1-31 KiB
    sizes, each pass in its own order, each size put TRANSFER_PASS_REPS
    times a pass by each protocol in turn (inline, direct from pageable
    memory, direct from page-locked memory), once timed on the host
    (put to completion) and once on the device (CUDA events around the
    dispatch, the stream held while it is queued).  Medians, and whether a
    knee shows at 24 KiB on either clock."""
    protocols = {
        "inline": lambda x, dt: inline_put(x, device, device_time=dt),
        "direct": lambda x, dt: direct_put(x, device, device_time=dt),
        "direct_pinned": lambda x, dt: direct_put(x, device, pinned=True,
                                                  device_time=dt)}
    host: Dict[Tuple[str, int], List[float]] = {
        (m, n): [] for m in protocols for n in LIN_SIZES}
    dev: Dict[Tuple[str, int], List[float]] = {k: [] for k in host}
    payloads = {n: random_bytes(n, seed=3 * n) for n in LIN_SIZES}
    for n, x in payloads.items():                # stage, warm and check each
        for m, put in protocols.items():
            if not torch.equal(put(x, True)[0].cpu(), torch.from_numpy(x)):
                raise AssertionError(f"{m} put of {n} B did not round-trip")
    for p in range(TRANSFER_PASSES):
        rng = np.random.default_rng(p)
        for n in rng.permutation(LIN_SIZES):
            for _ in range(TRANSFER_PASS_REPS):
                for m in rng.permutation(list(protocols)):
                    host[m, n].append(protocols[m](payloads[n], False)[1]
                                      .complete_s)
                    dev[m, n].append(protocols[m](payloads[n], True)[1]
                                     .device_s)
    med = {k: (float(np.median(host[k])) * 1e6, float(np.median(dev[k])) * 1e6)
           for k in host}
    for n in LIN_SIZES:
        log(f"{card} | D1 interleaved {n:>6d} B ({TRANSFER_PASSES} passes x "
            f"{TRANSFER_PASS_REPS}): " + "; ".join(
                f"{m} host {med[m, n][0]:8.3f} us device {med[m, n][1]:8.3f} us"
                for m in protocols))
    for m in protocols:
        for clock, i in (("host", 0), ("device", 1)):
            knee = direct_knee({n: med[m, n][i] for n in LIN_SIZES})
            log(f"{card} | D1 interleaved {m} {clock}: step 22 -> 25 KiB "
                f"{knee['step_us']:.3f} us against a median 3 KiB step of "
                f"{knee['median_step_us']:.3f} us: knee at 24 KiB "
                f"{'shows' if knee['knee'] else 'does not show'}")


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


def spin_cycles(ms: float) -> Tuple[int, float]:
    """The ``torch.cuda._sleep`` cycles of a spin of about ``ms`` on this
    card (calibrated on a spin of 1e6 cycles), and the spin's measured ms."""
    def spin_ms(cycles: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    spin_ms(1_000_000)
    cycles = int(ms / spin_ms(1_000_000) * 1_000_000)
    return cycles, spin_ms(cycles)


def copy_path(card: str, device: torch.device) -> List[Dict[str, Any]]:
    """D2's path: the controlled-DMA benchmark on one session, then the
    kernels' entries at the path shape."""
    R, C = DMA_SHAPE
    x = copy_input(R, C, DMA_DTYPE, device, seed=1)
    cost = dma_copy_cost(x)
    nbytes = cost.operand_bytes + cost.result_bytes
    bracket: Dict[Tuple[str, int], float] = {}
    brackets: Dict[Tuple[str, int], List[float]] = {}
    spin, spin_ms = (spin_cycles(DMA_SPIN_MS) if device.type == "cuda"
                     else (0, 0.0))
    log(f"{card} | D2 brackets: each behind a spin of {spin} cycles "
        f"({spin_ms:.3f} ms), the median of {DMA_BRACKETS}")
    reset_launches()
    with TraceSession("dma.copy") as sess:
        for blk in DMA_TILES:
            for mode in MODES:
                for _ in range(DMA_WARMUP):
                    y = dma_copy(x, mode, blk)
                runs = []
                for _ in range(DMA_BRACKETS):
                    if spin:
                        torch.cuda._sleep(spin)
                    a = sess.progress.release(y)
                    for _ in range(DMA_REPS):
                        y = dma_copy(x, mode, blk)
                    b = sess.progress.release(y)
                    runs.append(sess.progress.elapsed(a, b) / DMA_REPS * 1e3)
                brackets[mode, blk] = runs
                bracket[mode, blk] = float(np.median(runs))
                if not same_bytes(y, x):
                    raise AssertionError(f"dma_copy {mode} block_rows={blk}: "
                                         f"the path's copy differs from x")
    counts = {m: launches[f"dma_copy_{m}"] for m in MODES}
    want = (len(DMA_TILES) * (DMA_WARMUP + DMA_BRACKETS * DMA_REPS)
            if device.type == "cuda" else 0)
    if any(c != want for c in counts.values()):
        raise AssertionError(f"dma_copy launches {counts} in the path, "
                             f"expected {want} each")
    bound = roofline(cost)
    library_ms = device_ms(lambda: torch.empty_like(x).copy_(x))
    prof, occ = {}, {}
    for blk in DMA_TILES:
        for mode in MODES:
            prof[mode, blk] = ms = device_ms(lambda: dma_copy(x, mode, blk))
            br = bracket[mode, blk]
            occ[mode, blk] = grid, per_sm = (occupancy(x, mode, blk)
                                             if device.type == "cuda" else (0, 0))
            log(f"{card} | dma_copy_{mode} [{R}, {C}] bf16 block_rows={blk}: "
                f"{ms:.5f} ms (profiler), {br:.5f} ms (semaphore bracket, "
                f"median of {', '.join(f'{r:.5f}' for r in brackets[mode, blk])}), "
                f"{bound['bound_ms'] / ms:.1%} of the {bound['bound_ms']:.5f} "
                f"ms bound, {ms / library_ms:.3f}x copy_, "
                f"{nbytes / ms / 1e6:.1f} GB/s read+written; grid {grid} "
                f"blocks, {per_sm} resident per SM")
            if abs(br - ms) > BRACKET_TOL * ms:
                raise AssertionError(f"semaphore bracket {br:.5f} ms and "
                                     f"profiler {ms:.5f} ms disagree by more "
                                     f"than {BRACKET_TOL:.0%}")
    plain_ms = device_ms(lambda: dma_copy_tiled(x, DMA_BLOCK_ROWS), reps=5)
    log(f"{card} | plain tiled copy (block_rows={DMA_BLOCK_ROWS}) "
        f"{plain_ms:.5f} ms; torch.empty_like(x).copy_(x) {library_ms:.5f} ms")
    for mode in MODES:
        ms = prof[mode, DMA_BLOCK_ROWS]
        log(f"{card} | dma_copy_{mode} block_rows={DMA_BLOCK_ROWS} {ms:.5f} ms "
            f"against copy_ {library_ms:.5f} ms ({ms / library_ms:.3f}x) and "
            f"the bound {bound['bound_ms']:.5f} ms")
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
            "tiles_grid_blocks_per_sm": {str(blk): list(occ[mode, blk])
                                         for blk in DMA_TILES},
            "launches_by_path": {"dma": counts[mode]},
            "launches": counts[mode]})
        del out
    del x, y
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------- phase G
def exec_graphs(card: str, device: torch.device) -> Dict[str, int]:
    """Phase G, on one session: each mode against ``reference()``, its
    doorbells and the footprint law at K = 8 and 32; then the paper's Figure
    7 sweep (``benchmarks/bench_graphs.py``'s chains) with a fit of launch
    time over footprint per mode.  Returns the kernel launches of the phase
    (counts zeroed just before, read just after)."""
    reset_launches()
    launched = 0
    with TraceSession("graphs") as sess:
        law = {}
        for K in GRAPH_LAW_CHAINS:
            g = ExecGraph(K, GRAPH_WIDTH, device)
            for mode in LAUNCH_MODES:
                y, st = g.launch(mode, session=sess)
                launched += 1
                torch.testing.assert_close(y, g.reference(), rtol=1e-5, atol=0)
                if st.doorbells != (K if mode == "per_op" else 1):
                    raise AssertionError(f"{mode} K={K}: {st.doorbells} "
                                         f"doorbells")
                law[mode, K] = st.command_bytes
                log(f"ExecGraph {mode} K={K}: equals reference(), "
                    f"{st.doorbells} doorbells, {st.command_bytes} B, "
                    f"{st.n_ops} nodes")
        lo, hi = GRAPH_LAW_CHAINS
        ratio = law["multistep", hi] / law["multistep", lo]
        if not (law["per_op", hi] == hi // lo * law["per_op", lo]
                and law["graphed", hi] > law["graphed", lo] and ratio < 1.1):
            raise AssertionError(f"footprint law broken: {law}")
        log(f"footprint law holds from K={lo} to {hi}: per_op x"
            f"{law['per_op', hi] / law['per_op', lo]:.2f}, graphed x"
            f"{law['graphed', hi] / law['graphed', lo]:.2f}, multistep x"
            f"{ratio:.4f}")
        launched += launcher_check(device, sess)
        fits: Dict[str, List[Tuple[int, float]]] = {m: [] for m in LAUNCH_MODES}
        for K in GRAPH_CHAINS:
            for mode in LAUNCH_MODES:
                if mode == "per_op" and K > GRAPH_PER_OP_MAX:
                    continue
                g = ExecGraph(K, GRAPH_WIDTH, device)
                g.upload(mode)
                g.launch(mode, session=sess)                   # warm
                runs = [g.launch(mode, session=sess) for _ in range(GRAPH_REPS)]
                launched += 1 + GRAPH_REPS
                y, st = runs[-1]
                torch.testing.assert_close(y, g.reference(), rtol=1e-5, atol=0)
                launch_us = float(np.median([r.launch_s for _, r in runs])) * 1e6
                complete_us = float(np.median([r.complete_s for _, r in runs])) * 1e6
                fits[mode].append((st.command_bytes, launch_us))
                log(f"{card} | graph_{mode} K={K}: launch {launch_us:.2f} us, "
                    f"complete {complete_us:.2f} us, {st.command_bytes} B, "
                    f"{st.n_ops} nodes, {st.doorbells} doorbells, upload "
                    f"{st.upload_s * 1e3:.3f} ms")
        for mode, pts in fits.items():
            b = np.asarray([p[0] for p in pts], float)
            t = np.asarray([p[1] for p in pts], float)
            if b.std() > 0:
                slope, icpt = np.polyfit(b, t, 1)
                r2 = np.corrcoef(b, t)[0, 1] ** 2
                rate = (f"{1e6 / slope / 2**20:.1f} MiB/s of footprint"
                        if slope > 0 else "no positive slope")
                log(f"{card} | graph_fit_{mode}: launch us = {icpt:.3f} + "
                    f"{slope * 1024:.4f} x KiB of footprint (r^2 {r2:.4f}); "
                    f"{rate}")
            else:
                log(f"{card} | graph_fit_{mode}: footprint constant at "
                    f"{b[0]:.0f} B; launch {t.min():.2f}-{t.max():.2f} us")
        events = sess.summary()["by_kind"].get("graph_launch", 0)
    if events != launched:
        raise AssertionError(f"{launched} launches landed {events} "
                             f"graph_launch events")
    counts = dict(launches)
    log(f"phase G: {launched} launches, {events} graph_launch events, kernel "
        f"launches {counts}")
    return counts


def launcher_check(device: torch.device, sess: TraceSession) -> int:
    """``MultiStepLauncher`` on the card: K=5 steps of ``(carry + b,
    carry.sum())`` as one replay, twice with new inputs, against the same
    steps run eagerly.  Returns its launches."""
    def step(carry, b):
        return carry + b, carry.sum()

    launcher = MultiStepLauncher(step, k=5, session=sess, device=device)
    g = torch.Generator(device=device).manual_seed(3)
    for _ in range(2):
        carry0 = torch.randn(4096, generator=g, device=device)
        batches = torch.randn(5, 4096, generator=g, device=device)
        carry, aux = launcher(carry0, batches)
        want, sums = carry0, []
        for b in batches:
            want, s = step(want, b)
            sums.append(s)
        torch.testing.assert_close(carry, want, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(aux, torch.stack(sums), rtol=1e-5,
                                   atol=1e-4)
    if launcher.tracker.count != 2:
        raise AssertionError(f"MultiStepLauncher: {launcher.tracker.count} "
                             f"doorbells for 2 calls")
    (step_graph, _), = launcher._graphs.values()
    nbytes, nodes = step_graph.footprint()
    log(f"MultiStepLauncher K=5 on the card: equals the eager steps, one "
        f"doorbell a call, {nodes} graph nodes, {nbytes} B")
    return 2


def graph_entry(card: str, device: torch.device,
                counts: Dict[str, int]) -> Dict[str, Any]:
    """The node kernel at phase G's width: one node, its plain version
    (``x.mul_(scale)``, the CPU route) and ``torch.mul`` on the same
    inputs."""
    g = ExecGraph(1, GRAPH_WIDTH, device)
    x0 = torch.randn(GRAPH_WIDTH, device=device)
    g.x.copy_(x0)
    g.upload("per_op")
    node = lambda: g._node(0, _build.stream_ptr(device))  # noqa: E731
    node()
    err = max_err(g.x, x0 * g.scales[0])
    y = torch.empty_like(g.x)
    e = {"name": "exec_graph", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/exec_graph.cu",
         "replaces": "src/repro/core/graphs.py:77",
         "max_abs_err": err,
         "ms": device_ms(node),
         "plain_ms": device_ms(lambda: g.x.mul_(g.scales[0])),
         "call_ms": time_ms(node, reps=100),
         **roofline(node_cost(g.x, g.scales, 0, 0, 0)),
         "library_ms": device_ms(lambda: torch.mul(g.x, g.scales[0], out=y)),
         "shape": f"width={GRAPH_WIDTH} f32, one node",
         "launches_by_path": {"graphs": counts},
         "launches": counts.get("exec_graph", 0)}
    log(f"{card} | exec_graph node at {e['shape']}: device {e['ms']:.5f} ms "
        f"(per call with host {e['call_ms']:.5f} ms), bound "
        f"{e['bound_ms']:.5f} ms, plain {e['plain_ms']:.5f} ms, torch.mul "
        f"{e['library_ms']:.5f} ms, max|err| {err:.3e}, launches in phase G "
        f"{e['launches']}")
    return e


# ---------------------------------------------------------------- phase S
def stage_split(card: str, device: torch.device) -> None:
    """S1: ``benchmarks/bench_submission.py``'s stage split,
    ``tanh(x @ W).sum()`` on one TraceSession: the recorded eager run, the
    capture with instantiate and upload, the first replay's dispatch and
    completion, and the median of the steady replays (each a doorbell)."""
    with TraceSession("stage_split") as sess:
        g = torch.Generator(device=device).manual_seed(0)
        W = torch.randn(S_WIDTH, S_WIDTH, generator=g,
                        device=device) / S_WIDTH ** 0.5
        x = torch.randn(S_BATCH, S_WIDTH, generator=g, device=device)

        def f(x: torch.Tensor) -> torch.Tensor:
            return torch.tanh(x @ W).sum()

        cs = sess.capture.lower_and_compile("stage_split", f, args=(x,))
        t2 = time.perf_counter()
        out = cs.step()
        t3 = time.perf_counter()
        torch.cuda.synchronize(device)
        t4 = time.perf_counter()
        torch.testing.assert_close(out, f(x), rtol=1e-5, atol=1e-4)
        steady = sess.wrap(cs.step, "stage_steady_call", block=True)
        times = []
        for _ in range(S_STEADY):
            t = time.perf_counter()
            steady()
            times.append(time.perf_counter() - t)
        kinds = sess.summary()["by_kind"]
    if (kinds.get("compile"), kinds.get("dispatch")) != (1, S_STEADY):
        raise AssertionError(f"stage split: events {kinds}, expected one "
                             f"compile and {S_STEADY} dispatches")
    stages = {"trace (recorded eager run)": cs.lower_time_s,
              "capture+instantiate+upload": cs.compile_time_s,
              "first replay, dispatch": t3 - t2,
              "first replay, completion": t4 - t3,
              f"steady replay, median of {S_STEADY}": float(np.median(times))}
    for stage, sec in stages.items():
        log(f"{card} | stage_split W={S_WIDTH} B={S_BATCH} fp32 {stage}: "
            f"{sec * 1e6:.1f} us")
    log(f"stage_split graph: {cs.graph_stream.counts_by_opcode()}, "
        f"{cs.command_bytes} B; op-level {cs.stream.counts_by_opcode()}, "
        f"{cs.flops} FLOPs")


def decoded_kernels(graph) -> "collections.Counter[str]":
    """Kernel nodes of a decoded graph by function (``kernel_base``)."""
    return collections.Counter(kernel_base(e.op_path) for e in graph.entries
                               if e.opcode == "kernel")


def held_to_graph(label: str, step, cs) -> Dict[str, int]:
    """S2's checks of one decoded graph: its kernel nodes of the port's
    kernels equal the step's counted launches; all its kernel nodes, by
    function, equal torch.profiler's kernel records over one replay, and
    its copy and fill nodes the profiler's memcpy and memset records; the
    nodes decoded (bodies walked) equal the footprint's node count.  Records
    the tracer lost under the replay (``launch_loss``) are reported and
    counted with the profiler's; nothing else may differ.  The decoded stream's bytes
    are the footprint's by definition.  Returns the node counts by type."""
    nodes = [e for e in cs.graph_stream.entries if e.opcode == "kernel"]
    for name, syms in KERNEL_SYMBOLS.items():
        n = step.launches.get(name, 0)
        for sym in syms:
            seen = sum(of_symbol(sym, e.op_path) for e in nodes)
            if seen > n or (seen < n and sym not in MULTI_CHUNK_ONLY):
                raise AssertionError(f"{label}: {seen} {sym} nodes decoded "
                                     f"for {n} counted {name} launches")
    window = _profile(step, warmup=False, label=label)
    rows = window.rows
    lost = collections.Counter({k: n for k, n in window.lost.items()
                                if k not in ("memcpy", "memset", EAGER_LOSS)})
    # a copy or fill node runs on a copy engine (a "Memcpy"/"Memset"
    # record) or as one of the driver's own kernels (memcpy32_post)
    copies = collections.Counter()
    profiled = collections.Counter()
    full = collections.Counter()
    for e in rows:
        m = DRIVER_COPY.match(e.key)
        if m:
            copies[(m.group(1) or m.group(2)).lower(), e.key] += e.count
        else:
            profiled[kernel_base(e.key)] += e.count
            full[e.key] += e.count
    decoded = decoded_kernels(cs.graph_stream)
    if decoded != profiled + lost:
        raise AssertionError(f"{label}: decoded kernel nodes and the "
                             f"profiler's records differ: decoded only "
                             f"{dict(decoded - profiled - lost)}, profiled "
                             f"only {dict(profiled - decoded)}")
    counts = cs.graph_stream.counts_by_opcode()
    for kind in ("memcpy", "memset"):
        seen = sum(n for (k, _), n in copies.items() if k == kind)
        if counts.get(kind, 0) != seen + window.lost.get(kind, 0):
            raise AssertionError(f"{label}: {counts.get(kind, 0)} {kind} "
                                 f"nodes decoded, the profiler recorded "
                                 f"{dict(copies)}")
    if cs.n_ops != step.footprint()[1]:
        raise AssertionError(f"{label}: {cs.n_ops} nodes decoded, footprint "
                             f"{step.footprint()}")
    same_names = full == collections.Counter(e.op_path for e in nodes)
    sizes = collections.Counter(e.result_bytes for e in cs.graph_stream.entries
                                if e.opcode in ("memcpy", "memset"))
    log(f"{label}: {cs.n_ops} nodes {counts}, {cs.command_bytes} B; kernel "
        f"nodes equal the profiler's {sum(profiled.values())} records (and "
        f"{sum(lost.values())} the tracer lost) by "
        f"function ({'and by full name' if same_names else 'not all by full name'}) "
        f"and the counted launches {dict(step.launches)}; copy and fill nodes "
        f"(bytes: count) {dict(sizes)} equal the profiler's {dict(copies)}; "
        f"top kernels "
        + ", ".join(f"{k} x{n}" for k, n in collections.Counter(
            e.label for e in nodes).most_common(5)))
    return counts


def decode_serving_graphs(path: ServePath, cfg: ModelConfig, params,
                          runs: Dict[int, Dict[str, Any]],
                          t: Dict[str, float], card: str) -> None:
    """S2 and S3 on phase 5's servers: decode each decode graph (and, on the
    dense path, each prefill graph), hold it to the launches, the profiler
    and the footprint; print gemma-2b's T=1 decode graph as Listing 1; then
    each decode graph's roofline beside its measured replay (phase 7)."""
    cap = CommandStreamCapture()
    n_params = sum(x.numel() for x in _leaves(params))
    for T, run in runs.items():
        srv = run["server"]
        for label, step in srv.graphs().items():
            if not (label.startswith("decode") or path is GEMMA):
                continue
            name = f"{cfg.name} T={T} {label}"
            cs = cap.capture_compiled(name, step)
            held_to_graph(name, step, cs)
            if not label.startswith("decode"):
                continue
            if path is GEMMA and T == 1:
                print(render_submission(cs, srv.tracker,
                                        max_entries=S_REPORT_NODES),
                      flush=True)
            B = len(path.prompt_lens)
            rep = analyze(cs, chips=1, model_flops_total=2 * n_params * B * T,
                          name=name)
            ms = t[f"replay_decode_ms_per_step_T{T}"] * T
            bound_ms = rep.step_time_s * 1e3
            eager_ms = t["decode_ms_per_step"] * T
            log(f"{card} | {name} recorded warm-up {step.record_s * 1e3:.1f} "
                f"ms against {eager_ms:.1f} ms eager: the recorder costs "
                f"{(step.record_s * 1e3 - eager_ms) / cs.stream.n_ops * 1e3:.1f}"
                f" us an op-level entry ({cs.stream.n_ops} entries)")
            log(f"{card} | roofline {name}: compute {rep.compute_s * 1e3:.4f}"
                f" ms ({rep.flops_per_device / 1e9:.3f} GFLOP), memory "
                f"{rep.memory_s * 1e3:.4f} ms ({rep.hbm_bytes_per_device / 1e9:.4f}"
                f" GB), bound {bound_ms:.4f} ms ({rep.bottleneck}); measured "
                f"replay {ms:.4f} ms: {bound_ms / ms:.1%} of the roofline; "
                f"model/stream FLOPs {rep.model_flops_ratio:.3f}, "
                f"roofline_fraction {rep.roofline_fraction:.4f}")
            print(render_roofline_row(rep), flush=True)


def decode_exec_graphs(card: str, device: torch.device) -> None:
    """S4: ``ExecGraph``'s graphed chain of S_CHAIN nodes and its multistep
    graph, decoded and held to phase G's footprints' node counts."""
    g = ExecGraph(S_CHAIN, GRAPH_WIDTH, device)
    graphed = g.decode("graphed")
    names = decoded_kernels(graphed)
    if (graphed.counts_by_opcode() != {"kernel": S_CHAIN} or set(names) != {
            "(anonymous namespace)::exec_graph_node_kernel"}):
        raise AssertionError(f"graphed K={S_CHAIN}: decoded "
                             f"{graphed.counts_by_opcode()}, {dict(names)}")
    multistep = g.decode("multistep")
    ops = [e.opcode for e in multistep.entries]
    if ops != ["memset", "conditional", "kernel", "kernel"] or not (
            multistep.unknown_trip_counts):
        raise AssertionError(f"multistep: decoded {ops}, unknown trip counts "
                             f"{multistep.unknown_trip_counts}")
    for mode, st in (("graphed", graphed), ("multistep", multistep)):
        if st.n_ops != g.command_footprint(mode)[1]:
            raise AssertionError(f"{mode}: {st.n_ops} nodes decoded; phase "
                                 f"G's footprint {g.command_footprint(mode)}")
        log(f"ExecGraph {mode} K={S_CHAIN} decoded: {st.counts_by_opcode()}, "
            f"unknown trip counts {st.unknown_trip_counts}; {st.n_ops} nodes "
            f"as phase G's footprint ({st.text_bytes} B, its bytes by "
            f"definition)")
    for e in multistep.entries:
        log("  " + e.describe())


def submission_path(card: str, device: torch.device) -> None:
    log("phase S1: bench_submission's stage split")
    stage_split(card, device)
    log("phase S4: ExecGraph's graphed and multistep graphs decoded")
    decode_exec_graphs(card, device)


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


def profiled_counts(rows, names: Tuple[str, ...]) -> Dict[str, Dict[str, int]]:
    """torch.profiler's launch count of each kernel symbol of each counted
    kernel name (``KERNEL_SYMBOLS``) in ``rows``."""
    return {name: {sym: sum(e.count for e in rows if of_symbol(sym, e.key))
                   for sym in KERNEL_SYMBOLS[name]} for name in names}


def lost_of(sym: str, lost: "collections.Counter[str]") -> int:
    """The records of kernel ``sym`` the tracer lost under graph launches."""
    return sum(c for k, c in lost.items() if of_symbol(sym, k))


def of_symbol(sym: str, key: str) -> bool:
    """Whether a profiler row is one of this repo's kernels named ``sym``
    (they live at namespace scope or in an anonymous namespace; a library's
    kernel of a like name sits in its own namespace)."""
    return re.match(rf"(void )?(\(anonymous namespace\)::)?{re.escape(sym)}",
                    key) is not None


def serve_main_path(path: ServePath, cfg: ModelConfig, params,
                    device: torch.device) -> Dict[int, Dict[str, Any]]:
    """Serve twice at T=1 and at T=4 with one Server each: the first serve
    captures the graphs, the second replays them under torch.profiler.
    Counters are zeroed just before each serve and read just after."""
    model = get_model(cfg, impl="cuda", device=device)
    _, eager = greedy(model, params, padded_prompts(
        requests(path, cfg.vocab_size), device), NEW_TOKENS, path.max_seq)
    runs: Dict[int, Dict[str, Any]] = {}
    for T in (1, 4):
        srv = Server(cfg, batch_size=len(path.prompt_lens),
                     max_seq=path.max_seq, tokens_per_launch=T, device=device,
                     params=params)
        serves: List[Dict[str, Any]] = []
        for replay in (False, True):
            reqs = requests(path, cfg.vocab_size)
            serve: Dict[str, Any] = {}
            reset_launches()
            if replay:
                window = _profile(
                    lambda: serve.update(metrics=srv.serve(reqs)),
                    warmup=False, label=f"{cfg.name} serve T={T} replay")
            else:
                serve["metrics"] = srv.serve(reqs)
            serve["counts"] = dict(launches)
            serve["tokens"] = [r.tokens for r in reqs]
            serves.append(serve)
            log(f"{cfg.name} serve T={T} ({'replay' if replay else 'capture'})"
                f": {serve['metrics']} kernel launches {serve['counts']}")
        prof = profiled_counts(window.rows, path.kernels)
        log(f"{cfg.name} serve T={T} replay: torch.profiler counts {prof}")
        for name, by_sym in prof.items():
            want = serves[1]["counts"].get(name, 0)
            if any(n + lost_of(sym, window.lost) != want
                   for sym, n in by_sym.items()):
                raise AssertionError(f"{cfg.name} T={T}: {want} counted "
                                     f"{name} launches, the profiler saw "
                                     f"{by_sym} and the tracer lost "
                                     f"{dict(window.lost)}")
        for label, g in srv.graphs().items():
            nbytes, nodes = g.footprint()
            log(f"{cfg.name} T={T} graph {label}: {nodes} nodes a replay, "
                f"{nbytes} B verbose description, capture+upload "
                f"{g.upload_s * 1e3:.1f} ms")
        runs[T] = {"server": srv, "serves": serves}
    for T, run in runs.items():
        want = 1 + math.ceil((NEW_TOKENS - 1) / T)
        for serve in run["serves"]:
            if serve["metrics"]["doorbells"] != want:
                raise AssertionError(f"{cfg.name} T={T}: "
                                     f"{serve['metrics']['doorbells']} "
                                     f"doorbells, expected {want}")
            for name in path.kernels:
                if serve["counts"].get(name, 0) < 1:
                    raise AssertionError(f"{cfg.name} T={T}: kernel {name} "
                                         f"was not launched")
            if serve["tokens"] != eager:
                raise AssertionError(f"{cfg.name} T={T}: served tokens differ "
                                     f"from the eager greedy loop")
    if any(len(t) != NEW_TOKENS or not all(0 <= x < cfg.vocab_size for x in t)
           for t in eager):
        raise AssertionError(f"{cfg.name}: tokens out of range or short")
    log(f"{cfg.name}: tokens of both serves at T=1 and T=4 equal the eager "
        f"greedy loop's")
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


@contextlib.contextmanager
def experts_held(calls: List[torch.Tensor], flips: List[int]
                 ) -> Iterator[None]:
    """While open, the MoE router (``models/moe.py::_router``) records its
    expert choices into ``calls``, call by call, if ``calls`` is empty at
    entry; else it replays them in order: each call takes the recorded
    choices, weighted by its own probabilities renormalised over them, and
    appends to ``flips`` the tokens whose own choice differed."""
    router = moe_module._router
    record = not calls
    replayed = iter(list(calls))

    def held(p, cfg, x):
        w, ids, aux = router(p, cfg, x)
        if record:
            calls.append(ids)
            return w, ids, aux
        want = next(replayed)
        probs = torch.softmax(x.float() @ p["router"], dim=-1)
        w = probs.gather(-1, want)
        flips.append(int((ids != want).any(dim=-1).sum()))
        return w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9), \
            want, aux

    moe_module._router = held
    try:
        yield
    finally:
        moe_module._router = router


def held_log(cfg: ModelConfig, label: str, calls: List[torch.Tensor],
             flips: List[int]) -> None:
    if calls:
        pairs = sum(c.shape[0] * c.shape[1] for c in calls)
        log(f"{cfg.name} {label}: expert choices held to the kernel route's "
            f"({len(calls)} router calls); the route's own top-k differed "
            f"at {sum(flips)} of {pairs} (token, router call) pairs")


def compare_bf16(path: ServePath, cfg: ModelConfig, params,
                 device: torch.device) -> Dict[str, float]:
    """Phase 6's bf16 half: prefill logits of the kernel route against the
    plain route (and the control) on the path's weights; every reading is
    logged before any check fails."""
    toks = padded_prompts(requests(path, cfg.vocab_size), device)
    kern = get_model(cfg, impl="cuda", device=device)
    plain = get_model(cfg, impl="ref", device=device)
    ssd_errors: List[Tuple[float, float]] = []
    calls: List[torch.Tensor] = []
    flips: List[int] = []
    with experts_held(calls, flips), ssd_held_to_plain(ssd_errors):
        _, lk = kern.prefill(params, toks, path.max_seq)
    if ssd_errors:
        worst = max(ssd_errors)
        log(f"{cfg.name} ssd_scan held to its plain version on each layer's "
            f"own inputs: {len(ssd_errors)} layers, max|err| {worst[0]:.3e} "
            f"(|y| up to {max(m for _, m in ssd_errors):.2f}; rtol=atol="
            f"{TOL['ssd_scan'][getattr(torch, cfg.param_dtype)]})")
    with experts_held(calls, flips):
        _, lp = plain.prefill(params, toks, path.max_seq)
    held_log(cfg, "bf16 prefill, plain route", calls, flips)
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
        flips = []
        with experts_held(calls, flips):
            _, lc = ctrl.prefill(params, toks, path.max_seq)
        held_log(cfg, "bf16 prefill, control", calls, flips)
        out["bf16_control_rel_l2"] = rel_c = rel_l2(lc, lp)
        limit = max(limit, CONTROL_FACTOR * rel_c)
        log(f"{cfg.name} bf16 prefill logits, control (plain route with "
            f"{path.control}) vs plain route: relative L2 {rel_c:.3e}, "
            f"max|err| {max_err(lc, lp):.3e}")
        del lc
    log(f"{cfg.name} bf16 prefill logits, kernel vs plain route: relative L2 "
        f"{rel:.3e} (limit {limit:.3e}), max|err| {max_err(lk, lp):.3e}")
    del lk, lp
    if rel > limit:
        raise AssertionError("bf16 prefill logits disagree between routes")
    return out


def compare_fp32(path: ServePath, cfg: ModelConfig, device: torch.device,
                 seed: int = 0) -> float:
    """Phase 6's fp32 half: the fp32 variant's prefill logits and 8 greedy
    tokens, kernel route against plain route, on its own seeded weights."""
    toks = padded_prompts(requests(path, cfg.vocab_size), device)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    kern32 = get_model(cfg32, impl="cuda", device=device)
    plain32 = get_model(cfg32, impl="ref", device=device)
    params32 = kern32.init_params(seed)
    calls: List[torch.Tensor] = []
    flips: List[int] = []
    with experts_held(calls, flips):
        lk, tk = greedy(kern32, params32, toks, 8, path.max_seq)
    with experts_held(calls, flips):
        lp, tp = greedy(plain32, params32, toks, 8, path.max_seq)
    held_log(cfg, "fp32 prefill and decode, plain route", calls, flips)
    err = max_err(lk, lp)
    log(f"{cfg.name} fp32 prefill logits max|err| {err:.3e} (tol "
        f"{path.fp32_abs_tol}); greedy tokens kernel {tk} plain {tp}")
    del params32, lk, lp
    free()
    if err > path.fp32_abs_tol or tk != tp:
        raise AssertionError("fp32 routes disagree")
    return err


# ---------------------------------------------------------------- phase 7
def _cupti() -> Optional[ctypes.CDLL]:
    """The libcupti that torch.profiler loaded in this process, or None."""
    with open("/proc/self/maps") as maps:
        paths = sorted({line.split()[-1] for line in maps if "libcupti" in line})
    return ctypes.CDLL(paths[0]) if paths else None


def cupti_dropped() -> Optional[int]:
    """CUPTI's count of the activity records it dropped for want of buffer
    space since the last read, which resets it: read from the libcupti that
    torch.profiler uses in this process; None where none is loaded."""
    lib = _cupti()
    if lib is None:
        return None
    n = ctypes.c_size_t()
    err = lib.cuptiActivityGetNumDroppedRecords(None, ctypes.c_uint32(0),
                                                ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuptiActivityGetNumDroppedRecords: error {err}")
    return n.value


def cupti_flush() -> None:
    """``cuptiActivityFlushAll(CUPTI_ACTIVITY_FLAG_FLUSH_FORCED)``: hand every
    activity buffer, the incomplete ones too, to the profiler now, before
    its window closes."""
    lib = _cupti()
    if lib is not None:
        err = lib.cuptiActivityFlushAll(ctypes.c_uint32(1))
        if err:
            raise RuntimeError(f"cuptiActivityFlushAll: error {err}")


def _logged_replay(graph, order: List[Any]) -> None:
    order.append(graph)
    _REPLAY(graph)


_REPLAY = torch.cuda.CUDAGraph.replay


@contextlib.contextmanager
def graph_replays_logged(order: List[Any]) -> Iterator[None]:
    """Every ``torch.cuda.CUDAGraph`` replayed in the block appended to
    ``order``, in launch order."""
    torch.cuda.CUDAGraph.replay = lambda g: _logged_replay(g, order)
    try:
        yield
    finally:
        torch.cuda.CUDAGraph.replay = _REPLAY


def _window(fn: Callable[[], Any], reps: int = 1):
    """torch.profiler over ``reps`` calls of ``fn``, the graphs the calls
    replayed (``graph_replays_logged``), CUPTI's dropped-record count over
    the window, and the host wall time of the calls in us.

    Every window opens with ``SENTINELS`` spin kernels: the tracer drops the
    first kernel records of a window, none early in a process and more the
    more records the process has traced (``scripts/profiler_record_loss.py``;
    later in this script, the first norm of a graph that begins with the
    embedding and its scale, in every window), and CUPTI's dropped-record
    count does not see it.  The sentinels take that loss.  Before the window
    closes, every CUPTI buffer is flushed (``cupti_flush``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    order: List[Any] = []
    cupti_dropped()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # margins inside the trace window, outside the timed one: the tracer
        # drops device records whose converted timestamps fall outside it
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(SENTINELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with graph_replays_logged(order):
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        cupti_flush()
        time.sleep(PROFILE_MARGIN_S)
    return prof, order, cupti_dropped(), wall_us


# a kernel launch of the runtime API (every kernel of this repository goes
# through it) and a graph launch; a library's kernel launched through the
# driver API is not held launch by launch, only counted by name
KERNEL_LAUNCH = re.compile(r"^cudaLaunch(Kernel|CooperativeKernel)")
GRAPH_LAUNCH = re.compile(r"^cu(da)?GraphLaunch")
EAGER_LOSS = "<eager launch>"    # a kernel lost under an eager launch


def record_kind(name: str) -> str:
    """A device record's kind: ``memcpy``/``memset`` for a copy or fill
    (``DRIVER_COPY``), else its kernel's function (``kernel_base``)."""
    m = DRIVER_COPY.match(name)
    return (m.group(1) or m.group(2)).lower() if m else kernel_base(name)


def graph_nodes(graph) -> "collections.Counter[str]":
    """The records one replay of ``graph`` must leave: its decoded kernel
    nodes by function, its copy and fill nodes by kind."""
    out: "collections.Counter[str]" = collections.Counter()
    for e in decode_graph(graph).entries:
        if e.opcode == "kernel":
            out[kernel_base(e.op_path)] += 1
        elif e.opcode in ("memcpy", "memset"):
            out[e.opcode] += 1
    return out


def launch_loss(prof, order: List[Any], label: str,
                nodes: Optional[Dict[int, "collections.Counter[str]"]] = None
                ) -> Tuple["collections.Counter[str]", List[int]]:
    """Match the window's device records to their launches by correlation
    id: each graph launch (the replays in ``order``) to its graph's nodes
    (``graph_nodes``, or ``nodes`` by the graph's id), each eager kernel
    launch after the sentinels to one record.  Records beyond a launch's
    nodes, an eager launch with more than one record, or graph launches
    that are not the logged replays raise.  Returns the records missing
    under the launches (an eager launch's as ``EAGER_LOSS``: its kernel is
    not named) and the positions of the graph launches short of records."""
    events = list(prof.profiler.kineto_results.events())
    under: Dict[int, "collections.Counter[str]"] = collections.defaultdict(
        collections.Counter)
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            under[e.correlation_id()][record_kind(e.name())] += 1
    host = sorted((e for e in events
                   if e.device_type() != torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.start_ns())
    graphs = [e.correlation_id() for e in host if GRAPH_LAUNCH.match(e.name())]
    eager = [e.correlation_id() for e in host
             if KERNEL_LAUNCH.match(e.name())][SENTINELS:]
    if len(graphs) != len(order):
        raise AssertionError(f"{label}: {len(order)} graph replays, the "
                             f"profiler recorded {len(graphs)} graph launches")
    nodes = {} if nodes is None else dict(nodes)
    lost: "collections.Counter[str]" = collections.Counter()
    short = []
    for i, (g, corr) in enumerate(zip(order, graphs)):
        if id(g) not in nodes:
            nodes[id(g)] = graph_nodes(g)
        got, want = under[corr], nodes[id(g)]
        if got - want:
            raise AssertionError(f"{label}: graph launch {i} recorded "
                                 f"{dict(got - want)} beyond its graph's "
                                 f"nodes")
        if want - got:
            lost += want - got
            short.append(i)
    for corr in eager:
        n = sum(under[corr].values())
        if n > 1:
            raise AssertionError(f"{label}: one eager launch recorded "
                                 f"{dict(under[corr])}")
        lost[EAGER_LOSS] += 1 - n
    return +lost, short


def report_loss(label: str, lost, short: List[int], n_graphs: int,
                dropped: Optional[int]) -> None:
    if lost or dropped:
        log(f"{label}: tracer loss: {sum(lost.values())} device records "
            f"missing under {len(short)} of {n_graphs} graph launches "
            f"(launches {short[:8]}) and {lost.get(EAGER_LOSS, 0)} eager "
            f"launches, {dict(lost.most_common(4))}; CUPTI's dropped-record "
            f"count over the window {dropped}")


@dataclasses.dataclass
class Window:
    """One held profiler window: the kernel rows (sentinels left out), the
    host wall time, and the records the tracer lost under the launches."""
    rows: List[Any]
    wall_us: float
    lost: "collections.Counter[str]"


def _profile(fn: Callable[[], Any], reps: int = 1, warmup: bool = True,
             label: str = "profiler window", retakes: int = 0) -> Window:
    """torch.profiler over ``reps`` calls of ``fn`` (``_window``), held to
    what ran: the profiler's records matched to their launches
    (``launch_loss``), and its count of every counted kernel to the launches
    counted in the window (``held_to_counts``).  A record missing under a
    launch is the tracer's loss: it prints as a ``tracer loss`` line, and
    the window is taken again up to ``retakes`` times, then raises if
    ``retakes`` is set.  Any other mismatch raises.  Raises unless a
    sentinel is left."""
    if warmup:
        fn()
    for attempt in range(retakes + 1):
        before = collections.Counter(launches)
        prof, order, dropped, wall_us = _window(fn, reps)
        counted = collections.Counter(launches)
        counted.subtract(before)
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if not any(SENTINEL in e.key for e in rows):
            raise RuntimeError(f"torch.profiler recorded no {SENTINEL} of the "
                               f"window's {SENTINELS} sentinels")
        rows = [e for e in rows if SENTINEL not in e.key]
        lost, short = launch_loss(prof, order, label)
        held_to_counts(rows, +counted, lost, label)
        report_loss(label, lost, short, len(order), dropped)
        if not lost:
            break
    else:
        if retakes:
            raise RuntimeError(f"{label}: the tracer lost records in "
                               f"{retakes + 1} windows in a row")
    return Window(rows, wall_us, lost)


def held_to_counts(rows, counted: Dict[str, int],
                   lost: "collections.Counter[str]", label: str) -> None:
    """Every kernel symbol of a counted name (``KERNEL_SYMBOLS``) recorded
    once per counted launch, less the records the tracer lost: those of
    its symbol under a graph launch, and, up to their number, those under
    eager launches (whose kernel is not named); the SSD scan's state and
    state-passing kernels at most once (a one-chunk call runs neither)."""
    eager_budget = lost.get(EAGER_LOSS, 0)
    for name, syms in KERNEL_SYMBOLS.items():
        n = counted.get(name, 0)
        for sym in syms:
            seen = sum(e.count for e in rows if of_symbol(sym, e.key))
            missing = sum(c for k, c in lost.items() if of_symbol(sym, k))
            gap = n - seen - missing
            if sym in MULTI_CHUNK_ONLY:
                gap = min(gap, 0)
            if seen > n or gap < 0 or gap > eager_budget:
                raise RuntimeError(
                    f"{label}: torch.profiler recorded {seen} {sym} for {n} "
                    f"counted {name} launches, {missing} lost under graph "
                    f"launches and {eager_budget} eager launches lost")
            eager_budget -= gap


def device_ms(fn: Callable[[], Any], reps: int = 20) -> float:
    """Device time per call: the kernels' own time, without host gaps."""
    return sum(device_ms_by_kernel(fn, reps).values())


def device_ms_by_kernel(fn: Callable[[], Any], reps: int = 20
                        ) -> Dict[str, float]:
    """Device time per call of each kernel ``fn`` launches, by name.

    The kernels of one call are counted in a window of their own; the timed
    window of ``reps`` calls must record ``reps`` times as many of each, or
    a record went missing and the time would read low.  A window whose
    records the tracer lost is taken again, up to 3 times, then raises: no
    time is read from it."""
    one = _profile(fn, label="device_ms one call", retakes=3).rows
    rows = _profile(fn, reps, warmup=False, label=f"device_ms {reps} calls",
                    retakes=3).rows
    if not rows:
        raise RuntimeError("torch.profiler recorded no kernel on the card")
    want = {e.key: reps * e.count for e in one}
    got = {e.key: e.count for e in rows}
    if got != want:
        raise RuntimeError(f"torch.profiler recorded {got} kernels over "
                           f"{reps} calls, {reps} times one call's: {want}")
    return {e.key: e.self_device_time_total / reps / 1e3 for e in rows}


def profile_window(fn: Callable[[], Any], label: str, top: int = 8,
                   kernels: Tuple[str, ...] = ()) -> float:
    """Device time by kernel over one call of ``fn``, the device's busy share
    of the window's wall time (one stream: kernels do not overlap), and the
    share of device time taken by each kernel named in ``kernels``.
    Returns the busy share.  A window the tracer lost records of is taken
    again (``_profile``'s retakes)."""
    w = _profile(fn, label=label, retakes=3)
    rows, wall_us = w.rows, w.wall_us
    busy_us = sum(e.self_device_time_total for e in rows)
    log(f"{label}: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f}"
        f" ms ({busy_us / wall_us:.1%}), {sum(e.count for e in rows)} kernel "
        f"launches")
    for name in kernels:
        mine = [e for e in rows if name in e.key]
        us = sum(e.self_device_time_total for e in mine)
        log(f"  {name} kernel: {us / 1e3:.3f} ms in {sum(e.count for e in mine)}"
            f" launches, {us / busy_us:.1%} of the device time")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    return busy_us / wall_us


def time_path(path: ServePath, cfg: ModelConfig, params,
              device: torch.device, runs: Dict[int, Dict[str, Any]]
              ) -> Dict[str, float]:
    """Both routes: the model's eager calls, and the servers' graph
    replays (one prefill, one T-step decode block); then a warm serve of
    each server, unprofiled, for tokens/s."""
    model = get_model(cfg, impl="cuda", device=device)
    toks = padded_prompts(requests(path, cfg.vocab_size), device)
    prefill_ms = time_ms(lambda: model.prefill(params, toks, path.max_seq),
                         reps=5)
    state, logits = model.prefill(params, toks, path.max_seq)
    nxt = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)

    def one_step():
        model.decode_step(params, state, nxt)
    decode_ms = time_ms(one_step, reps=16, warmup=2)
    profile_window(lambda: model.prefill(params, toks, path.max_seq),
                   f"{cfg.name} prefill profile (eager)", kernels=path.kernels)
    profile_window(one_step, f"{cfg.name} decode step profile (eager)")
    del state, logits

    out = {"prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms}
    S = max(path.prompt_lens)
    graphs = {T: run["server"].graphs() for T, run in runs.items()}
    prefill = graphs[1][f"prefill S={S}"]
    out["replay_prefill_ms"] = time_ms(prefill, reps=5)
    profile_window(prefill, f"{cfg.name} prefill profile (one replay)",
                   kernels=path.kernels)
    for T in runs:
        decode = graphs[T][f"decode T={T}"]
        out[f"replay_decode_ms_per_step_T{T}"] = time_ms(
            decode, reps=16 // T, warmup=2) / T
        profile_window(decode, f"{cfg.name} decode T={T} profile (one "
                       f"replay)")
        # busy: the replay's kernel time over its span on the device (CUDA
        # events around one replay), both without the profiler's own cost
        busy_ms = device_ms(decode, reps=4)
        span_ms = time_ms(decode, reps=1, warmup=1)
        out[f"replay_decode_busy_T{T}"] = busy_ms / span_ms
        log(f"{cfg.name} decode T={T} replay: {busy_ms:.3f} ms of kernels in "
            f"a {span_ms:.3f} ms span, device busy {busy_ms / span_ms:.1%}")
    for T, run in runs.items():
        reqs = requests(path, cfg.vocab_size)
        m = run["server"].serve(reqs)
        if [r.tokens for r in reqs] != run["serves"][0]["tokens"]:
            raise AssertionError(f"{cfg.name} T={T}: the warm serve's tokens "
                                 f"differ")
        # host time to enqueue each doorbell (one replay) of the warm serve
        recs = run["server"].tracker.records[-m["doorbells"]:]
        out[f"replay_enqueue_us_prefill_T{T}"] = recs[0].dispatch_s * 1e6
        out[f"replay_enqueue_us_decode_T{T}"] = float(np.median(
            [r.dispatch_s for r in recs[1:]])) * 1e6
        out[f"warm_tokens_per_s_T{T}"] = m["new_tokens"] / m["wall_s"]
        out[f"warm_serve_wall_s_T{T}"] = m["wall_s"]
        out[f"capture_serve_wall_s_T{T}"] = run["serves"][0]["metrics"][
            "wall_s"]
        # the capturing serve ran inside record_captures(): each graph's
        # eager warm-up under the op recorder (phase S2-S3)
        out[f"capture_record_s_T{T}"] = sum(
            step.record_s for step in run["server"].graphs().values())
    return out


def init_path(path: ServePath, device: torch.device) -> Tuple[ModelConfig,
                                                                 Any]:
    """Phase 4: the path's config (its depth cut logged) and seeded
    on-device weights."""
    log(f"phase 4: {path.arch} at full width, seeded on-device init")
    cfg = path.cfg
    if path.n_layers is not None:
        log(f"{cfg.name}: depth cut to {path.n_layers} of "
            f"{ARCHS[path.arch].n_layers} layers (all of one card's memory "
            f"would not hold the published depth)")
    params = get_model(cfg, impl="cuda", device=device).init_params(seed=0)
    leaves = _leaves(params)
    log(f"{cfg.name}: {sum(t.numel() for t in leaves) / 1e9:.3f} B parameters, "
        f"{sum(t.numel() * t.element_size() for t in leaves) / 1e9:.2f} GB "
        f"({cfg.param_dtype}, fp32 where the reference keeps fp32)")
    return cfg, params


def drive_path(path: ServePath, card: str, device: torch.device,
               then: Optional[Callable[[ModelConfig, Any], None]] = None
               ) -> Dict[int, Dict[str, int]]:
    """Phases 4-7 for one path, then ``then(cfg, params)`` on its weights;
    phase 6's fp32 half runs last, once the bf16 weights are released (an
    fp32 copy of the larger paths does not fit beside them).  Returns the
    kernel launches of its serves at T=1 and T=4 (the replayed serve, and
    the capturing one)."""
    cfg, params = init_path(path, device)
    log(f"phase 5: {path.arch} Server.serve, the main path")
    with record_captures():                     # for phase S2-S3
        runs = serve_main_path(path, cfg, params, device)
    log(f"phase 6: {path.arch} kernel route against the plain route, bf16")
    compare_bf16(path, cfg, params, device)
    log(f"phase 7: {path.arch} timings")
    t = time_path(path, cfg, params, device, runs)
    log(f"phase S2-S3: {path.arch} serving graphs decoded, their roofline")
    decode_serving_graphs(path, cfg, params, runs, t, card)
    B = len(path.prompt_lens)
    log(f"{card} | {cfg.name} B={B} prompts {path.prompt_lens} new "
        f"{NEW_TOKENS}: eager prefill {t['prefill_ms']:.3f} ms, decode "
        f"{t['decode_ms_per_step']:.3f} ms/step ({B} tokens); replayed "
        f"prefill {t['replay_prefill_ms']:.3f} ms, decode "
        f"{t['replay_decode_ms_per_step_T1']:.3f} ms/step (T=1), "
        f"{t['replay_decode_ms_per_step_T4']:.3f} ms/step (T=4), device busy "
        f"over one decode replay {t['replay_decode_busy_T1']:.1%} (T=1), "
        f"{t['replay_decode_busy_T4']:.1%} (T=4); warm serve "
        f"{t['warm_tokens_per_s_T1']:.1f} tokens/s (wall "
        f"{t['warm_serve_wall_s_T1']:.3f} s, T=1), "
        f"{t['warm_tokens_per_s_T4']:.1f} tokens/s (wall "
        f"{t['warm_serve_wall_s_T4']:.3f} s, T=4); capturing serve wall "
        f"{t['capture_serve_wall_s_T1']:.3f} s (T=1), "
        f"{t['capture_serve_wall_s_T4']:.3f} s (T=4), of which the op "
        f"recorder's warm-ups {t['capture_record_s_T1']:.3f} s (T=1), "
        f"{t['capture_record_s_T4']:.3f} s (T=4); host time to enqueue "
        f"a replay: prefill {t['replay_enqueue_us_prefill_T1']:.1f} us, "
        f"decode median {t['replay_enqueue_us_decode_T1']:.1f} us (T=1), "
        f"{t['replay_enqueue_us_decode_T4']:.1f} us (T=4)")
    counts = {T: {"replay": run["serves"][1]["counts"],
                  "capture": run["serves"][0]["counts"]}
              for T, run in runs.items()}
    del runs
    free()
    if then is not None:
        then(cfg, params)
    del params
    free()
    log(f"phase 6: {path.arch} kernel route against the plain route, fp32 "
        f"at full depth, after the bf16 weights are released")
    compare_fp32(path, cfg, device)
    return counts


# ---------------------------------------------------------------- phase C
def loadtest_line(card: str, arch: str, T: int, label: str,
                  m: Dict[str, Any], eng: ContinuousBatchingServer,
                  decode: Any) -> None:
    """One line per replay; ``decode`` is the engine's decode graph as
    captured when the engine was built."""
    decode_graph_once(eng, decode)
    n_prefill = sum(1 for k in eng.graphs() if k.startswith("prefill"))
    log(f"{card} | loadtest {arch} T={T} spec={label}: doorbells "
        f"{m['doorbells']}, tok/doorbell {m['tokens_per_doorbell']:.3f}, "
        f"tokens/s {m['tokens_per_s']:.1f}, p50/p99 "
        f"{m['latency_p50_s'] * 1e3:.3f}/{m['latency_p99_s'] * 1e3:.3f} ms, "
        f"TTFT p50 {m['ttft_p50_s'] * 1e3:.3f} ms, prefill graphs "
        f"{n_prefill}, decode captures 1 ({m['requests']} requests, "
        f"{m['completed']} completed, {m['evicted']} evicted, "
        f"{m['rejected']} rejected, {m['new_tokens']} new tokens, wall "
        f"{m['wall_s']:.3f} s)")


def decode_graph_once(eng: ContinuousBatchingServer, graph) -> None:
    """The engine's decode is one graph for its life: the object captured
    when the engine was built, never captured again."""
    (key,) = [k for k in eng.graphs() if k.startswith("decode")]
    step = eng.graphs()[key]
    if step.graph is not graph:
        raise AssertionError(f"{eng.cfg.name}: the decode graph was "
                             f"captured again")


def bf16_step(x: float) -> float:
    """One bf16 step (unit in the last place) at magnitude |x|."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def oneshot_logits_at(model, params, prompt: np.ndarray, tokens: List[int],
                      j: int, max_seq: int, device: torch.device
                      ) -> torch.Tensor:
    """The one-shot's logits for its token ``j``: prefill, then its own
    tokens fed back (teacher-forced), batch 1, eager."""
    toks = torch.from_numpy(np.asarray(prompt, np.int32)[None]).to(device)
    state, logits = model.prefill(params, toks, max_seq)
    for t in tokens[:j]:
        nxt = torch.tensor([[t]], dtype=torch.int32, device=device)
        state, logits = model.decode_step(params, state, nxt)
    return logits[0, -1].float()


def near_tie(model, params, t, want: List[int], max_seq: int,
             device: torch.device, label: str, against: str) -> bool:
    """Whether ``t``'s tokens first differ from ``want`` (the same request
    served otherwise) where the one-shot's logits, teacher-forced on
    ``want``, hold a near-tie: a top-2 gap below one bf16 step of the top
    logit."""
    j = next(i for i, (a, b) in enumerate(zip(want, t.tokens)) if a != b)
    logits = oneshot_logits_at(model, params, t.request.prompt, want, j,
                               max_seq, device)
    top = logits.topk(2).values.tolist()
    gap, step = top[0] - top[1], bf16_step(top[0])
    log(f"{label}: uid {t.uid} differs from {against} at token {j} "
        f"of {len(t.tokens)}: one-shot top-2 logits {top[0]:.5f} / "
        f"{top[1]:.5f}, gap {gap:.5f} against one bf16 step {step:.5f}"
        f" ({'a near-tie' if gap < step else 'NOT a near-tie'})")
    return gap < step


def check_against_oneshot(cfg: ModelConfig, params, tickets, n: int,
                          max_seq: int, device: torch.device, exact: bool,
                          label: str) -> None:
    """The first ``n`` served requests re-decoded one by one through a
    one-shot ``Server(batch_size=1)`` on the engine's params.  ``exact``:
    every token equal; else the first differing position must be a near-tie
    of the one-shot (its top-2 logit gap below one bf16 step of its top
    logit)."""
    served = [t for t in tickets if t.status in ("done", "evicted")][:n]
    solo = Server(cfg, batch_size=1, max_seq=max_seq, tokens_per_launch=1,
                  device=device, params=params)
    equal, ties = 0, []
    for t in served:
        r = Request(t.uid, t.request.prompt, max_new_tokens=len(t.tokens))
        solo.serve([r])
        if r.tokens == t.tokens:
            equal += 1
            continue
        ties.append((t.uid, near_tie(solo.model, params, t, r.tokens,
                                     max_seq, device, label, "the one-shot")))
    log(f"{label}: {equal}/{len(served)} requests equal the one-shot "
        f"Server(batch_size=1) token for token"
        + ("" if exact else f"; {len(ties)} differ at a near-tie"
           if all(ok for _, ok in ties) else ""))
    del solo
    if exact and equal != len(served):
        raise AssertionError(f"{label}: tokens differ from the one-shot")
    if not all(ok for _, ok in ties):
        raise AssertionError(f"{label}: a difference from the one-shot at "
                             f"a position that is no near-tie")
    if len(served) != n:
        raise AssertionError(f"{label}: {len(served)} served requests, "
                             f"expected {n}")


def free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def c1_runs(card: str, arch: str, cfg: ModelConfig, params,
            device: torch.device, ts: Tuple[int, ...] = C1_TS
            ) -> Dict[int, Dict[str, int]]:
    """C1: the reference's load spec at each T of ``ts`` (1, 4, 8), every
    replay synchronous: a warm one, the measured one (counts zeroed just
    before, read just after), then the same traffic once more under
    torch.profiler, whose counted launches must equal the measured replay's
    and the profiler's count of the same kernels.  Returns the measured
    replays' kernel launches by T."""
    kernels = C_KERNELS[arch]
    counts_by_T: Dict[int, Dict[str, int]] = {}
    for T in ts:
        eng = ContinuousBatchingServer(cfg, tokens_per_launch=T,
                                       device=device, params=params,
                                       **C1_ENGINE)
        decode = eng.graphs()[f"decode T={T}"].graph
        replay(eng, generate(TrafficSpec(**C1_SPEC), cfg.vocab_size),
               realtime=False)
        reset_launches()
        tickets, m = replay(eng, generate(TrafficSpec(**C1_SPEC), cfg.vocab_size),
                            realtime=False)
        counts = dict(launches)
        loadtest_line(card, cfg.name, T, "bench_loadtest", m, eng, decode)
        reset_launches()
        window = _profile(lambda: replay(
            eng, generate(TrafficSpec(**C1_SPEC), cfg.vocab_size), realtime=False),
            warmup=False, label=f"{cfg.name} C1 T={T} profiled replay")
        if dict(launches) != counts:
            raise AssertionError(f"{cfg.name} C1 T={T}: the profiled replay "
                                 f"counted {dict(launches)}, the measured "
                                 f"one {counts}")
        prof = profiled_counts(window.rows, kernels)
        log(f"{cfg.name} C1 T={T} measured replay: kernel launches {counts},"
            f" torch.profiler over the same traffic replayed again {prof}; "
            f"kv {m['kv']}")
        want = {"requests": 32, "completed": 32, "evicted": 0, "rejected": 0,
                "new_tokens": C1_NEW_TOKENS, "doorbells": C1_DOORBELLS[T]}
        got = {k: m[k] for k in want}
        by_name = collections.Counter(
            r.name for r in eng.tracker.records[-m["doorbells"]:])
        prefill_graphs = sorted(k for k in eng.graphs()
                                if k.startswith("prefill"))
        if got != want:
            raise AssertionError(f"{cfg.name} C1 T={T}: {got}, expected "
                                 f"{want}")
        if by_name["prefill"] + by_name["decode_slots"] != m["doorbells"]:
            raise AssertionError(f"{cfg.name} C1 T={T}: doorbells {by_name}"
                                 f" are not prefills plus decodes")
        if prefill_graphs != ["prefill S=4", "prefill S=8"]:
            raise AssertionError(f"{cfg.name} C1 T={T}: prefill graphs "
                                 f"{prefill_graphs}")
        for name, by_sym in prof.items():
            n = counts.get(name, 0)
            if n < 1 or any(c + lost_of(sym, window.lost) != (
                    0 if sym in MULTI_CHUNK_ONLY else n)
                            for sym, c in by_sym.items()):
                raise AssertionError(f"{cfg.name} C1 T={T}: {n} counted "
                                     f"{name} launches, the profiler saw "
                                     f"{by_sym} and the tracer lost "
                                     f"{dict(window.lost)}")
        counts_by_T[T] = counts
        if T == 1:
            check_against_oneshot(cfg, params, tickets, 4, C1_ENGINE[
                "max_seq"], device, exact=False,
                label=f"{cfg.name} C1 T=1 bf16")
        del eng
        free()
    return counts_by_T


def c1_fp32(card: str, device: torch.device) -> None:
    """gemma-2b in fp32 on C1's spec at T=1: the first 8 served requests
    equal the one-shot's tokens exactly."""
    cfg = dataclasses.replace(ARCHS[GEMMA.arch], param_dtype="float32")
    params = get_model(cfg, impl="cuda", device=device).init_params(seed=0)
    eng = ContinuousBatchingServer(cfg, tokens_per_launch=1, device=device,
                                   params=params, **C1_ENGINE)
    tickets, m = replay(eng, generate(TrafficSpec(**C1_SPEC), cfg.vocab_size),
                        realtime=False)
    loadtest_line(card, f"{cfg.name} fp32", 1, "bench_loadtest", m, eng,
                  eng.graphs()["decode T=1"].graph)
    if m["doorbells"] != C1_DOORBELLS[1] or m["new_tokens"] != C1_NEW_TOKENS:
        raise AssertionError(f"{cfg.name} fp32 C1: {m}")
    check_against_oneshot(cfg, params, tickets, 8, C1_ENGINE["max_seq"],
                          device, exact=True, label=f"{cfg.name} C1 T=1 fp32")
    del eng, params, tickets
    free()


def span_stats(eng: ContinuousBatchingServer, since: int, name: str
               ) -> List[float]:
    return [e.dur_s for e in eng.session.timeline()[since:]
            if e.name == SPAN_EVENT and e.meta.get("span") == name]


def poll_live(eng: ContinuousBatchingServer, url: str, done0: int, k: int,
              out: Dict[str, Any]) -> None:
    """One GET of the live summary from the decode loop itself, after the
    first step that leaves a slot active once ``k`` requests of this run
    have finished (``done0``: the done tickets before it).  The loop waits
    on the GET, so the finished tickets, tokens and doorbells read beside
    the snapshot are those it describes."""
    step = eng.step

    def stepped() -> bool:
        busy = step()
        tickets = list(eng.tickets)
        done = sum(1 for t in tickets if t.status == "done")
        if "snapshot" not in out and eng.n_active > 0 and done - done0 >= k:
            with urllib.request.urlopen(f"{url}/summary", timeout=30) as resp:
                out["snapshot"] = json.loads(resp.read())
            out["now"] = {"active": eng.n_active, "done": done,
                          "tokens_emitted": sum(len(t.tokens)
                                                for t in tickets),
                          "doorbells": eng.tracker.count}
        return busy
    eng.step = stepped


def check_live_poll(label: str, out: Dict[str, Any], done0: int, k: int
                    ) -> None:
    """The mid-run snapshot against the engine at that moment: its active
    slots, done tickets, tokens, ``serve.finish`` events and dispatches
    all equal what the decode loop held, and this run had finished at
    least ``k`` requests."""
    snap, now = out.get("snapshot"), out.get("now")
    if snap is None:
        raise AssertionError(f"{label}: no live poll mid-run")
    e = snap["engine"]
    got = {"active": e["active"], "done": e["tickets"]["done"],
           "finish events": snap["by_name"].get("serve.finish", {}).get(
               "events", 0),
           "tokens_emitted": e["tokens_emitted"],
           "dispatches": snap["by_kind"].get("dispatch", 0)}
    want = {"active": now["active"], "done": now["done"],
            "finish events": now["done"],
            "tokens_emitted": now["tokens_emitted"],
            "dispatches": now["doorbells"]}
    log(f"{label} live poll mid-run, after {now['done'] - done0} of this "
        f"run's requests finished: {got}; the engine at that moment: {want}")
    if got != want or now["active"] < 1 or now["done"] - done0 < k:
        raise AssertionError(f"{label}: the live summary {got} disagrees "
                             f"with the engine {want}")


def c2_runs(card: str, arch: str, cfg: ModelConfig, params,
            device: torch.device) -> None:
    """C2: realistic prompts and budgets.  For each T: a synchronous
    replay, then a realtime one at half the requests/s it sustained with
    the live endpoint polled mid-run; device busy over one decode replay
    and the host gap between decode launches."""
    fields, engine = C2[arch]
    for T in C2_TS:
        eng = ContinuousBatchingServer(
            cfg, tokens_per_launch=T, device=device, params=params,
            session=TraceSession(f"C2 {arch} T={T}", ring_size=C_RING),
            **engine)
        decode_step = eng.graphs()[f"decode T={T}"]
        decode = decode_step.graph
        spec = TrafficSpec(**fields)
        ev0 = eng.session.n_events
        db0 = eng.tracker.count
        tickets, m = replay(eng, generate(spec, cfg.vocab_size),
                            realtime=False)
        loadtest_line(card, cfg.name, T, "C2 sync", m, eng, decode)
        if (m["completed"], m["evicted"], m["rejected"]) != (
                fields["n_requests"], 0, 0):
            raise AssertionError(f"{cfg.name} C2 T={T}: {m}")
        iters = span_stats(eng, ev0, "serve.decode_iter")
        starts = [r.t_submit for r in eng.tracker.records[db0:]
                  if r.name == "decode_slots"]
        gaps = np.diff(starts)
        replay_ms = time_ms(decode_step, reps=4, warmup=1)
        busy_ms = device_ms(decode_step, reps=4)
        span_ms = time_ms(decode_step, reps=1, warmup=1)
        # an admission between two decode launches: one batch-1 prefill
        prefill_ms = {label: time_ms(step, reps=4, warmup=1)
                      for label, step in sorted(eng.graphs().items())
                      if label.startswith("prefill")}
        log(f"{card} | {cfg.name} C2 T={T} decode: one replay {replay_ms:.3f}"
            f" ms ({busy_ms:.3f} ms of kernels, device busy "
            f"{busy_ms / span_ms:.1%} over one replay at full occupancy, "
            f"{engine['batch_size']} slots); serve.decode_iter spans p50/p99 "
            f"{np.percentile(iters, 50) * 1e3:.3f}/"
            f"{np.percentile(iters, 99) * 1e3:.3f} ms over {len(iters)}; "
            f"decode launch to launch p50/p99 "
            f"{np.percentile(gaps, 50) * 1e3:.3f}/"
            f"{np.percentile(gaps, 99) * 1e3:.3f} ms: host gap beyond the "
            f"replay p50/p99 {np.percentile(gaps, 50) * 1e3 - replay_ms:.3f}"
            f"/{np.percentile(gaps, 99) * 1e3 - replay_ms:.3f} ms; one "
            f"prefill replay " + ", ".join(
                f"{k[8:]} {v:.3f} ms" for k, v in prefill_ms.items()))
        if T == 1:
            check_against_oneshot(cfg, params, tickets, 4, engine["max_seq"],
                                  device, exact=False,
                                  label=f"{cfg.name} C2 T=1 bf16")
        rate = 0.5 * m["requests"] / m["wall_s"]
        live_srv = eng.start_live_endpoint()
        polled: Dict[str, Any] = {}
        done0 = sum(1 for t in eng.tickets if t.status == "done")
        poll_live(eng, live_srv.url, done0, LIVE_POLL_AFTER, polled)
        try:
            rt_tickets, rm = replay(
                eng, generate(dataclasses.replace(spec, rate=rate),
                              cfg.vocab_size), realtime=True)
        finally:
            eng.stop_live_endpoint()
            del eng.step
        loadtest_line(card, cfg.name, T, f"C2 realtime {rate:.2f} req/s",
                      rm, eng, decode)
        check_live_poll(f"{cfg.name} C2 T={T}", polled, done0,
                        LIVE_POLL_AFTER)
        if (rm["completed"], len(rt_tickets)) != (fields["n_requests"],) * 2:
            raise AssertionError(f"{cfg.name} C2 T={T} realtime: {rm}")
        del eng, decode_step, tickets, rt_tickets
        free()


def continuous_path(card: str, device: torch.device
                    ) -> Dict[str, Dict[str, int]]:
    """Phase C for both archs at full width; returns the C1 T=1 measured
    replay's kernel launches by arch."""
    counts = {}
    for path in PATHS:
        cfg = ARCHS[path.arch]
        params = get_model(cfg, impl="cuda", device=device).init_params(
            seed=0)
        log(f"phase C1: {cfg.name} ContinuousBatchingServer on "
            f"bench_loadtest's spec {C1_SPEC}, {C1_ENGINE}")
        counts[path.arch] = c1_runs(card, path.arch, cfg, params,
                                    device)[1]
        log(f"phase C2: {cfg.name} realistic traffic {C2[path.arch]}")
        c2_runs(card, path.arch, cfg, params, device)
        del params
        free()
    log("phase C1 fp32: gemma-2b against the one-shot, exactly")
    c1_fp32(card, device)
    return counts


# ---------------------------------------------------------------- phase K
def prefixed(spec: Dict[str, Any], vocab: int, seed: Optional[int]
             ) -> List[Arrival]:
    """The arrivals of ``spec``; with ``seed`` the same schedule (times,
    lengths, budgets) behind another shared prefix, drawn from ``seed``: the
    same counts, and no page of it cached by a replay on another prefix."""
    arrivals = generate(TrafficSpec(**spec), vocab)
    if seed is None:
        return arrivals
    n = spec["prefix_len"]
    prefix = np.random.default_rng(seed).integers(0, vocab, n).astype(
        np.int32)
    return [Arrival(a.t, Request(
        a.request.uid, np.concatenate([prefix, a.request.prompt[n:]]),
        max_new_tokens=a.request.max_new_tokens)) for a in arrivals]


def graph_objects(eng: ContinuousBatchingServer) -> Dict[str, Any]:
    return {k: step.graph for k, step in eng.graphs().items()}


def captured_nothing(eng: ContinuousBatchingServer, before: Dict[str, Any],
                     label: str) -> None:
    """No graph of the engine captured since ``before``: every prefill,
    extend and decode step of the measured replay a replay of a graph the
    warm replay captured (the decode's, when the engine was built)."""
    after = graph_objects(eng)
    new = sorted(k for k, g in after.items() if g is not before.get(k))
    if new:
        raise AssertionError(f"{label}: {new} captured in the measured replay")


def fresh_cursor(eng: ContinuousBatchingServer) -> None:
    """The chunked-prefill round-robin cursor back where a fresh engine's
    starts, so that a replay on a warm engine takes a fresh engine's
    schedule (the cursor is all the scheduling state an idle engine keeps)."""
    eng._prefill_rr = 0


def measured_replay(eng: ContinuousBatchingServer, spec: Dict[str, Any],
                    label: str):
    """A warm replay of ``spec``'s schedule behind another prefix (it
    captures every graph and caches no page the measured replay could
    share), then the measured replay of ``spec``, synchronous, kernel
    launches zeroed just before and read just after.  Returns its tickets,
    metrics, launches, its share of the backend's cumulative counters
    (pages peak: the engine's, every replay having the same schedule) and
    the session's event and doorbell marks before it."""
    vocab = eng.cfg.vocab_size
    replay(eng, prefixed(spec, vocab, 1001), realtime=False)
    before, kv0 = graph_objects(eng), eng.kv.stats()
    ev0, db0 = eng.session.n_events, eng.tracker.count
    fresh_cursor(eng)
    reset_launches()
    tickets, m = replay(eng, prefixed(spec, vocab, None), realtime=False)
    counts = dict(launches)
    captured_nothing(eng, before, label)
    kv1 = eng.kv.stats()
    kv = {k: kv1.get(k, 0) - kv0.get(k, 0) for k in K_KV_COUNTERS}
    kv["pages_peak"] = kv1.get("pages_peak", 0)
    return tickets, m, counts, kv, ev0, db0


def held_to_profiler(eng: ContinuousBatchingServer, spec: Dict[str, Any],
                     label: str, measured: Optional[Dict[str, int]] = None
                     ) -> Tuple[Dict[str, int], Dict[str, Any]]:
    """``spec``'s schedule once more (behind a third prefix) in one
    torch.profiler window.

    Exact, without the profiler: no graph is captured in the window, and the
    launches counted there equal, kernel by kernel, the nodes of the decoded
    graphs times the graphs' replays, and ``measured`` (the measured
    replay's, for the same schedule) when given.  The profiler then
    witnesses every replay: under each graph launch (its correlation id) it
    may record only kernels of that graph's nodes, each at most as often as
    the graph holds it, and its count of each counted kernel plus the
    records missing under the launches must equal the counted launches.  A
    launch missing records is the tracer's loss (a replay runs every node of
    its graph): it is reported with CUPTI's dropped-record count over the
    window.  Returns the counted launches and the profiler's counts."""
    steps = eng.graphs()
    nodes = {id(step.graph): graph_nodes(step.graph)
             for step in steps.values()}
    names = {id(step.graph): key for key, step in steps.items()}
    before = graph_objects(eng)
    fresh_cursor(eng)
    reset_launches()
    prof, order, dropped, _ = _window(lambda: replay(eng, prefixed(
        spec, eng.cfg.vocab_size, 1002), realtime=False))
    counts = dict(launches)
    captured_nothing(eng, before, label)
    if measured is not None and counts != measured:
        raise AssertionError(f"{label}: the profiled replay counted "
                             f"{counts}, the measured one {measured}")
    replays = collections.Counter(id(g) for g in order)
    for name in C_KERNELS[GEMMA.arch]:
        for sym in KERNEL_SYMBOLS[name]:
            want = sum(n * sum(c for k, c in nodes[g].items()
                               if of_symbol(sym, k))
                       for g, n in replays.items())
            if counts.get(name, 0) != want:
                raise AssertionError(
                    f"{label}: {counts.get(name, 0)} counted {name} "
                    f"launches, {want} {sym} nodes in the graphs replayed "
                    f"({ {names[g]: n for g, n in replays.items()} })")
    if not counts.get("rms_norm"):
        raise AssertionError(f"{label}: no rms_norm launch counted")
    lost, short = launch_loss(prof, order, label, nodes)
    kernels = [e.name() for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    prof_counts = {name: {sym: sum(of_symbol(sym, k) for k in kernels)
                          for sym in KERNEL_SYMBOLS[name]}
                   for name in C_KERNELS[GEMMA.arch]}
    for name, by_sym in prof_counts.items():
        for sym, seen in by_sym.items():
            missing = sum(n for k, n in lost.items() if of_symbol(sym, k))
            if seen + missing != counts.get(name, 0):
                raise AssertionError(
                    f"{label}: {counts.get(name, 0)} counted {name} launches,"
                    f" the profiler saw {seen} {sym} and lost {missing} under"
                    f" the graph launches")
    report_loss(label, lost, short, len(order), dropped)
    return counts, prof_counts


def held_to_tokens(cfg: ModelConfig, params, tickets,
                   want: Dict[int, List[int]], max_seq: int,
                   device: torch.device, label: str, against: str
                   ) -> Tuple[int, int]:
    """Each ticket's tokens equal ``want``'s for its request, or first
    differ at a near-tie of the one-shot (teacher-forced on ``want``).
    Returns (equal, near-ties)."""
    model = get_model(cfg, impl="cuda", device=device)
    equal = ties = 0
    for t in tickets:
        mine = want[t.uid][:len(t.tokens)]
        if mine == t.tokens:
            equal += 1
        elif near_tie(model, params, t, mine, max_seq, device, label, against):
            ties += 1
        else:
            raise AssertionError(f"{label}: uid {t.uid} differs from "
                                 f"{against} at a position that is no "
                                 f"near-tie")
    return equal, ties


def widest_gaps(eng: ContinuousBatchingServer, ev0: int,
                starts: List[float], top: int = 3) -> str:
    """The ``top`` widest gaps between decode launches (``starts``, host
    submit times), each split into the host time spent in it inside spans:
    ``serve.decode_iter`` (a decode's wait and harvest), ``serve.prefill``
    and ``serve.prefill_chunk`` (a launch, and its wait when the prompt's
    first token is read), and the rest."""
    t0 = eng.session.t0
    spans = [(t0 + e.t - e.dur_s, t0 + e.t, e.meta["span"])
             for e in eng.session.timeline()[ev0:]
             if e.name == SPAN_EVENT and e.meta.get("span") in (
                 "serve.decode_iter", "serve.prefill", "serve.prefill_chunk")]
    parts = []
    for a, b in zip(starts, starts[1:]):
        dec = pre = 0.0
        for lo, hi, name in spans:
            inside = max(0.0, min(hi, b) - max(lo, a))
            if name == "serve.decode_iter":
                dec += inside
            else:
                pre += inside
        parts.append((b - a, dec, pre))
    return ", ".join(
        f"{g * 1e3:.3f} = decode_iter {d * 1e3:.3f} + prefill {p * 1e3:.3f} "
        f"+ other {(g - d - p) * 1e3:.3f}"
        for g, d, p in sorted(parts, reverse=True)[:top])


def k1_runs(card: str, cfg: ModelConfig, params, device: torch.device
            ) -> Dict[str, Dict[str, int]]:
    """K1: bench_kv's spec and engine in both modes, each a warm replay and
    the measured one: BENCH_10's kv row, no capture, launches held to the
    profiler's; paged tokens equal dense's request by request.  Returns the
    measured replays' kernel launches by mode."""
    tokens, counts_by_mode = {}, {}
    for mode, kw in K1_MODES.items():
        label = f"{cfg.name} K1 {mode}"
        eng = ContinuousBatchingServer(cfg, device=device, params=params,
                                       **K1_ENGINE, **kw)
        tickets, m, counts, kv, _, _ = measured_replay(eng, K1_SPEC, label)
        row = (m["requests"], m["new_tokens"], m["doorbells"],
               kv["prefill_launches"], kv["prefill_payload_bytes"],
               kv["pages_allocated"], kv["pages_peak"], kv["pages_reused"],
               kv["prefix_hits"])
        log(f"{card} | loadtest {cfg.name} T={eng.T} spec=K1 kv={mode}: "
            f"requests, new tokens, doorbells, prefill doorbells, prefill "
            f"payload B, pages alloc/peak/reused, prefix hits {row} "
            f"(BENCH_10 {K1_ROWS[mode]}); tokens/s {m['tokens_per_s']:.1f}, "
            f"graphs {sorted(eng.graphs())}, none captured in the measured "
            f"replay; kernel launches {counts}")
        if row != K1_ROWS[mode]:
            raise AssertionError(f"{label}: {row}, BENCH_10 {K1_ROWS[mode]}")
        _, prof = held_to_profiler(eng, K1_SPEC, label, counts)
        log(f"{label}: torch.profiler over the schedule replayed again {prof}")
        tokens[mode] = {t.uid: list(t.tokens) for t in tickets}
        counts_by_mode[mode] = counts
        del eng, tickets
        free()
    dense, paged = (tokens[mode] for mode in K1_MODES)
    differ = sorted(uid for uid in dense if paged[uid] != dense[uid])
    log(f"{cfg.name} K1: paged tokens equal dense_chunk8's in "
        f"{len(dense) - len(differ)}/{len(dense)} requests")
    if differ:
        raise AssertionError(f"{cfg.name} K1: paged tokens differ from dense "
                             f"in requests {differ}")
    return counts_by_mode


def k2_runs(card: str, cfg: ModelConfig, params, device: torch.device
            ) -> Dict[int, List[int]]:
    """K2: chat traffic behind a shared system prompt in the four modes,
    each a warm replay, the measured one, then the profiler's replay.
    Returns the paged mode's tokens at T=1 by request."""
    control: Dict[int, List[int]] = {}
    paged_t1: Dict[int, List[int]] = {}
    S = K2_ENGINE["max_seq"]
    for mode, T, kw in K2_MODES:
        label = f"{cfg.name} K2 {mode} T={T}"
        eng = ContinuousBatchingServer(
            cfg, tokens_per_launch=T, device=device, params=params,
            session=TraceSession(label, ring_size=C_RING), **K2_ENGINE, **kw)
        tickets, m, counts, kv, ev0, db0 = measured_replay(eng, K2_SPEC,
                                                           label)
        n = K2_SPEC["n_requests"]
        if (m["completed"], m["evicted"], m["rejected"]) != (n, 0, 0):
            raise AssertionError(f"{label}: {m}")
        starts, between, n = [], [], 0
        for r in eng.tracker.records[db0:]:
            if r.name != "decode_slots":
                n += 1
                continue
            starts.append(r.t_submit)
            between.append(n)
            n = 0
        gaps = np.diff(starts) * 1e3
        # the time between two harvests of the decode block: between two
        # tokens of a slot that decodes in both
        harvests = [e.t for e in eng.session.timeline()[ev0:]
                    if e.name == SPAN_EVENT
                    and e.meta.get("span") == "serve.decode_iter"]
        itl = np.diff(harvests) * 1e3
        # prefill launches run between two decode launches: at most one a
        # scheduler iteration, more when no slot is decodable
        between = np.asarray(between[1:])
        one = gaps[between <= 1]
        sizes = [e.meta.get("size", e.meta.get("prompt_len"))
                 for e in eng.session.timeline()[ev0:]
                 if e.name == SPAN_EVENT and e.meta.get("span") in (
                     "serve.prefill", "serve.prefill_chunk")]
        if len(sizes) != kv["prefill_launches"]:
            raise AssertionError(f"{label}: {len(sizes)} prefill spans, "
                                 f"{kv['prefill_launches']} launches")
        graphs = eng.graphs()
        replay_ms = time_ms(graphs[f"decode T={T}"], reps=4, warmup=1)
        prefill_ms = {k: time_ms(step, reps=4, warmup=1)
                      for k, step in sorted(graphs.items())
                      if not k.startswith("decode")}
        log(f"{card} | loadtest {cfg.name} T={T} spec=K2 kv={mode}: tokens/s "
            f"{m['tokens_per_s']:.1f}, latency p50/p99 "
            f"{m['latency_p50_s'] * 1e3:.3f}/{m['latency_p99_s'] * 1e3:.3f} "
            f"ms, TTFT p50/p99 {m['ttft_p50_s'] * 1e3:.3f}/"
            f"{m['ttft_p99_s'] * 1e3:.3f} ms, decode launch to launch p50/p99"
            f" {np.percentile(gaps, 50):.3f}/{np.percentile(gaps, 99):.3f} ms"
            f" over {len(starts)} launches: host gap beyond one decode replay "
            f"({replay_ms:.3f} ms) p50/p99 "
            f"{np.percentile(gaps, 50) - replay_ms:.3f}/"
            f"{np.percentile(gaps, 99) - replay_ms:.3f} ms (p99 "
            f"{np.percentile(one, 99) - replay_ms:.3f} ms over the {len(one)} "
            f"gaps with at most one prefill launch; at most "
            f"{between.max()} between two decode launches); decode harvest to"
            f" harvest p50/p99 {np.percentile(itl, 50):.3f}/"
            f"{np.percentile(itl, 99):.3f} ms; prefill launches "
            f"{kv['prefill_launches']}, largest {max(sizes)} tokens; prefix "
            f"hits {kv['prefix_hits']}, pages peak {kv['pages_peak']}, "
            f"pages reused {kv['pages_reused']}; one replay "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in prefill_ms.items())
            + f" ({m['completed']} completed, {m['new_tokens']} new tokens, "
            f"doorbells {m['doorbells']}, wall {m['wall_s']:.3f} s)")
        log(f"{label}: widest gaps between decode launches, ms: "
            f"{widest_gaps(eng, ev0, starts)}")
        profile_window(graphs[f"decode T={T}"], f"{card} | {label} one "
                       f"decode replay", top=6)
        window, prof = held_to_profiler(
            eng, dict(K2_SPEC, n_requests=K2_PROFILED), label)
        log(f"{label}: kernel launches {counts}; the schedule's first "
            f"{K2_PROFILED} requests replayed again: kernel launches "
            f"{window}, torch.profiler's {prof}")
        mine = {t.uid: list(t.tokens) for t in tickets}
        if kw.get("kv") == "paged":
            if (kv["pages_reused"] != K2_PREFIX_PAGES * kv["prefix_hits"]
                    or kv["prefix_hits"] < K2_MIN_HITS):
                raise AssertionError(
                    f"{label}: {kv['prefix_hits']} prefix hits reusing "
                    f"{kv['pages_reused']} pages; expected at least "
                    f"{K2_MIN_HITS}, {K2_PREFIX_PAGES} pages each")
            if T == 1:
                paged_t1 = mine
        if not kw:
            control = mine
        else:
            first = tickets[:K_NEAR_TIES]
            equal, ties = held_to_tokens(cfg, params, first, control, S,
                                         device, label, "dense whole-prompt")
            log(f"{label}: the first {len(first)} requests equal dense "
                f"whole-prompt's in {equal}, first differ at a near-tie in "
                f"{ties}")
        del eng, tickets, graphs
        free()
    return paged_t1


def k3_run(card: str, cfg: ModelConfig, params, device: torch.device,
           want: Dict[int, List[int]]) -> None:
    """K3: K2's paged engine at T=1 with a pool of two slots' pages, one
    synchronous replay: some request evicted for pages; every survivor's
    tokens equal its tokens in K2's paged mode, or first differ at a
    near-tie (a prefix prefilled again under pressure is cut into other
    chunks)."""
    label = f"{cfg.name} K3 paged_pt16_chunk128 kv_pages={K3_PAGES}"
    eng = ContinuousBatchingServer(cfg, tokens_per_launch=1, device=device,
                                   params=params, kv_pages=K3_PAGES,
                                   **K2_ENGINE, **K2_PAGED)
    tickets, m = replay(eng, prefixed(K2_SPEC, cfg.vocab_size, None),
                        realtime=False)
    kv = m["kv"]
    evicted = [t for t in tickets if t.status == "evicted"]
    survivors = [t for t in tickets if t.status == "done"]
    log(f"{card} | loadtest {cfg.name} T=1 spec=K3 kv=paged_pt16_chunk128 "
        f"pages={K3_PAGES}: {m['completed']} completed, {m['evicted']} "
        f"evicted ({collections.Counter(t.reason for t in evicted)}), "
        f"tokens/s {m['tokens_per_s']:.1f}, prefix hits {kv['prefix_hits']}, "
        f"pages peak {kv['pages_peak']}/{kv['pages_total']}, allocated "
        f"{kv['pages_allocated']}, reused {kv['pages_reused']}")
    if not any(t.reason == "kv_pages" for t in evicted):
        raise AssertionError(f"{label}: no kv_pages eviction")
    if len(survivors) + len(evicted) != K2_SPEC["n_requests"]:
        raise AssertionError(f"{label}: {m}")
    equal, ties = held_to_tokens(cfg, params, survivors, want,
                                 K2_ENGINE["max_seq"], device, label,
                                 "K2's paged mode")
    log(f"{label}: {equal}/{len(survivors)} survivors equal their tokens "
        f"in K2's paged mode, {ties} first differ at a near-tie")
    del eng, tickets, survivors, evicted
    free()


def kv_path(card: str, device: torch.device) -> Dict[str, Dict[str, int]]:
    """Phase K for gemma-2b at full width in bf16; returns K1's measured
    replays' kernel launches by mode."""
    cfg = ARCHS[GEMMA.arch]
    params = get_model(cfg, impl="cuda", device=device).init_params(seed=0)
    log(f"phase K1: {cfg.name} bench_kv's spec {K1_SPEC}, {K1_ENGINE}")
    counts = k1_runs(card, cfg, params, device)
    log(f"phase K2: {cfg.name} chat traffic {K2_SPEC}, {K2_ENGINE}")
    paged = k2_runs(card, cfg, params, device)
    log(f"phase K3: {cfg.name} K2's paged engine with {K3_PAGES} pages")
    k3_run(card, cfg, params, device, paged)
    del params
    free()
    return counts


# ---------------------------------------------------------------- phase T
# the defaults of launch/train.py (--seq 256 --batch 8)
T_SHAPE = ShapeConfig("train", 256, 8, "train")
T1_RUNS = ((1, 6), (4, 2))       # gemma-2b: (K, launches)
T1_EAGER_STEPS = 8               # the uncaptured control, from the same start
T1_MAMBA = ((1, 4),)
# captured against eager losses, step by step: the two runs are the same
# kernels on the same data, apart from the order of atomic adds (the
# embedding's gradient); one bf16 step relative (2^-8) bounds them
T_LOSS_RTOL = 2.0 ** -8
# benchmarks/bench_submission.py's _multistep_economy
T2_ARCH, T2_SHAPE = "deepseek-7b", ShapeConfig("bench", 64, 4, "train")
T2_KS, T2_STEPS = (1, 4, 16), 16
T2_RTOL = 1e-3                   # tests/test_runtime_integration.py


@contextlib.contextmanager
def replays_timed(graph, events: List[Tuple[Any, Any]]) -> Iterator[None]:
    """Each replay of ``graph`` in the block between two CUDA events on the
    current stream, appended to ``events``."""
    def timed() -> None:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        _REPLAY(graph)
        b.record()
        events.append((a, b))
    graph.replay = timed
    try:
        yield
    finally:
        del graph.replay


def peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def held_losses(label: str, got: List[float], want: List[float],
                rtol: float) -> float:
    """The losses of two runs equal step by step within ``rtol``, finite;
    returns the largest relative difference."""
    if len(got) > len(want) or not all(map(math.isfinite, got + want)):
        raise AssertionError(f"{label}: losses {got} against {want}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    if rel > rtol:
        raise AssertionError(f"{label}: losses {got} differ from {want} by "
                             f"{rel:.2e} relative, above {rtol:.2e}")
    return rel


def train_eager(cfg: ModelConfig, steps: int, device: torch.device
                ) -> List[float]:
    """The uncaptured control: ``steps`` eager train steps from the seeded
    start."""
    tr = Trainer(cfg, T_SHAPE, steps_per_launch=1, seed=0, device=device)
    tr.train(steps, eager=True)
    losses = tr.losses
    del tr
    free()
    return losses


def train_captured(card: str, cfg: ModelConfig, K: int, n_launch: int,
                   device: torch.device, eager: List[float]
                   ) -> Tuple[Trainer, float]:
    """``n_launch`` launches of K steps, every launch one graph replay but
    the first (the capture's eager warm-up), held to the eager control's
    losses; prints the run's line.  The step's op stream is recorded
    (``record_captures``) at K = 1.  Returns the trainer and the step's
    time in ms."""
    label = f"{card} | train {cfg.name} K={K} B={T_SHAPE.global_batch} " \
            f"S={T_SHAPE.seq_len}"
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, T_SHAPE, steps_per_launch=K, seed=0, device=device)
    reset_launches()
    t0 = time.perf_counter()
    with record_captures() if K == 1 else contextlib.nullcontext():
        tr.train(K)
    capture_s = time.perf_counter() - t0
    step = tr.graphs()[f"train K={K}"]
    events: List[Tuple[Any, Any]] = []
    t1 = time.perf_counter()
    with replays_timed(step.graph, events):
        tr.train(K * n_launch)
    wall = time.perf_counter() - t1
    torch.cuda.synchronize()
    if dict(launches):
        raise AssertionError(f"{label}: the train path launched port "
                             f"kernels {dict(launches)}")
    if tr.tracker.count != n_launch or len(events) != n_launch - 1:
        raise AssertionError(f"{label}: {tr.tracker.count} doorbells, "
                             f"{len(events)} replays for {n_launch} launches")
    rel = held_losses(label, tr.losses, eager, T_LOSS_RTOL)
    step_ms = float(np.median([a.elapsed_time(b) for a, b in events])) / K
    tokens = T_SHAPE.global_batch * T_SHAPE.seq_len * K * (n_launch - 1)
    nbytes, nodes = step.footprint()
    log(f"{label}: step {step_ms:.3f} ms (replay, CUDA events), "
        f"{tokens / wall:.0f} tokens/s, loss {tr.losses[0]:.5f} -> "
        f"{tr.losses[-1]:.5f} (eager's within {rel:.1e}), doorbells "
        f"{tr.tracker.count} for {tr.step} steps, graph nodes {nodes}, "
        f"footprint {nbytes} B, capture {capture_s:.2f} s (capture+upload "
        f"{step.upload_s:.2f} s), pool {(step.pool_bytes or 0) / 2**30:.2f} "
        f"GiB, peak {peak_gib():.2f} GiB")
    return tr, step_ms


def train_graph(card: str, tr: Trainer, step_ms: float) -> None:
    """T3: the K=1 train graph decoded at commit and held to the
    profiler's records over one replay (``held_to_graph``); its node types,
    top kernels, the step's op-level FLOPs and bytes and its roofline
    beside the measured replay."""
    name = f"{tr.cfg.name} train K=1"
    step = tr.graphs()["train K=1"]
    cs = CommandStreamCapture().capture_compiled(name, step)
    counts = held_to_graph(f"{card} | {name}", step, cs)
    n_params = sum(x.numel() for x in _leaves(tr.params))
    tokens = T_SHAPE.global_batch * T_SHAPE.seq_len
    rep = analyze(cs, chips=1, model_flops_total=6 * n_params * tokens,
                  name=name)
    bound_ms = rep.step_time_s * 1e3
    log(f"{card} | {name} graph: {counts}; op-level stream "
        f"{cs.stream.n_ops} entries, {rep.flops_per_device / 1e12:.3f} "
        f"TFLOP, {rep.hbm_bytes_per_device / 1e9:.2f} GB; roofline compute "
        f"{rep.compute_s * 1e3:.3f} ms, memory {rep.memory_s * 1e3:.3f} ms, "
        f"bound {bound_ms:.3f} ms ({rep.bottleneck}); measured replay "
        f"{step_ms:.3f} ms: {bound_ms / step_ms:.1%} of the roofline; "
        f"model/stream FLOPs {rep.model_flops_ratio:.3f}")
    print(render_roofline_row(rep), flush=True)


def train_economy(card: str, device: torch.device) -> None:
    """T2: bench_submission's _multistep_economy on the card: deepseek-7b's
    smoke config, K = 1, 4, 16 over 16 steps from seed 0 (its first launch
    the capture's eager warm-up, as the reference's first includes its
    compile), then 16 steps more, every launch a replay."""
    cfg = SMOKE_ARCHS[T2_ARCH]
    losses: Dict[int, List[float]] = {}
    for K in T2_KS:
        tr = Trainer(cfg, T2_SHAPE, steps_per_launch=K, seed=0, device=device)
        out = tr.train(T2_STEPS)
        steady = tr.train(2 * T2_STEPS)
        nbytes, nodes = tr.graphs()[f"train K={K}"].footprint()
        losses[K] = tr.losses
        log(f"{card} | train_economy {cfg.name} K={K}: "
            f"{out['wall_s'] / T2_STEPS * 1e6:.1f} host us/step (capture "
            f"included), {steady['wall_s'] / T2_STEPS * 1e6:.1f} the next "
            f"{T2_STEPS}; doorbells {out['doorbells']}, steps/doorbell "
            f"{out['steps_per_doorbell']:.1f}, final loss "
            f"{out['final_loss']:.5f}, graph nodes {nodes}, footprint "
            f"{nbytes} B")
        for o in (out, steady):
            if o["doorbells"] != T2_STEPS // K or o["steps"] % T2_STEPS:
                raise AssertionError(f"train_economy K={K}: {o}")
        del tr
    held_losses(f"train_economy K=4 against K=1", losses[4], losses[1],
                T2_RTOL)


def train_path(card: str, device: torch.device) -> None:
    """Phase T: training on the train route (``impl="ref"``, no port
    kernel), every launch one CUDA Graph replay."""
    free()
    for arch, runs in (("gemma-2b", T1_RUNS), ("mamba2-780m", T1_MAMBA)):
        cfg = ARCHS[arch]
        log(f"phase T1: train {cfg.name}, {T_SHAPE}, remat {cfg.remat}")
        eager = train_eager(cfg, max(K * n for K, n in runs), device)
        log(f"{card} | train {cfg.name} eager control: losses {eager}")
        for K, n_launch in runs:
            tr, step_ms = train_captured(card, cfg, K, n_launch, device,
                                         eager)
            if K == 1 and arch == "gemma-2b":
                log("phase T3: the train graph decoded and held to the "
                    "profiler")
                train_graph(card, tr, step_ms)
            del tr
            free()
    log("phase T2: bench_submission's _multistep_economy")
    train_economy(card, device)
    free()


# ---------------------------------------------------------------- phase P
# the tuner at gemma-2b's full width.  WorkloadSpec's defaults (B=2, 8 new
# tokens, 8 train steps) measure a serve in 27-131 ms and a T>=2 serve
# spends one decode step of eight on a truncated block, too short to rank
# the knobs; these measure 64 new tokens for 8 sequences and 16 train
# steps (prompts of 4, train B=2 S=32, the 4 DMA sizes 256 B-256 KiB
# three times and the 16-token kv prefix stay the defaults)
P_ARCH = "gemma-2b"
P_SPEC = WorkloadSpec(batch=8, new_tokens=64, max_seq=128, train_steps=16)
P_WIDTH = ("--full",)                      # the published config
P_WORKLOADS = ("dma", "serve", "train", "kv")
P_ROUNDS = 2
P_PRESET = "CUDA_MODULE_LOADING=LAZY"      # CUDA's default: recorded only
P_RESERVED_MAX = 2 * 2**30                 # bytes the parent may keep
P_TIMEOUT_S = 900
P3_FLAG = "--policy-bench"                 # P3's own process: see tuner_bench
P_UNITS = {"dma": "puts", "serve": "tokens", "train": "steps",
           "kv": "tokens"}
# what each owner falls back to without a policy
P_DEFAULTS = {"tokens_per_launch": 1, "kv_page_tokens": 16,
              "prefill_chunk": 0, "steps_per_launch": 1,
              "dma_threshold_bytes": INLINE_THRESHOLD_DEFAULT}
ROOT = Path(__file__).resolve().parent


def tuner_release(card: str) -> None:
    """P0: release phase T's state; the tuner's subprocess needs the card.

    Besides the owners, the parent holds a cuBLAS workspace for each
    stream a capture used, and each pins its segment of the allocator's
    cache; no graph that used them is alive now, so they are cleared."""
    free()
    kept = torch.cuda.memory_reserved()
    torch._C._cuda_clearCublasWorkspaces()
    free()
    reserved = torch.cuda.memory_reserved()
    log(f"{card} | P0 parent after phase T: {kept / 2**30:.3f} GiB "
        f"reserved, {reserved / 2**30:.3f} GiB once the cuBLAS workspaces "
        f"are cleared")
    if reserved >= P_RESERVED_MAX:
        raise AssertionError(f"P0: the parent keeps {reserved} B reserved, "
                             f"not under {P_RESERVED_MAX}")


def trial_lines(card: str, policy: Dict[str, Any]) -> int:
    """One line per measured candidate of each workload, from the policy's
    trial log; returns their number."""
    spec = policy["meta"]["workload_spec"]
    T_tokens = spec["train_batch"] * spec["train_seq"]
    seen = set()
    for trial in policy["objective"]["trials"]:
        for w, m in trial["info"].items():
            own = tuple((k, trial["knobs"][k]) for k in KNOB_WORKLOADS[w])
            if (w, own) in seen:
                continue
            seen.add((w, own))
            rate = m["tokens"] / m["wall_s"]
            extra = (f" ({rate * T_tokens:.1f} tokens/s)" if w == "train"
                     else "")
            log(f"{card} | P1 {w} "
                f"{' '.join(f'{k}={v}' for k, v in own)}: objective "
                f"{m['score']:.4e} s/{P_UNITS[w][:-1]}, doorbells/"
                f"{P_UNITS[w][:-1]} {m['doorbells_per_token']:.4f}, dispatch "
                f"{m['dispatch_s'] * 1e3:.3f} ms, transfer "
                f"{m['transfer_s'] * 1e3:.3f} ms, {m['tokens']} "
                f"{P_UNITS[w]} in {m['wall_s'] * 1e3:.3f} ms, "
                f"{rate:.1f} {P_UNITS[w]}/s{extra}")
    return len(seen)


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def tuner_cli(card: str, device: torch.device, policy_root: Path
              ) -> Tuple[Dict[str, Any], Path]:
    """P1: ``python -m repro_torch.tune`` at full width in a subprocess (the
    preset is applied before CUDA starts there); its policy checked and
    its trials printed.  The policy goes to ``--policy-dir``, the port's
    directory under ``policy_root``, where ``--verify``'s Server (knob
    unset) looks it up through ``REPRO_POLICY_DIR``.  Returns the policy
    and its file."""
    policy_dir = policy_root / "torch"
    cmd = [sys.executable, "-m", "repro_torch.tune", "--arch", P_ARCH,
           *P_WIDTH, "--workloads", ",".join(P_WORKLOADS), "--rounds",
           str(P_ROUNDS), "--batch", str(P_SPEC.batch), "--new-tokens",
           str(P_SPEC.new_tokens), "--max-seq", str(P_SPEC.max_seq),
           "--train-steps", str(P_SPEC.train_steps), "--policy-dir",
           str(policy_dir), "--cuda-env", P_PRESET, "--device", device.type]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_POLICY_DIR=str(policy_root))
    env.pop("REPRO_POLICY_DISABLE", None)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=P_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"P1: {' '.join(cmd[1:])} exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    if "RuntimeWarning" in proc.stderr:
        raise AssertionError(f"P1: the preset warned:\n{proc.stderr[-2000:]}")
    for line in proc.stdout.splitlines():
        if line.startswith("    measured "):
            log(f"P1 {line.strip()}")
    cfg = ARCHS[P_ARCH]
    path = policy_dir / f"{cfg.name}__{device.type}__d1.json"
    policy = json.loads(path.read_text())
    knobs, obj, env_rec = policy["knobs"], policy["objective"], policy["env"]
    names = sorted(k.name for k in default_knobs(P_WORKLOADS))
    checks = {
        f"the five knobs, not {sorted(knobs)}": sorted(knobs) == names,
        "after <= before": obj["after"] <= obj["before"],
        "a trial log": bool(obj["trials"]),
        f"platform {device.type}, not {policy['platform']}":
            policy["platform"] == device.type,
        f"this device, not {env_rec['device_name']}":
            env_rec["device_name"] == device_name(device),
        f"the preset in force, not {env_rec['cuda_env']}":
            env_rec["cuda_env"].get("CUDA_MODULE_LOADING") == "LAZY"
            and env_rec["preset"]["cuda_env"] == P_PRESET}
    if policy["meta"]["workload_spec"] != json.loads(json.dumps(
            P_SPEC.to_dict())):
        checks["the workload spec asked for"] = False
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"P1: policy {path} lacks {failed}")
    n = trial_lines(card, policy)
    log(f"{card} | P1 chosen {knobs}: objective before {obj['before']:.4e} "
        f"after {obj['after']:.4e} s/token ({100 * obj['improvement']:.1f}% "
        f"better), {len(obj['trials'])} trials, {n} measurements, "
        f"{policy['meta']['rounds']} rounds, subprocess {wall:.1f} s")
    verify = [ln for ln in proc.stdout.splitlines()
              if ln.startswith("verify:")]
    for line in verify[:2]:
        log(f"{card} | P1 {line}")
    applied = re.search(r"auto-applied tokens_per_launch=(\d+) "
                        r"\(policy says (\d+)\)", "\n".join(verify))
    if not applied or {int(applied[1]), int(applied[2])} != {
            knobs["tokens_per_launch"]}:
        raise AssertionError(f"P1: verify {verify[:1]} against the policy's "
                             f"tokens_per_launch {knobs['tokens_per_launch']}")
    return policy, path


def owner_knobs(device: torch.device, explicit: Dict[str, Any]
                ) -> Tuple[Dict[str, Any], int]:
    """Each knob owner built at full width in turn (released before the
    next), with ``explicit`` values passed and the rest unset; the knob
    each took, and how many owners loaded a policy."""
    cfg, spec = ARCHS[P_ARCH], P_SPEC
    e = explicit.get
    out: Dict[str, Any] = {}
    srv = Server(cfg, batch_size=spec.batch, max_seq=spec.max_seq,
                 tokens_per_launch=e("tokens_per_launch"), device=device)
    out["tokens_per_launch"] = srv.T
    loaded = srv.policy is not None
    del srv
    free()
    eng = ContinuousBatchingServer(
        cfg, batch_size=spec.batch, max_seq=spec.max_seq,
        tokens_per_launch=e("tokens_per_launch"), kv="paged",
        kv_page_tokens=e("kv_page_tokens"),
        prefill_chunk=e("prefill_chunk"), device=device)
    out["kv_page_tokens"], out["prefill_chunk"] = eng.kv.pt, eng.kv.chunk
    loaded += eng.policy is not None
    del eng
    free()
    tr = Trainer(cfg, ShapeConfig("tune", spec.train_seq, spec.train_batch,
                                  "train"),
                 steps_per_launch=e("steps_per_launch"), device=device)
    out["steps_per_launch"] = tr.k
    loaded += tr.policy is not None
    del tr
    free()
    out["dma_threshold_bytes"] = HybridMover(
        threshold=e("dma_threshold_bytes"), device=device).threshold
    return out, loaded


def tuner_auto_apply(card: str, device: torch.device, policy_root: Path,
                     policy: Dict[str, Any]) -> None:
    """P2: every owner picks the P1 policy up with its knob unset; explicit
    values win; ``REPRO_POLICY_DISABLE=1`` restores the defaults."""
    knobs = policy["knobs"]
    ladders = {k.name: k.values for k in default_knobs(P_WORKLOADS)}
    explicit = {name: next(v for v in ladders[name]
                           if v not in (knobs[name], P_DEFAULTS[name]))
                for name in knobs}
    cases = (("policy", {}, "", knobs, 3),
             ("explicit", explicit, "", explicit, 0),
             ("REPRO_POLICY_DISABLE=1", {}, "1", P_DEFAULTS, 0))
    for label, given, disable, want, n_loaded in cases:
        clear_active_policy()
        # an empty REPRO_POLICY_DISABLE disables nothing
        with mock.patch.dict(os.environ, REPRO_POLICY_DIR=str(policy_root),
                             REPRO_POLICY_DISABLE=disable):
            got, loaded = owner_knobs(device, given)
        clear_active_policy()
        log(f"{card} | P2 {label}: {got}, {loaded} owners loaded the policy")
        if got != dict(want) or loaded != n_loaded:
            raise AssertionError(f"P2 {label}: owners took {got} "
                                 f"({loaded} loaded a policy), expected "
                                 f"{dict(want)} ({n_loaded})")


def tuner_bench(card: str, device: torch.device, policy_path: Path) -> None:
    """P3 in a fresh process, its lines relayed.  This process has run the
    profiler windows of the earlier phases, after which the same graph
    replay costs several times the host dispatch (PERF.md), and the
    objective scores host dispatch; P1 measured in a fresh process too."""
    cmd = [sys.executable, str(ROOT / "chip_smoke.py"), P3_FLAG,
           str(policy_path), device.type, card]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=P_TIMEOUT_S)
    if proc.returncode:
        raise AssertionError(f"P3: {' '.join(cmd[1:])} exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    for line in proc.stdout.splitlines():
        log(re.sub(r"^\[\d\d:\d\d:\d\d\] ", "", line))


def policy_bench(card: str, device: torch.device,
                 policy: Dict[str, Any]) -> None:
    """P3: ``benchmarks/bench_policy.py``: the serve workload re-measured
    at T=1 and at the tuned T through the tuner's own evaluator, on the
    config and workload spec the policy was tuned on, and the path kernels
    each serve launched."""
    meta = policy["meta"]
    cfg = (SMOKE_ARCHS if meta["smoke"] else ARCHS)[meta["arch_key"]]
    spec = WorkloadSpec(**{**meta["workload_spec"], "dma_sizes": tuple(
        meta["workload_spec"]["dma_sizes"])})
    obj = Objective()
    ev = CandidateEvaluator(cfg, spec=spec, objective=obj,
                            workloads=("serve",), device=device)
    tuned = int(policy["knobs"]["tokens_per_launch"])
    for label, T in (("baseline", 1), ("tuned", tuned)):
        reset_launches()
        m = ev.measure("serve", {"tokens_per_launch": T})
        counted = dict(launches)
        log(f"{card} | P3 policy_serve_{label} T={T}: score "
            f"{obj.score(m):.4e} s/token, doorbells/token "
            f"{m.doorbells_per_token:.4f}, dispatch {m.dispatch_s * 1e3:.3f} "
            f"ms, tokens {m.tokens}, {m.tokens / m.wall_s:.1f} tokens/s; "
            f"kernel launches (warm and measured serve) {counted}")
        measured = label == "baseline" or T != 1     # else the cached one
        if device.type == "cuda" and measured and not (
                counted.get("rms_norm") and counted.get("flash_attention")):
            raise AssertionError(f"P3 {label}: the serve launched "
                                 f"{counted}, not the path kernels")
    log(f"{card} | P3 policy_objective_recorded before "
        f"{policy['objective']['before']:.4e} after "
        f"{policy['objective']['after']:.4e}")


def policy_bench_main(policy_path: str, device: str, card: str) -> int:
    """``chip_smoke.py --policy-bench POLICY DEVICE CARD``: P3 alone, in
    the process ``tuner_bench`` starts."""
    policy_bench(card, resolve_device(device),
                 json.loads(Path(policy_path).read_text()))
    return 0


def tuner_path(card: str, device: torch.device) -> None:
    """Phase P: the submission-policy tuner at gemma-2b's full width."""
    t0 = time.perf_counter()
    tuner_release(card)
    with tempfile.TemporaryDirectory(prefix="policies-") as root:
        policy_root = Path(root)
        log("phase P1: python -m repro_torch.tune at full width")
        policy, policy_path = tuner_cli(card, device, policy_root)
        log("phase P2: the knob owners apply the policy")
        tuner_auto_apply(card, device, policy_root, policy)
        log("phase P3: bench_policy, baseline against tuned, in a fresh "
            "process")
        tuner_bench(card, device, policy_path)
    log(f"{card} | P4 phase P: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------- phase Z
def moe_paths_agree(card: str, cfg: ModelConfig, params,
                    device: torch.device) -> None:
    """Z1: on layer 0's MoE weights, ``moe_sorted`` at capacity_factor E/k
    (every slot kept) against ``moe_dense`` on seeded inputs of the path's
    prefill shape, in bf16 and with weights and inputs in fp32."""
    p = layer_params(params["layers"], 0)["moe"]
    full = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    B, S = len(QWEN_MOE.prompt_lens), max(QWEN_MOE.prompt_lens)
    if capacity(full, S) != S:
        raise AssertionError(f"capacity {capacity(full, S)} at S={S}")
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.randn(B, S, cfg.d_model, generator=gen, device=device)
    for dtype, tol in MOE_PATHS_TOL.items():
        pd = map_params(lambda t: t.to(dtype) if t.dtype != torch.float32
                        else t, p)
        ys, _ = moe_sorted(pd, full, x.to(dtype))
        yd, _ = moe_dense(pd, full, x.to(dtype))
        err = rel_l2(ys, yd)
        log(f"{card} | {cfg.name} layer 0 moe_sorted (C = S = {S}, "
            f"{cfg.n_experts} experts, top-{cfg.top_k}) against moe_dense, "
            f"B={B} {dtype}: relative L2 {err:.3e} (limit {tol}), max|err| "
            f"{max_err(ys, yd):.3e}, max|y| {yd.float().abs().max().item():.3f}")
        if not torch.isfinite(ys).all() or err > tol:
            raise AssertionError(f"{cfg.name}: moe_sorted and moe_dense "
                                 f"disagree in {dtype}")
        del pd, ys, yd
    free()


def zoo_path(card: str, device: torch.device
             ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Phase Z: Z1 qwen2-moe-a2.7b and Z2 jamba-v0.1-52b through phases 4-7
    and S2-S3, then their engines; Z3 grok-1-314b's phase 6.  Each model is
    released before the next.  Returns the serves' kernel launches by arch
    (as ``drive_path``'s) and the engines' (C1 at T=4, K1) by arch."""
    counts: Dict[str, Any] = {}
    engines: Dict[str, Any] = {}

    def z1(cfg: ModelConfig, params) -> None:
        log(f"phase Z1: {cfg.name} moe_sorted against moe_dense")
        moe_paths_agree(card, cfg, params, device)
        log(f"phase Z1: {cfg.name} C1 at T={Z_C1_TS} on DenseKV")
        engines[QWEN_MOE.arch] = {"C1": c1_runs(
            card, QWEN_MOE.arch, cfg, params, device, Z_C1_TS)}
        log(f"phase Z1: {cfg.name} K1 {K1_SPEC}, {K1_ENGINE}: "
            f"dense_chunk8 and PagedKV")
        engines[QWEN_MOE.arch]["K1"] = k1_runs(card, cfg, params, device)

    def z2(cfg: ModelConfig, params) -> None:
        log(f"phase Z2: {cfg.name} C1 at T={Z_C1_TS} on DenseKV")
        engines[JAMBA.arch] = {"C1": c1_runs(card, JAMBA.arch, cfg, params,
                                             device, Z_C1_TS)}

    for path, then in ((QWEN_MOE, z1), (JAMBA, z2)):
        log(f"phase Z: {path.arch}")
        counts[path.arch] = drive_path(path, card, device, then)
    log(f"phase Z3: {GROK.arch}, kernel route against the plain route")
    cfg, params = init_path(GROK, device)
    compare_bf16(GROK, cfg, params, device)
    del params
    free()
    compare_fp32(GROK, cfg, device)
    return counts, engines


# ---------------------------------------------------------------- kernels
def roofline(cost: KernelCost) -> Dict[str, Any]:
    """Bound of bf16 work on one H100 SXM (NVIDIA's published peaks): the
    kernel's bytes (each input read once, each output written once) and
    operations, from its wrapper's cost formula."""
    byte_s = (cost.operand_bytes + cost.result_bytes) / H100_SXM.hbm_bw
    flop_s = cost.flops / H100_SXM.peak_flops
    return {"bound_ms": max(byte_s, flop_s) * 1e3,
            "bound_by": "bytes" if byte_s >= flop_s else "operations"}


def rms_entry(device: torch.device) -> Dict[str, Any]:
    rows, D, dtype = len(GEMMA.prompt_lens) * max(GEMMA.prompt_lens), 2048, \
        torch.bfloat16
    x, s = rms_inputs(rows, D, dtype, device, seed=1)
    err = max_err(rms_norm(x, s), rms_norm_ref(x, s))
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
            **roofline(rms_norm_cost(x, s)),
            "library_ms": library_ms,
            "shape": f"rows={rows} D={D} bf16 (gemma-2b prefill)"}


def flash_at(device: torch.device, B: int, S: int, H: int, Hkv: int,
             hd: int) -> Dict[str, Any]:
    """The flash kernel at one causal bf16 shape: its device time beside its
    plain version, SDPA on the same inputs and its bound."""
    q, k, v = flash_inputs(B, S, H, Hkv, hd, torch.bfloat16, device, seed=1)
    err = max_err(flash_attention(q, k, v), flash_attention_ref(q, k, v))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    return {"max_abs_err": err,
            "ms": device_ms(lambda: flash_attention(q, k, v)),
            "plain_ms": device_ms(lambda: flash_attention_ref(q, k, v)),
            "call_ms": time_ms(lambda: flash_attention(q, k, v), reps=50),
            **roofline(flash_attention_cost(q, k, v)),
            "library_ms": library_ms,
            "shape": f"B={B} S={S} H={H} Hkv={Hkv} hd={hd} causal bf16"}


def path_flash_shape(path: ServePath) -> Tuple[int, int, int, int, int]:
    cfg = path.cfg
    return (len(path.prompt_lens), max(path.prompt_lens), cfg.n_heads,
            cfg.n_kv_heads, cfg.hd)


def flash_entry(device: torch.device) -> Dict[str, Any]:
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:77",
            **flash_at(device, *path_flash_shape(GEMMA))}


def flash_long(card: str, device: torch.device, S: int = 4096
               ) -> Dict[str, Any]:
    """The flash kernel where the work, not the bytes, bounds it: gemma-2b's
    heads at S=4096, beside SDPA on the same inputs."""
    cfg = ARCHS[GEMMA.arch]
    B, H, Hkv, hd = 1, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = flash_inputs(B, S, H, Hkv, hd, torch.bfloat16, device, seed=2)
    out, ref = flash_attention(q, k, v), flash_attention_ref(q, k, v)
    tol = TOL["flash_attention"][torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    err = max_err(out, ref)
    del out, ref
    flops = flash_attention_cost(q, k, v).flops
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    ms = device_ms(lambda: flash_attention(q, k, v))
    bound = roofline(flash_attention_cost(q, k, v))
    log(f"{card} | flash_attention long B={B} S={S} H={H} Hkv={Hkv} hd={hd} "
        f"causal bf16: kernel {ms:.5f} ms, scaled_dot_product_attention "
        f"{sdpa_ms:.5f} ms, bound {bound['bound_ms']:.5f} ms "
        f"({bound['bound_by']}, {flops / 1e9:.1f} GFLOP): kernel at "
        f"{flops / ms / 1e9:.1f} TFLOP/s, {bound['bound_ms'] / ms:.1%} of the "
        f"bound; max|err| {err:.3e} (tol {tol})")
    return {"shape": f"B={B} S={S} H={H} Hkv={Hkv} hd={hd} causal bf16",
            "ms": ms, "library_ms": sdpa_ms, "max_abs_err": err, **bound}


def ssd_at(device: torch.device, path: ServePath) -> Dict[str, Any]:
    """The SSD scan at a path's prefill shape: the call's five kernels by
    step beside the plain chunked scan and the bound."""
    cfg = path.cfg
    B, S, H, P, N, Q = (len(path.prompt_lens), max(path.prompt_lens),
                        cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                        cfg.ssm_chunk)
    args = ssd_inputs(B, S, H, P, N, torch.bfloat16, device, seed=1)
    err = max_err(ssd_scan(*args, chunk=Q)[0], ssd_chunked(*args, chunk=Q)[0])
    steps = {}
    for key, ms in device_ms_by_kernel(lambda: ssd_scan(*args, chunk=Q)).items():
        m = re.search(r"ssd_scan_(\w+?)_kernel", key)
        steps[m.group(1) if m else key] = ms
    return {"max_abs_err": err,
            "ms": sum(steps.values()),
            "steps_ms": steps,
            "plain_ms": device_ms(lambda: ssd_chunked(*args, chunk=Q), reps=5),
            "call_ms": time_ms(lambda: ssd_scan(*args, chunk=Q), reps=20),
            **roofline(ssd_scan_cost(*args, chunk=Q)),
            "library_ms": None,    # no single PyTorch call computes SSD
            "shape": f"B={B} S={S} H={H} P={P} N={N} chunk={Q} bf16"}


def ssd_entry(device: torch.device) -> Dict[str, Any]:
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:84",
            **ssd_at(device, MAMBA)}


def zoo_shapes(card: str, device: torch.device, entries: Dict[str, Any]
               ) -> None:
    """Flash at Z1's and Z2's prefill shapes and the SSD scan at Z2's (N =
    16: the kernels tile N in halves of 64), each beside its bound (and
    SDPA for flash), into ``entries[name]["zoo_shapes"]``."""
    for path in ZOO_PATHS:
        got = {"flash_attention": flash_at(device, *path_flash_shape(path))}
        if "ssd_scan" in path.kernels:
            got["ssd_scan"] = ssd_at(device, path)
        for name, r in got.items():
            entries[name].setdefault("zoo_shapes", {})[path.arch] = r
            log(f"{card} | {name} {path.arch} at {r['shape']}: kernel "
                f"{r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, library "
                f"{r['library_ms']}, bound {r['bound_ms']:.5f} ms "
                f"({r['bound_by']}): {r['bound_ms'] / r['ms']:.1%} of the "
                f"bound; max|err| {r['max_abs_err']:.3e}"
                + (f"; steps {r['steps_ms']}" if "steps_ms" in r else ""))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    start = time.perf_counter()
    device = resolve_device("cuda")
    card = card_line()
    print(card)
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()}")

    log("phase 2: build kernels")
    ptxas = build_kernels()
    log("phase 3: kernels against their plain versions")
    check_kernels(device)
    log("phase D1: host->device transfers, inline vs direct")
    transfers(card, device)
    transfer_passes(card, device)
    log("phase D2: the DMA-copy kernels against the plain tiled copy")
    copy_checks(device)
    dma_kernels = copy_path(card, device)

    log("phase G: ExecGraph's launch modes and the command-footprint law")
    graph_counts = exec_graphs(card, device)

    submission_path(card, device)

    counts = {path.arch: drive_path(path, card, device) for path in PATHS}

    log("phase C: continuous batching, ContinuousBatchingServer on DenseKV")
    c_counts = continuous_path(card, device)

    log("phase K: chunked prefill and the paged KV backend, gemma-2b")
    k_counts = kv_path(card, device)

    log("phase T: training, every launch one CUDA Graph replay")
    train_path(card, device)

    log("phase P: the submission-policy tuner, gemma-2b at full width")
    tuner_path(card, device)

    log("phase Z: the MoE and hybrid families at full width")
    t0 = time.perf_counter()
    z_counts, z_engines = zoo_path(card, device)
    counts.update(z_counts)
    log(f"{card} | phase Z: {time.perf_counter() - t0:.1f} s")

    log("kernels at their paths' shapes")
    kernels = [rms_entry(device), flash_entry(device), ssd_entry(device)]
    kernels[1]["long_s"] = flash_long(card, device)
    zoo_shapes(card, device, {e["name"]: e for e in kernels})
    for e in kernels:
        # launches: the replayed T=1 serves of every path that runs the
        # kernel; by path, every serve, the continuous engine's measured C1
        # replay at T=1 (phase Z's at T=4) and K1's measured replays
        e["launches_by_path"] = {
            arch: {f"T={T} {serve}": c.get(e["name"], 0)
                   for T, by_serve in by_T.items()
                   for serve, c in by_serve.items()}
            for arch, by_T in counts.items()
            if by_T[1]["replay"].get(e["name"], 0)}
        e["launches"] = sum(v["T=1 replay"]
                            for v in e["launches_by_path"].values())
        for arch, c in c_counts.items():
            if c.get(e["name"], 0):
                e["launches_by_path"][f"{arch} continuous"] = {
                    "C1 T=1 measured replay": c[e["name"]]}
        k1 = {f"K1 {mode} measured replay": c[e["name"]]
              for mode, c in k_counts.items() if c.get(e["name"], 0)}
        if k1:
            e["launches_by_path"][f"{GEMMA.arch} kv"] = k1
        for arch, by_engine in z_engines.items():
            z = {f"C1 T={T} measured replay": c[e["name"]]
                 for T, c in by_engine["C1"].items() if c.get(e["name"], 0)}
            z.update((f"K1 {mode} measured replay", c[e["name"]])
                     for mode, c in by_engine.get("K1", {}).items()
                     if c.get(e["name"], 0))
            if z:
                e["launches_by_path"][f"{arch} engines"] = z
        log(f"{card} | {e['name']} at {e['shape']}: device {e['ms']:.5f} ms "
            f"(per call with host {e['call_ms']:.5f} ms), bound "
            f"{e['bound_ms']:.5f} ms ({e['bound_by']}), plain "
            f"{e['plain_ms']:.5f} ms, library {e['library_ms']}, launches "
            f"{e['launches_by_path']}")
    kernels += dma_kernels
    kernels.append(graph_entry(card, device, graph_counts))
    for e in kernels:
        e["ptxas"] = {name: r for name, r in ptxas.items()
                      if name.split("<")[0] in REDESIGNED
                      and e["name"] in name}
    log(f"{card} | chip_smoke: {time.perf_counter() - start:.1f} s in all")
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
    if sys.argv[1:2] == [P3_FLAG]:
        sys.exit(policy_bench_main(*sys.argv[2:]))
    sys.exit(main())
