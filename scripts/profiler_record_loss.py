#!/usr/bin/env python3
"""Where torch.profiler loses kernel records on a CUDA card, and whether
CUPTI's dropped-record count sees it.

    python3 scripts/profiler_record_loss.py

Captures two CUDA Graphs of ``x.add_(1)`` on 16 floats (50 and 500 nodes).
Then, in rounds, it traces 1 M kernels (2000 replays of the 500-node graph,
in a window of its own) to age the process's tracer, and opens three small
windows: 20 replays of the 50-node graph alone; the same behind 64 eager
``torch.cuda._sleep`` kernels; and the same behind one replay of a graph
of 64 such kernels.  For each small window it prints which eager launches
(by position) and which graph launches (by position, records seen against
nodes) lost device records, matched through the correlation ids of the
``cudaLaunchKernel`` / ``cudaGraphLaunch`` records, and CUPTI's
dropped-record count over the window (``cuptiActivityGetNumDroppedRecords``
on the libcupti the profiler loaded, reset just before it).  Each round then
opens two tail windows, 83 replays of the 500-node graph behind the 64
eager spin kernels (about 41,500 records, the size of a serving window),
without and with a forced ``cuptiActivityFlushAll`` just before the window
closes, and prints the same for them: whether the forced flush saves
records the tracer would lose at a window's end.  The first line is the
card's name and power limit.  Needs one CUDA card.
"""
from __future__ import annotations

import ctypes
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

ROUNDS = 3
SMALL_REPLAYS = 20
SENTINELS = 64
MARGIN_S = 0.05
TAIL_REPLAYS = 83


def cupti() -> ctypes.CDLL:
    with open("/proc/self/maps") as maps:
        paths = sorted({line.split()[-1] for line in maps if "libcupti" in line})
    return ctypes.CDLL(paths[0])


def cupti_dropped() -> int:
    n = ctypes.c_size_t()
    err = cupti().cuptiActivityGetNumDroppedRecords(
        None, ctypes.c_uint32(0), ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuptiActivityGetNumDroppedRecords: error {err}")
    return n.value


def captured(n: int, fn) -> torch.cuda.CUDAGraph:
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    torch.cuda.synchronize()
    return g


def window(label: str, body: torch.cuda.CUDAGraph, eager: int = 0,
           lead: torch.cuda.CUDAGraph = None, replays: int = SMALL_REPLAYS,
           body_nodes: int = 50, flush: bool = False) -> None:
    torch.cuda.synchronize()
    cupti_dropped()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        time.sleep(MARGIN_S)
        for _ in range(eager):
            torch.cuda._sleep(1)
        if lead is not None:
            lead.replay()
        for _ in range(replays):
            body.replay()
        torch.cuda.synchronize()
        if flush:           # CUPTI_ACTIVITY_FLAG_FLUSH_FORCED
            err = cupti().cuptiActivityFlushAll(ctypes.c_uint32(1))
            if err:
                raise RuntimeError(f"cuptiActivityFlushAll: error {err}")
        time.sleep(MARGIN_S)
    dropped = cupti_dropped()
    events = list(p.profiler.kineto_results.events())
    records: dict = {}
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            records[e.correlation_id()] = records.get(e.correlation_id(), 0) + 1

    def launched(name):
        return [e.correlation_id() for e in sorted(
            (e for e in events if e.name() == name), key=lambda e: e.start_ns())]
    lost_eager = [i for i, c in enumerate(launched("cudaLaunchKernel"))
                  if c not in records]
    nodes = ([SENTINELS] if lead is not None else []) + [body_nodes] * replays
    short = [(i, records.get(c, 0), n) for i, (c, n) in
             enumerate(zip(launched("cudaGraphLaunch"), nodes))
             if records.get(c, 0) != n]
    print(f"{label}: eager launches without a record {lost_eager} of {eager}; "
          f"graph launches short (position, records, nodes) {short}; CUPTI "
          f"dropped {dropped}", flush=True)


def main() -> None:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    x = torch.zeros(16, device="cuda")
    small = captured(50, lambda: x.add_(1))
    big = captured(500, lambda: x.add_(1))
    spin = captured(SENTINELS, lambda: torch.cuda._sleep(1))
    window("fresh process, graph first", small)
    for r in range(1, ROUNDS + 1):
        with profile(activities=[ProfilerActivity.CUDA]):
            for _ in range(2000):
                big.replay()
            torch.cuda.synchronize()
        print(f"-- {r} M kernel records traced", flush=True)
        window("graph first", small)
        window(f"{SENTINELS} eager spin kernels first", small, eager=SENTINELS)
        window(f"a graph of {SENTINELS} spin kernels first", small, lead=spin)
        for flush in (False, True):
            window(f"tail: {TAIL_REPLAYS} replays of 500 nodes, forced flush "
                   f"{'on' if flush else 'off'}", big, eager=SENTINELS,
                   replays=TAIL_REPLAYS, body_nodes=500, flush=flush)


if __name__ == "__main__":
    main()
