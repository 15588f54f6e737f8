"""What the per-layer readers share: the traced slice's graph launches
matched to the steps that made them, and the costs of each."""
from __future__ import annotations

from typing import Any, Iterator, List, Tuple

from .costs.kernels import bound_s, flash_attention_cost, rms_norm_cost

__all__ = ["decode_launches", "prefill_launches", "kernel_roofline"]


def _launches(run: Any, prefix: str) -> Iterator[Tuple[int, Any]]:
    tr = run.traced
    if tr is None or not tr.matched:
        return
    for step in tr.steps:
        a, b = step.replays
        for i in range(a, b):
            if tr.launches[i][0].startswith(prefix):
                yield i, step


def decode_launches(run: Any) -> List[Tuple[float, Any]]:
    """(device s, step) of each decode launch in the slice."""
    tr = run.traced
    return [(tr.launches[i][1], step) for i, step in _launches(run, "decode")]


def prefill_launches(run: Any) -> List[Tuple[int, int]]:
    """(launch index, prompt length) of each prefill in the slice."""
    tr = run.traced
    return [(i, int(tr.launches[i][0].split("=")[1]))
            for i, _ in _launches(run, "prefill S=")]


def decode_bytes(run: Any, step: Any) -> int:
    """What a decode launch needs to read: the weights once a step that
    kept a token, and each request's K/V at its length at each step."""
    sh = run.shapes
    steps = max(step.kept, default=0)
    kv = sum(sh.decode_step_bytes(n + t)
             for n, k in zip(step.decoded, step.kept) for t in range(k))
    return steps * sh.weight_bytes + kv


def decode_flops(run: Any, step: Any) -> int:
    sh = run.shapes
    return sum(sh.decode_token_flops(n + t)
               for n, k in zip(step.decoded, step.kept) for t in range(k))


def kernel_roofline(run: Any, name: str) -> Any:
    """Percent of the roofline of every record of kernel ``name`` in the
    slice: its calls' least times (the frozen costs at each call's shape)
    over their device time; None where none ran."""
    tr = run.traced
    if tr is None or not tr.matched:
        return None
    s, pk = run.shapes.s, run.peaks
    item = run.shapes.item
    B = run.cell["engine"]["batch_size"]
    need = took = 0.0
    for i, step in _launches(run, ""):
        label = tr.launches[i][0]
        S = int(label.split("=")[1]) if label.startswith("prefill S=") else 0
        for kname, sec in tr.kernels[i]:
            if name not in kname:
                continue
            if name == "flash_attention":
                if not S:
                    continue
                ops, nb = flash_attention_cost(1, S, S, s["H"], s["Hkv"],
                                               s["hd"], item)
            elif name == "rms_norm":
                ops, nb = rms_norm_cost(S or B, s["d"], item)
            else:
                raise ValueError(f"no cost for kernel {name!r}")
            need += bound_s(ops, nb, pk["bf16_flops"], pk["hbm_bytes_per_s"])
            took += sec
    return 100.0 * need / took if took > 0 else None
