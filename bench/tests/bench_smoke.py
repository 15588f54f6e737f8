"""Smoke-size cells for the benchmark's CPU tests: the port's smoke
configurations, the mixes cut to short prompts and outputs, a few slots."""
from __future__ import annotations

import dataclasses
import re
import sys
import time
from pathlib import Path
from typing import Any, Dict, Tuple

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from bench import registry  # noqa: E402
from bench import run as brun  # noqa: E402

CONFIGS = {
    "moe": {"name": "qwen2-moe-smoke", "port_config": "qwen2-moe-smoke",
            "family": "moe", "hidden_size": 64, "num_hidden_layers": 2,
            "num_attention_heads": 4, "num_key_value_heads": 4,
            "head_dim": 16, "moe_intermediate_size": 32,
            "shared_expert_intermediate_size": 64, "num_experts": 8,
            "num_experts_per_tok": 4, "vocab_size": 256,
            "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
            "norm_topk_prob": False,
            "departures": {"prefill_capacity_factor": 1.25,
                           "norm_topk_prob": True}},
    "dense": {"name": "deepseek-smoke", "port_config": "deepseek-smoke",
              "family": "dense", "hidden_size": 64, "num_hidden_layers": 2,
              "num_attention_heads": 4, "num_key_value_heads": 4,
              "head_dim": 16, "intermediate_size": 128, "vocab_size": 256,
              "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
              "departures": {}},
}
CELLS = {"qwen2moe.chat": "moe", "deepseek7b.chat": "dense",
         "deepseek7b.longctx": "dense"}
#: limits at smoke size in bf16, where they differ from the cell's: on five
#: seeds the port reads p90_logit_gap 0 and worst_request_off_share 0, the
#: float8 control 0.18-0.24 and 0.25-0.375 (a cell's limits are set at its
#: own size on the card)
SMOKE_LIMITS = {"qwen2moe.chat": {"p90_logit_gap": 0.08,
                                  "worst_request_off_share": 0.1}}


def spec(cell: str, dtype: str = "float32") -> Tuple[Dict[str, Any], Any]:
    """A cell at smoke size, and the port's configuration it runs."""
    from repro_torch.configs import SMOKE_ARCHS
    cfg = dict(CONFIGS[CELLS[cell]], torch_dtype=dtype)
    pc = next(c for c in SMOKE_ARCHS.values() if c.name == cfg["port_config"])
    s = dict(registry.cell(cell))
    mix = dict(registry.mix(s["traffic"]))
    n = len(mix["prompt_lens"])
    mix.update(prompt_lens=[8, 16, 24, 32][:n],
               output_lens=[4, 8, 12, 16][:len(mix["output_lens"])],
               queue=16, drain_s=10)
    s.update(config_spec=cfg, mix_spec=mix, rate=20.0,
             engine=dict(s["engine"], batch_size=4, max_seq=64))
    if cell in SMOKE_LIMITS:
        s["check"] = dict(s["check"], limits=SMOKE_LIMITS[cell])
    return s, dataclasses.replace(pc, param_dtype=dtype)


def reading(lines: Any, name: str) -> float:
    """A number the run printed on standard error, compared or not."""
    for ln in lines:
        m = re.match(rf"(check|read \(not compared\)) {name} (\S+)", ln)
        if m:
            return float(m.group(2))
    raise KeyError(name)


def execute(monkeypatch: Any, cell: str, seed: int, dtype: str = "float32",
            seconds: float = 1.5) -> Tuple[Dict[str, Any], Any]:
    """One run of the smoke cell on the CPU, the harness's look for a card
    skipped; returns (result, the stderr lines)."""
    s, pc = spec(cell, dtype)
    monkeypatch.setattr(brun, "port_config", lambda name: pc)
    return brun.execute(s, seed, seconds, False, torch.device("cpu"),
                        time.perf_counter())
