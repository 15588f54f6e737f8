"""The comparison that decides ``correct`` fails what it must: a run whose
timed path is broken underneath (the harness's look for a card skipped,
the rest of a run driven at smoke size on the CPU), and the control, the
reference computed in float8 in the program's place."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import bench_smoke
from bench import registry
from bench import run as brun


def _token_altered(monkeypatch):
    """Every greedy token one id off, where the step produces it."""
    from repro_torch.runtime import kv

    def off_by_one(logits):
        tok = torch.argmax(logits[:, -1:, :], dim=-1)
        return ((tok + 1) % logits.shape[-1]).to(torch.int32)
    monkeypatch.setattr(kv, "greedy", off_by_one)


def _state_unchanged(monkeypatch):
    """A decode step that leaves its state's length where it was."""
    from repro_torch.models.transformer import TransformerLM
    step = TransformerLM.decode_step

    def stale(self, params, state, tokens):
        out = step(self, params, state, tokens)
        state["length"].sub_(1)
        return out
    monkeypatch.setattr(TransformerLM, "decode_step", stale)


def _slots_crossed(monkeypatch):
    """The harvest hands each slot its neighbour's tokens."""
    from repro_torch.runtime.kv import DenseKV
    decode = DenseKV.decode
    monkeypatch.setattr(DenseKV, "decode",
                        lambda self: np.roll(decode(self), 1, axis=0))


def _one_slot_altered(monkeypatch):
    """Slot 0 alone harvests each token one id off; the rest are sound."""
    from repro_torch.runtime.kv import DenseKV
    decode = DenseKV.decode

    def off(self):
        out = decode(self).copy()
        out[0] = (out[0] + 1) % self.engine.cfg.vocab_size
        return out
    monkeypatch.setattr(DenseKV, "decode", off)


FAULTS = {"token_altered": _token_altered, "state_unchanged": _state_unchanged,
          "slots_crossed": _slots_crossed, "one_slot_altered": _one_slot_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["qwen2moe.chat", "deepseek7b.longctx"])
def test_a_broken_step_is_not_correct(monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    res, lines = bench_smoke.execute(monkeypatch, cell, 2 ** 31 + 11,
                                     dtype="bfloat16")
    assert res["correct"] is False, lines
    assert any(c["value"] > c["limit"] for n, c in res["checks"].items()
               if n != "failed_requests"), lines


@pytest.mark.parametrize("cell", ["qwen2moe.chat", "deepseek7b.chat"])
def test_the_float8_control_is_not_correct(monkeypatch, cell):
    """A run with the float8 reference in the program's place at the check
    reads ``correct`` false against the cell's own limits, on three seeds,
    at smoke size in bf16.  (``deepseek7b.longctx`` has the model, the
    reference and the limit of ``deepseek7b.chat``; its smoke cut checks
    some 20 tokens, too few for float8 to flip one.  At each cell's size on
    the card ``bench/calibrate.py`` judges the control the same way.)"""
    for seed in (2 ** 31 + 1, 7, 123456789):
        s, pc = bench_smoke.spec(cell, "bfloat16")
        monkeypatch.setattr(brun, "port_config", lambda name: pc)
        res, lines = brun.execute(s, seed, 1.5, False, torch.device("cpu"),
                                  time.perf_counter(), control=True)
        assert res["correct"] is False, (seed, lines)
        assert res["failed"] == 0 and any(
            c["value"] > c["limit"] for n, c in res["checks"].items()
            if n != "failed_requests"), (seed, lines)


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    """On a card: a short run of the first cell is correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.device import resolve_device
    name = registry.benchmark()["workloads"][0]["name"]
    res, lines = brun.execute(registry.resolve(name), 2 ** 31 + 5, 5.0, False,
                              resolve_device("cuda"), time.perf_counter())
    assert res is not None and res["correct"], lines
