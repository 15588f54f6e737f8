"""The dry-run's weighted layer stacks (``models.layers.layer_loop``,
``core.stream.restamp``) against its full-depth recording.

On ``meta`` the dry-run records each layer stack as the reference's scan
body: the layers run until one's output is laid out as its input was, and
that layer's entries stand for the layers left (``multiplier``).  Every
total of the record must be the full-depth recording's
(``dryrun.weighted_differences``: integers equal, floats within 1e-9
relative).  One smoke arch a family, at train, prefill and decode, on a
fake 2 x 4 mesh, at 4 layers (4 encoder layers for whisper, 3 groups of 8
for the hybrid); and the dense and Mamba2 decode on a fake 2 x 2 x 2 mesh,
three mesh dims as the production 2 x 16 x 16 has.  On three mesh dims
DTensor's redistribution planner searches a graph for each new layout: at
these widths a llava decode took 790 s and a gemma prefill 479 s, so the
other cells of that mesh are held at published widths by
``scripts/dryrun_depth_check.py --mesh multi`` instead.

A file of its own, so that a worker runs it beside the other dry-run
files; a module fixture destroys the fake group after its tests.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core import stream
from repro_torch.launch import dryrun

FAMILY_ARCHS = ("gemma-2b", "qwen2-moe-a2.7b", "mamba2-780m",
                "jamba-v0.1-52b", "whisper-medium", "llava-next-34b")
#: (arch, kind, fake mesh): every family and kind on 2 x 4, and the decode
#: of the dense and the Mamba2 family on three mesh dims
CASES = ([(a, k, (2, 4)) for a in FAMILY_ARCHS
          for k in ("train", "prefill", "decode")]
         + [(a, "decode", (2, 2, 2)) for a in ("gemma-2b", "mamba2-780m")])


@pytest.fixture(scope="module", autouse=True)
def _fake_group():
    yield
    dryrun.release_fake_mesh()


def _deep(arch):
    cfg = SMOKE_ARCHS[arch]
    over = {"n_layers": 3 * cfg.attn_every if cfg.family == "hybrid"
            else 4}
    if cfg.n_enc_layers:
        over["n_enc_layers"] = 4
    return dataclasses.replace(cfg, **over)


@pytest.mark.parametrize("arch,kind,sizes", CASES, ids=[
    f"{a}-{k}-{'x'.join(map(str, m))}" for a, k, m in CASES])
def test_weighted_record_equals_full_depth(arch, kind, sizes):
    cfg = _deep(arch)
    mesh = dryrun.fake_mesh(sizes=sizes)
    shape = ShapeConfig(kind, 64, 8, kind)
    full = dryrun.dry_cell(cfg, shape, mesh, arch, {}, full_depth=True,
                           keep_artifacts=True)
    weighted = dryrun.dry_cell(cfg, shape, mesh, arch, {},
                               keep_artifacts=True)
    cs_w, cs_f = weighted.pop("_captured"), full.pop("_captured")
    assert dryrun.weighted_differences(weighted, full) == []
    # the stack was weighted: fewer entries, some standing for several
    # layers, the full-depth record's all for one
    assert weighted["stream"]["n_ops"] < full["stream"]["n_ops"]
    assert max(e.multiplier for e in cs_w.stream.entries) > 1
    assert {e.multiplier for e in cs_f.stream.entries} == {1}
    assert weighted["stream"]["n_ops"] == len(cs_w.stream.entries)


def test_recorder_scope_stamps_its_entries():
    """Entries recorded under ``set_multiplier(n)``, or between a ``mark``
    and its ``restamp(n)``, carry ``n``; those outside carry 1.  A gathered
    op's ``replicated_ops`` count is its first entry's multiplier."""
    seen = []

    def run(x):
        seen.append(stream.weighted_stacks.active())
        y = x + 1                       # outside: 1
        prev = stream.set_multiplier(5)
        with dryrun._gathering("mul"):
            y = y * 2                   # inside: 5
        assert stream.set_multiplier(prev) == 5
        at = stream.mark()
        with dryrun._gathering("sub"):
            y = y - 3                   # restamped to 7 below
        stream.restamp(at, 7)
        return y.sum()                  # outside: 1

    dryrun._GATHERED.clear()
    with stream.weighted_stacks():
        cs = stream.record_ops(run, torch.ones(4))
        assert not stream.weighted_stacks.active()   # nothing records
    assert seen == [True]
    assert [(e.opcode, e.multiplier) for e in cs.entries] == [
        ("add", 1), ("mul", 5), ("sub", 7), ("sum", 1)]
    assert cs.total_flops == 4 + 5 * 4 + 7 * 4 + 4
    assert dryrun.replicated_ops(cs.entries) == {"mul": 5, "sub": 7}
    # nothing records now: no position, nothing stamped, no gather kept
    assert stream.mark() is None and stream.set_multiplier(3) == 1
    with dryrun._gathering("add"):
        torch.ones(2) + 1
    assert dryrun.replicated_ops(cs.entries) == {"mul": 5, "sub": 7}
    dryrun._GATHERED.clear()
