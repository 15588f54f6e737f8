"""The port's launch tools against the reference's: ``report_md``'s
tables, ``hillclimb``'s overrides and kernel credit, the models'
``constraint`` hook, and the serve and train CLIs' sessions through
``fleet_session``.

``report_md`` renders the reference's markdown but for one column: the
reference asks whether a cell fits a TPU chip's 16 GiB, the port whether
it fits the H100's memory (``core/roofline.py::H100_SXM``).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.launch import report_md as ref_report

from repro_torch.configs import SMOKE_ARCHS, resolve
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core.roofline import H100_SXM
from repro_torch.launch import dryrun, hillclimb
from repro_torch.launch import report_md
from repro_torch.models import get_model
from repro_torch.models.layers import unembed

GiB = 2**30


# ---------------------------------------------------------------- report_md
def _roof(c, m, k, bound):
    return {"compute_s": c, "memory_s": m, "collective_s": k,
            "bottleneck": bound, "model_flops_ratio": 0.4321,
            "roofline_fraction": 0.01234, "ici_bytes_per_device": 3 * GiB}


RECORDS = [
    {"arch": "gemma-2b", "shape": "train_4k", "mesh": "single", "chips": 256,
     "status": "ok", "roofline": _roof(0.1, 1.5, 1.1, "memory"),
     "memory": {"argument_size_in_bytes": 12 * GiB,
                "output_size_in_bytes": 8 * GiB},
     "stream": {"collectives": {"all-gather": 5 * 2**20,
                                "all-reduce": 9 * 2**20,
                                "reduce-scatter": 2**20,
                                "all-to-all": 3 * 2**20}},
     "trace": {"events": 3, "by_kind": {"compile": 1, "dispatch": 2},
               "total_dispatch_s": 0.00123}},
    {"arch": "gemma-2b", "shape": "long_500k", "mesh": "single",
     "chips": 256, "status": "skip", "reason": "quadratic"},
    {"arch": "grok-1-314b", "shape": "train_4k", "mesh": "single",
     "chips": 256, "status": "error", "error": "boom"},
    {"arch": "mamba2-780m", "shape": "decode_32k", "mesh": "single",
     "chips": 256, "status": "ok", "roofline": _roof(2e-5, 1e-3, 0, "memory"),
     "memory": {"argument_size_in_bytes": GiB,
                "temp_size_in_bytes": GiB // 2},
     "stream": {"collectives": {}},
     "trace": {"events": 1, "by_kind": {"compile": 1}}},
    {"arch": "gemma-2b", "shape": "train_4k", "mesh": "multi", "chips": 512,
     "status": "ok", "roofline": _roof(0.05, 0.8, 0.9, "collective"),
     "memory": {}, "stream": {"collectives": {"all-reduce": 7 * 2**20,
                                             "all-gather": 2**19}}},
]
HILLCLIMB = [
    dict(RECORDS[0], label="base"),
    dict(RECORDS[0], label="credited",
         roofline_kernel_credited=_roof(0.05, 0.5, 1.1, "collective")),
    dict(RECORDS[2], label="broken"),
]


def _drop_last_column(table):
    return [row.rsplit("|", 2)[0] for row in table.splitlines()]


def test_roofline_table_is_the_references_but_the_memory_column():
    got = report_md.roofline_table(RECORDS, "single")
    want = ref_report.roofline_table(RECORDS, "single")
    assert _drop_last_column(got) == _drop_last_column(want)
    header = got.splitlines()[0]
    assert f"fits ≤{H100_SXM.hbm_bytes / GiB:.0f} GiB" in header
    assert H100_SXM.name in header
    # 20 GiB a device fits the H100, not a 16 GiB TPU chip
    assert got.splitlines()[2].endswith("| yes |")
    assert want.splitlines()[2].endswith("| no (20 GiB) |")


@pytest.mark.parametrize("table,mesh", [("collective_table", "multi"),
                                        ("collective_table", "single"),
                                        ("trace_table", "single")])
def test_tables_equal_the_references(table, mesh):
    assert getattr(report_md, table)(RECORDS, mesh) == \
        getattr(ref_report, table)(RECORDS, mesh)


def test_hillclimb_table_equals_the_references():
    assert report_md.hillclimb_table(HILLCLIMB) == \
        ref_report.hillclimb_table(HILLCLIMB)


def test_report_main_reads_missing_files(tmp_path, capsys):
    report_md.main(["--dryrun", str(tmp_path / "none.jsonl"),
                    "--hillclimb", str(tmp_path / "none.jsonl")])
    out = capsys.readouterr().out
    assert "256 ranks" in out and "512 ranks" in out


# ---------------------------------------------------------------- hillclimb
SMALL = ShapeConfig("decode_small", 32, 16, "decode")


@pytest.fixture
def small_cells(monkeypatch):
    """The dry-run's cells at smoke widths and a small decode shape."""
    monkeypatch.setattr(dryrun, "ARCHS", SMOKE_ARCHS)
    monkeypatch.setattr(dryrun, "SHAPES", {SMALL.name: SMALL})
    yield
    dryrun.release_fake_mesh()


def test_hillclimb_credit_and_overrides(small_cells, tmp_path, capsys):
    """``--kernel-credit tag:B`` moves memory_s by exactly (B - the tag's
    attributed bytes) / HBM bandwidth; ``--set`` reaches the config."""
    B = 12345
    rec = hillclimb.main([
        "--arch", "qwen3-8b", "--shape", SMALL.name, "--label", "t",
        "--set", "n_layers=1", "--kernel-credit",
        f"attention_interior:{B}", "--out", str(tmp_path / "h.jsonl")])
    credit = rec["kernel_credits"]["attention_interior"]
    assert credit["replaced_mem"] > 0
    moved = (rec["roofline_kernel_credited"]["memory_s"]
             - rec["roofline"]["memory_s"])
    assert math.isclose(moved, (B - credit["replaced_mem"]) / H100_SXM.hbm_bw,
                        rel_tol=1e-12)
    assert rec["overrides"] == {"n_layers": 1}
    cfg = dataclasses.replace(resolve(SMOKE_ARCHS["qwen3-8b"], 16),
                              n_layers=1)
    assert rec["model_params_total"] == cfg.param_counts()[0]
    assert (tmp_path / "h.jsonl").read_text().count("\n") == 1
    assert "--- top MEM ---" in capsys.readouterr().out


# ---------------------------------------------------------------- constraint
def _counting(model):
    calls = []

    def hook(x):
        calls.append(tuple(x.shape))
        return x
    model.constraint = hook
    return calls


def _f32(arch):
    return dataclasses.replace(SMOKE_ARCHS[arch], param_dtype="float32")


def _tokens(cfg, B=2, S=16):
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                            .astype(np.int64))


def _forward(model, cfg, params, mode):
    """The forward path the reference constrains, to logits: per stack
    for the encoder-decoder."""
    toks = _tokens(cfg)
    if cfg.family == "audio":
        frames = torch.randn(2, 32, cfg.d_model,
                             generator=torch.Generator().manual_seed(0))
        enc = model.encode(params, frames, mode=mode)
        x = model.decode_train(params, toks, enc, mode=mode)
    elif cfg.family == "vlm":
        patches = torch.randn(2, cfg.n_patches, cfg.d_model,
                              generator=torch.Generator().manual_seed(0))
        x = model._forward_embeds(
            params, model._inject(params, toks, patches), mode)
    else:
        x = model.hidden_states(params, toks, mode=mode)
    return unembed(params["emb"], x)


FAMILIES = ["gemma-2b", "qwen2-moe-a2.7b", "mamba2-780m", "jamba-v0.1-52b",
            "whisper-medium", "llava-next-34b"]


@pytest.mark.parametrize("mode", ["serve", "train"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_constraint_identity_and_its_points(arch, mode):
    """The identity leaves fp32 logits bit-equal; a counting constraint
    runs where the reference applies it: on the residual entering the
    stack and after each layer (the hybrid's scan body is a group; the
    encoder's stack takes no entry constraint), once a layer, where the
    reference's scan traces its body once."""
    cfg = _f32(arch)
    model = get_model(cfg, impl="ref", device="cpu")
    params = model.init_params(0)
    plain = _forward(model, cfg, params, mode)
    calls = _counting(model)
    hooked = _forward(model, cfg, params, mode)
    assert torch.equal(plain, hooked)
    if cfg.family == "audio":
        want = cfg.n_enc_layers + cfg.n_layers + 1
    elif cfg.family == "hybrid":
        want = cfg.n_layers // cfg.attn_every + 1
    else:
        want = cfg.n_layers + 1
    assert len(calls) == want, calls


def test_constraint_is_not_applied_by_the_prefill():
    """The reference's dense prefill scans without the constraint."""
    cfg = _f32("gemma-2b")
    model = get_model(cfg, impl="ref", device="cpu")
    params = model.init_params(0)
    calls = _counting(model)
    model.prefill(params, _tokens(cfg).to(torch.int32), 32)
    assert calls == []


# ---------------------------------------------------------------- CLIs
@pytest.mark.parametrize("cli,argv", [
    ("serve", ["--smoke", "--device", "cpu", "--batch", "2",
               "--new-tokens", "2", "--tokens-per-launch", "1"]),
    ("train", ["--smoke", "--device", "cpu", "--steps", "1", "--seq", "16",
               "--batch", "2", "--steps-per-launch", "1"]),
])
def test_cli_session_comes_from_fleet_session(cli, argv, tmp_path,
                                              monkeypatch):
    """As process 3 of 4, each CLI's ``--trace t.jsonl`` writes
    ``t.p3.jsonl`` through one ``fleet_session`` call."""
    import importlib
    mod = importlib.import_module(f"repro_torch.launch.{cli}")
    real = mod.fleet_session
    calls = []

    def counted(name, trace_path=None):
        calls.append((name, trace_path))
        return real(name, trace_path=trace_path)

    monkeypatch.setattr(mod, "fleet_session", counted)
    monkeypatch.setenv("REPRO_PROCESS_ID", "3")
    monkeypatch.setenv("REPRO_PROCESS_COUNT", "4")
    trace = tmp_path / "t.jsonl"
    mod.main(argv + ["--trace", str(trace)])
    assert calls == [(cli, str(trace))]
    shard = tmp_path / "t.p3.jsonl"
    assert shard.exists() and shard.stat().st_size > 0
    assert not trace.exists()


# ---------------------------------------------------------------- phase R
def test_chip_smoke_phase_r_rehearsal(small_cells, monkeypatch, capsys):
    """``chip_smoke.py`` phase R on the CPU at smoke widths: R1's cells
    (each gathering what ``R_REPLICATED`` says: the smoke widths' heads
    do not split evenly over 16 ranks) and the PP cell, R2 on meta against
    meta, R3's checks, R4's report."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "R_CELLS", [("qwen3-8b", SMALL.name),
                                                ("mamba2-780m", SMALL.name)])
    monkeypatch.setattr(chip_smoke, "R_REPLICATED", {
        ("qwen3-8b", SMALL.name): {"aten.view.default": 1},
        ("mamba2-780m", SMALL.name): {"aten.view.default": 2}})
    monkeypatch.setattr(chip_smoke, "R_WORKERS", 1)
    monkeypatch.setattr(chip_smoke, "R_PP", ("llama3-405b", SMALL.name))
    monkeypatch.setattr(chip_smoke, "R_EXEC", ("gemma-2b", SMALL.name))
    monkeypatch.setattr(chip_smoke, "R_HILLCLIMB", [
        "--arch", "qwen3-8b", "--shape", SMALL.name, "--label", "R3",
        "--set", "attn_chunk=2048",
        "--kernel-credit", "attention_interior:1048576"])
    recs = chip_smoke.dryrun_path("cpu", torch.device("cpu"))
    assert [r["status"] for r in recs] == ["ok"] * 4
    assert recs[2]["pp"] is True
    out = capsys.readouterr().out
    assert out.count("| R1 ") == 3
    assert "op entries equal the meta record's" in out
    assert "| R3 hillclimb" in out
    assert "| R3 | qwen3-8b × decode_small |" in out
