"""The port's tuner (``repro_torch.tune``) against the reference's
(``repro.tune``) on the CPU, at smoke size.

Search and objective are held bit for bit (the same trial logs, the same
float64 scores); the measurement workloads by their counts (doorbells,
tokens, transfer bytes), never by their times; policies by their schema and
files; and each knob owner of the port (``Server``,
``ContinuousBatchingServer``, ``Trainer``, ``HybridMover``, the serve and
train CLIs) by the knob it picks up from a persisted policy.
"""
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import textwrap
import warnings
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings, strategies as st

from repro import tune as ref_tune
from repro.configs import SMOKE_ARCHS as REF_SMOKE
from repro.core.session import TraceSession as RefSession
from repro.tune import autotune as ref_autotune
from repro_torch import tune
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core.dma import INLINE_THRESHOLD_DEFAULT, HybridMover
from repro_torch.core.session import TraceSession
from repro_torch.runtime.server import ContinuousBatchingServer, Server
from repro_torch.runtime.trainer import Trainer
from repro_torch.tune import autotune, policy as port_policy
from repro_torch.tune.autotune import CandidateEvaluator, WorkloadSpec

ROOT = Path(__file__).resolve().parents[1]
ARCH = "gemma-2b"
CFG = SMOKE_ARCHS[ARCH]
SET = dict(max_examples=50, deadline=None)
# the workloads' sizes for the parity cases: small enough for the
# reference's compiles, large enough that every knob changes the counts
SPEC = dict(new_tokens=4, max_seq=32, serve_requests=4, train_steps=4)


@pytest.fixture(autouse=True)
def _clean_port_policy():
    """The port's ambient policy is module state: no test inherits one."""
    tune.clear_active_policy()
    yield
    tune.clear_active_policy()


def _policy(**knobs):
    return tune.Policy(arch=CFG.name, platform="cpu", device_count=1,
                       knobs=knobs, objective={"before": 2.0, "after": 1.0})


# -- search ------------------------------------------------------------------

def _evaluator(kind, seed):
    """A seeded synthetic objective over knobs a (5 values) and b (4)."""
    rng = np.random.default_rng(seed)
    if kind == "separable":
        fa, fb = rng.random(5), rng.random(4)
        return lambda k: float(fa[k["a"]] + fb[k["b"]])
    if kind == "coupled":
        table = rng.random((5, 4))
        return lambda k: (float(table[k["a"], k["b"]]),
                          {"cell": int(k["a"] * 4 + k["b"])})
    table = rng.integers(0, 3, size=(5, 4)).astype(float)   # many ties
    return lambda k: float(table[k["a"], k["b"]])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["separable", "coupled", "ties"])
def test_coordinate_descent_trial_log_equals_reference(kind, seed):
    ev = _evaluator(kind, seed)
    spec = [("a", (0, 1, 2, 3, 4), 2), ("b", (3, 2, 1, 0), None)]
    results = []
    for pkg in (ref_tune, tune):
        knobs = [pkg.Knob(n, v, default=d) for n, v, d in spec]
        results.append(pkg.coordinate_descent(ev, knobs, max_rounds=4))
    ref, port = results
    assert [t.to_dict() for t in port.trials] == \
        [t.to_dict() for t in ref.trials]
    assert (port.best, port.best_score, port.start_score, port.rounds) == \
        (ref.best, ref.best_score, ref.start_score, ref.rounds)
    assert port.improvement == ref.improvement


def test_knob_requires_values():
    with pytest.raises(ValueError):
        tune.Knob("empty", ())


@given(st.one_of(st.text(max_size=12),
                 st.sampled_from(["True", "False", "7", "-3", "0.5", "1e3",
                                  "nan", "inf", " 4", "0x10", "1_000"])))
@settings(**SET)
def test_parse_value_equals_reference(v):
    got, want = tune.parse_value(v), ref_tune.parse_value(v)
    assert type(got) is type(want)
    assert got == want or (got != got and want != want)     # nan == nan


@given(st.text(max_size=24))
@settings(**SET)
@example("jit(step)/fusion:attn:softmax:4.2e6")
@example("novalue")
def test_parse_spec_equals_reference(spec):
    try:
        want = ref_tune.parse_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(",")[0]):
            tune.parse_spec(spec)
        return
    got = tune.parse_spec(spec)
    assert got[0] == want[0] and type(got[1]) is type(want[1])
    assert got[1] == want[1] or (got[1] != got[1] and want[1] != want[1])


# -- objective ---------------------------------------------------------------

_metric_args = dict(
    d1=st.floats(0, 10, allow_nan=False), d2=st.floats(0, 10, allow_nan=False),
    transfer_s=st.floats(0, 5, allow_nan=False),
    doorbells=st.integers(0, 1000), tokens=st.integers(0, 1 << 16))


@given(**_metric_args)
@settings(**SET)
@example(d1=0.0, d2=6.984604533506604e-174, transfer_s=0.0, doorbells=1,
         tokens=1)
def test_objective_score_bit_identical_to_reference(d1, d2, transfer_s,
                                                    doorbells, tokens):
    """The same Metrics score the same float64 in both packages, including
    the reference's fault: at d1=0, d2=6.98e-174 both give equal scores."""
    for d in (d1, d2):
        kw = dict(dispatch_s=d, transfer_s=transfer_s, doorbells=doorbells,
                  tokens=tokens)
        got = tune.Objective().score(tune.Metrics(**kw))
        want = ref_tune.Objective().score(ref_tune.Metrics(**kw))
        assert got.hex() == want.hex()
    kw = dict(transfer_s=transfer_s, doorbells=doorbells, tokens=tokens)
    if (d1, d2, transfer_s, doorbells, tokens) == \
            (0.0, 6.984604533506604e-174, 0.0, 1, 1):
        assert tune.Objective().score(tune.Metrics(dispatch_s=d1, **kw)) == \
            tune.Objective().score(tune.Metrics(dispatch_s=d2, **kw))


@given(**_metric_args)
@settings(**SET)
@example(d1=0.0, d2=6.984604533506604e-174, transfer_s=0.0, doorbells=1,
         tokens=1)
@example(d1=1e-310, d2=2e-310, transfer_s=0.0, doorbells=0, tokens=65536)
def test_objective_monotone_in_dispatch_time_within_float(d1, d2, transfer_s,
                                                          doorbells, tokens):
    """What a float objective can guarantee: the score never decreases in
    dispatch time, and rises strictly whenever the dispatch term's exact
    change per token exceeds 8 ulps of the higher score (the three
    roundings of the cost and the one of the division each side err by
    under 4 ulps).  Below that a dispatch time can vanish in the sum, as
    d2=6.98e-174 does beside 5e-6 of doorbell cost."""
    obj = tune.Objective()
    kw = dict(transfer_s=transfer_s, doorbells=doorbells, tokens=tokens)
    lo = obj.score(tune.Metrics(dispatch_s=min(d1, d2), **kw))
    hi = obj.score(tune.Metrics(dispatch_s=max(d1, d2), **kw))
    assert lo <= hi
    gap = obj.weights.dispatch * (max(d1, d2) - min(d1, d2)) / max(1, tokens)
    if gap > 8 * math.ulp(hi):
        assert lo < hi


def test_objective_scores_per_token_and_compile_free():
    obj = tune.Objective(tune.ObjectiveWeights(dispatch=1.0, transfer=1.0,
                                               doorbell_cost_s=0.0))
    m = tune.Metrics(dispatch_s=1.0, transfer_s=0.5, compile_s=100.0,
                     tokens=10)
    assert obj.score(m) == pytest.approx(0.15)
    with pytest.raises(ValueError):
        tune.ObjectiveWeights(dispatch=0.0)


def _emit_all(sess):
    sess.emit("dispatch", "warm", dur_s=5.0)
    before = sess.summary()
    sess.emit("dispatch", "d", dur_s=0.25)
    sess.emit("dispatch", "d", dur_s=0.25)
    sess.emit("transfer", "inline_put", dur_s=0.5, payload_bytes=2**30)
    sess.emit("compile", "c", dur_s=1.0)
    return before


def test_metrics_from_summary_equals_reference():
    """The same events through each package's TraceSession give the same
    Metrics, with and without a warm-up delta."""
    out = []
    for Session, pkg in ((RefSession, ref_tune), (TraceSession, tune)):
        with Session(name="t") as sess:
            before = _emit_all(sess)
            summary = sess.summary()
        out.append([pkg.metrics_from_summary(summary, tokens=10),
                    pkg.metrics_from_summary(summary, before, tokens=10)])
    for want, got in zip(*out):
        w, g = want.to_dict(), got.to_dict()
        for key in ("doorbells", "transfer_bytes", "tokens"):
            assert g[key] == w[key]
        for key in ("dispatch_s", "transfer_s", "compile_s",
                    "doorbells_per_token", "transfer_bandwidth_gib_s"):
            assert g[key] == pytest.approx(w[key])
    assert out[1][1].doorbells == 2 and out[1][0].doorbells == 3


# -- policy ------------------------------------------------------------------

def test_policy_schema_and_files_cross_load(tmp_path):
    port = _policy(tokens_per_launch=4, dma_threshold_bytes=0)
    ref = ref_tune.Policy(**dataclasses.asdict(port))
    assert port.to_dict() == ref.to_dict()
    assert tune.policy.KNOB_NAMES == ref_tune.policy.KNOB_NAMES
    assert sorted(tune.__all__) == sorted(ref_tune.__all__)
    # a file written by one package loads in the other's from_dict
    for save, Loader in ((tune.save_policy, ref_tune.Policy),
                         (ref_tune.save_policy, tune.Policy)):
        path = save(port, str(tmp_path / Loader.__module__))
        with open(path) as f:
            assert Loader.from_dict(json.load(f)).to_dict() == port.to_dict()


def test_policy_files_live_in_torch_subdir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_POLICY_DIR", str(tmp_path))
    assert tune.default_policy_dir() == str(tmp_path / "torch")
    path = tune.save_policy(_policy(tokens_per_launch=3))
    assert path == str(tmp_path / "torch" / f"{CFG.name}__cpu__d1.json")
    # the reference's lookup, keyed the same, does not see the port's file
    assert ref_tune.load_policy(CFG.name, "cpu", 1) is None
    assert tune.load_policy(CFG.name, device="cpu").knob(
        "tokens_per_launch") == 3
    # an explicit policy_dir is used as given
    explicit = tune.save_policy(_policy(), str(tmp_path / "mine"))
    assert explicit == str(tmp_path / "mine" / f"{CFG.name}__cpu__d1.json")
    assert port_policy.platform_of("cpu") == ("cpu", 1)
    assert port_policy.platform_of(None)[0] == "cuda"


def test_load_policy_relaxed_device_count_and_disable(tmp_path, monkeypatch):
    tune.save_policy(_policy(tokens_per_launch=2), str(tmp_path))
    assert tune.load_policy(CFG.name, "cpu", 8, str(tmp_path)).knobs[
        "tokens_per_launch"] == 2
    assert tune.load_policy("other-arch", "cpu", 1, str(tmp_path)) is None
    assert tune.load_policy(CFG.name, "cuda", 1, str(tmp_path)) is None
    monkeypatch.setenv("REPRO_POLICY_DISABLE", "1")
    assert tune.load_policy(CFG.name, "cpu", 1, str(tmp_path)) is None
    tune.activate_policy(_policy(dma_threshold_bytes=0))
    assert tune.resolve_knob("dma_threshold_bytes", 7) == 7


# -- environment -------------------------------------------------------------

def test_env_preset_applies_cuda_env_without_warning(monkeypatch):
    monkeypatch.delenv("CUDA_MODULE_LOADING", raising=False)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    preset = tune.EnvPreset(cuda_env="CUDA_MODULE_LOADING=LAZY",
                            device_count=1, platform="cpu")
    assert not torch.cuda.is_initialized()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        preset.apply()
    assert not [w for w in caught if issubclass(w.category, RuntimeWarning)]
    assert os.environ["CUDA_MODULE_LOADING"] == "LAZY"
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "0"
    assert tune.EnvPreset.from_dict(preset.to_dict()) == preset
    snap = tune.snapshot_env("cpu")
    assert set(snap) == {"platform", "device_count", "device_name",
                         "cuda_env", "torch_version", "cuda_version"}
    assert snap["platform"] == "cpu" and snap["device_count"] == 1
    assert snap["cuda_env"]["CUDA_MODULE_LOADING"] == "LAZY"
    with pytest.raises(ValueError):
        tune.EnvPreset(cuda_env="NOEQUALS").apply()
    with pytest.raises(ValueError):
        tune.EnvPreset(platform="tpu").apply()


def test_env_preset_warns_once_cuda_is_initialized(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.delenv("CUDA_MODULE_LOADING", raising=False)
    with pytest.warns(RuntimeWarning, match="after CUDA initialization"):
        tune.EnvPreset(cuda_env="CUDA_MODULE_LOADING=EAGER").apply()


# -- auto-apply --------------------------------------------------------------

def test_server_and_engine_auto_apply_persisted_policy():
    tune.save_policy(_policy(tokens_per_launch=3, kv_page_tokens=8,
                             prefill_chunk=4))
    srv = Server(CFG, batch_size=2, max_seq=64, device="cpu")
    assert srv.T == 3 and srv.policy is not None
    explicit = Server(CFG, batch_size=2, max_seq=64, tokens_per_launch=1,
                      device="cpu")
    assert explicit.T == 1 and explicit.policy is None
    eng = ContinuousBatchingServer(CFG, batch_size=2, max_seq=64, kv="paged",
                                   device="cpu")
    assert (eng.T, eng.kv.pt, eng.kv.chunk) == (3, 8, 4)
    eng = ContinuousBatchingServer(CFG, batch_size=2, max_seq=64, kv="paged",
                                   kv_page_tokens=16, prefill_chunk=0,
                                   device="cpu")
    assert (eng.T, eng.kv.pt, eng.kv.chunk) == (3, 16, 0)
    # explicit invalid values still reach kv_geometry's validation
    with pytest.raises(ValueError):
        ContinuousBatchingServer(CFG, batch_size=2, max_seq=64, kv="paged",
                                 kv_page_tokens=0, device="cpu")


def test_trainer_and_mover_auto_apply_persisted_policy():
    tune.save_policy(_policy(steps_per_launch=2, dma_threshold_bytes=0))
    tr = Trainer(CFG, ShapeConfig("tiny", 32, 2, "train"), device="cpu")
    assert tr.k == 2 and tr.policy is not None
    out = tr.train(4)
    assert out["steps"] == 4 and out["doorbells"] == 2
    # the trainer's lookup made the policy ambient: the mover's knob
    mover = HybridMover(device="cpu")
    assert mover.threshold == 0
    _, rec = mover.put(np.zeros(4, np.uint8))
    assert rec.mode == "direct"
    assert HybridMover(threshold=64, device="cpu").threshold == 64
    explicit = Trainer(CFG, ShapeConfig("tiny", 32, 2, "train"),
                       steps_per_launch=1, device="cpu")
    assert explicit.k == 1 and explicit.policy is None


def test_owners_keep_defaults_without_a_policy(monkeypatch):
    for disable in (False, True):
        if disable:                       # a policy exists but is disabled
            tune.save_policy(_policy(tokens_per_launch=3, steps_per_launch=2,
                                     kv_page_tokens=8, prefill_chunk=4,
                                     dma_threshold_bytes=0))
            monkeypatch.setenv("REPRO_POLICY_DISABLE", "1")
        srv = Server(CFG, batch_size=2, max_seq=64, device="cpu")
        eng = ContinuousBatchingServer(CFG, batch_size=2, max_seq=64,
                                       kv="paged", device="cpu")
        tr = Trainer(CFG, ShapeConfig("tiny", 32, 2, "train"), device="cpu")
        assert (srv.T, srv.policy, tr.k, tr.policy) == (1, None, 1, None)
        assert (eng.T, eng.kv.pt, eng.kv.chunk) == (1, 16, 0)
        assert HybridMover(device="cpu").threshold == INLINE_THRESHOLD_DEFAULT
        assert tune.active_policy() is None


def _cli(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def test_serve_cli_tokens_per_launch_from_policy_else_4():
    """Unset --tokens-per-launch: the policy's T, else 4 (the reference's
    untuned CLI default).  5 new tokens ring 1 + ceil(4 / T) doorbells."""
    from repro_torch.launch.serve import main
    argv = ["--smoke", "--device", "cpu", "--batch", "2", "--max-seq", "32",
            "--new-tokens", "5"]
    assert "'doorbells': 2," in _cli(main, argv)              # T = 4
    tune.save_policy(_policy(tokens_per_launch=2))
    assert "'doorbells': 3," in _cli(main, argv)              # T = 2
    assert "'doorbells': 5," in _cli(main, argv + ["--tokens-per-launch",
                                                   "1"])


def test_train_cli_steps_per_launch_from_policy_else_4():
    from repro_torch.launch.train import main
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "4",
            "--seq", "32", "--batch", "2"]
    assert "'doorbells': 1," in _cli(main, argv)              # K = 4
    tune.save_policy(_policy(steps_per_launch=2))
    out = _cli(main, argv)
    assert "'doorbells': 2," in out and "policy: gemma-smoke" in out


# -- the measurement workloads -----------------------------------------------

def test_default_knobs_equal_reference():
    names = ("dma", "serve", "train", "kv")
    assert [dataclasses.astuple(k) for k in autotune.default_knobs(names)] \
        == [dataclasses.astuple(k) for k in ref_autotune.default_knobs(names)]
    assert autotune.KNOB_WORKLOADS == ref_autotune.KNOB_WORKLOADS
    assert WorkloadSpec().to_dict() == ref_autotune.WorkloadSpec().to_dict()
    with pytest.raises(KeyError):
        autotune.default_knobs(("nope",))
    with pytest.raises(ValueError, match="unknown workloads"):
        CandidateEvaluator(CFG, workloads=("dma", "nope"), device="cpu")


@pytest.mark.parametrize("workload,mode,assignments", [
    ("dma", "oneshot", ({"dma_threshold_bytes": 0},
                        {"dma_threshold_bytes": 128 * 1024})),
    ("serve", "oneshot", ({"tokens_per_launch": 1},
                          {"tokens_per_launch": 4})),
    ("serve", "continuous", ({"tokens_per_launch": 1},
                             {"tokens_per_launch": 2})),
    ("train", "oneshot", ({"steps_per_launch": 1}, {"steps_per_launch": 2})),
    ("kv", "oneshot", ({"kv_page_tokens": 16, "prefill_chunk": 0},
                       {"kv_page_tokens": 4, "prefill_chunk": 8})),
], ids=["dma", "serve", "serve-continuous", "train", "kv"])
def test_evaluator_counts_equal_reference(workload, mode, assignments):
    """Both packages' CandidateEvaluator, on the same spec and knobs, count
    the same doorbells, tokens and transfer bytes (times are not held)."""
    spec = dict(SPEC, serve_mode=mode)
    ref = ref_autotune.CandidateEvaluator(
        REF_SMOKE[ARCH], spec=ref_autotune.WorkloadSpec(**spec),
        workloads=(workload,))
    port = CandidateEvaluator(CFG, spec=WorkloadSpec(**spec),
                              workloads=(workload,), device="cpu")
    counts = set()
    for knobs in assignments:
        want, got = ref.measure(workload, knobs), port.measure(workload, knobs)
        key = (got.doorbells, got.tokens, got.transfer_bytes)
        assert key == (want.doorbells, want.tokens, want.transfer_bytes)
        assert got.tokens > 0
        counts.add(key)
    # the knob changes what is counted, but for the DMA threshold: a put
    # moves its bytes inline or direct, one transfer event either way
    assert len(counts) == (1 if workload == "dma" else 2)
    score, info = port(assignments[0])
    assert set(info) == {workload} and score == info[workload]["score"]
    assert len(port._cache) == 2       # the second call was cached


def test_tune_end_to_end_writes_policy_a_server_applies(tmp_path):
    policy, result, path = autotune.tune(
        ARCH, smoke=True, rounds=1, workloads=("dma", "serve"),
        policy_dir=str(tmp_path), log=None, device="cpu")
    assert path == str(tmp_path / f"{CFG.name}__cpu__d1.json")
    with open(path) as f:
        saved = json.load(f)
    assert set(saved["knobs"]) == {"dma_threshold_bytes", "tokens_per_launch"}
    assert saved["objective"]["after"] <= saved["objective"]["before"]
    assert len(saved["objective"]["trials"]) == len(result.trials) >= 7
    assert saved["env"]["platform"] == "cpu"
    assert tune.active_policy() == policy
    srv = Server(CFG, batch_size=2, max_seq=64, device="cpu")
    assert srv.policy is None          # the default directory holds none
    tune.save_policy(policy)
    srv = Server(CFG, batch_size=2, max_seq=64, device="cpu")
    assert srv.T == policy.knob("tokens_per_launch")
    assert HybridMover(device="cpu").threshold == \
        policy.knob("dma_threshold_bytes")


@pytest.mark.slow
def test_tune_cli_persists_policy_and_server_applies_it(tmp_path):
    """tune -> policy JSON under $REPRO_POLICY_DIR/torch -> a fresh
    process's Server picks the knob up."""
    # one thread: the smoke models are tiny, and the test workers share
    # the host's cores
    env = dict(os.environ, REPRO_POLICY_DIR=str(tmp_path),
               PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.tune", "--device", "cpu",
         "--arch", ARCH, "--workloads", "dma,serve", "--rounds", "1",
         "--new-tokens", "4", "--max-seq", "32",
         "--cuda-env", "CUDA_MODULE_LOADING=LAZY"],
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "RuntimeWarning" not in out.stderr
    path = tmp_path / "torch" / f"{CFG.name}__cpu__d1.json"
    with open(path) as f:
        pol = json.load(f)
    assert set(pol["knobs"]) == {"dma_threshold_bytes", "tokens_per_launch"}
    assert pol["objective"]["after"] <= pol["objective"]["before"]
    assert pol["objective"]["trials"]
    assert pol["env"]["cuda_env"]["CUDA_MODULE_LOADING"] == "LAZY"
    assert pol["env"]["preset"]["cuda_env"] == "CUDA_MODULE_LOADING=LAZY"
    T = pol["knobs"]["tokens_per_launch"]
    assert f"verify: auto-applied tokens_per_launch={T} " in out.stdout
    check = subprocess.run(
        [sys.executable, "-c", textwrap.dedent("""
            from repro_torch.configs import SMOKE_ARCHS
            from repro_torch.runtime.server import Server
            srv = Server(SMOKE_ARCHS["gemma-2b"], batch_size=2, max_seq=32,
                         device="cpu")
            assert srv.policy is not None
            print("applied", srv.T)
        """)],
        capture_output=True, text=True, timeout=300, env=env)
    assert check.returncode == 0, check.stderr[-3000:]
    assert check.stdout.split() == ["applied", str(T)]


@pytest.mark.cuda
def test_dma_workload_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ev = CandidateEvaluator(CFG, workloads=("dma",), device="cuda")
    inline, direct = (ev.measure("dma", {"dma_threshold_bytes": t})
                      for t in (128 * 1024, 0))
    for m in (inline, direct):
        assert m.tokens == 12 and m.transfer_bytes == 3 * sum(
            WorkloadSpec().dma_sizes)
        assert m.transfer_s > 0


def test_chip_smoke_phase_p_rehearsal(monkeypatch):
    """The CPU path of ``chip_smoke.py``'s phase P at smoke size: the smoke
    config under the full name, the tuner's subprocess without ``--full``
    and on the CPU, the parent's reserved memory and cuBLAS workspaces
    stubbed.  P1 must print a
    line per measured candidate and the verify lines, P2 hold every owner
    to the policy, to explicit values and to the defaults, P3 print both
    serves."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    lines = []
    monkeypatch.setattr(cs, "ARCHS", {ARCH: CFG})
    monkeypatch.setattr(cs, "P_WIDTH", ())
    monkeypatch.setattr(cs, "log", lines.append)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_clearCublasWorkspaces",
                        lambda: None, raising=False)
    monkeypatch.setenv("PYTHONPATH", str(ROOT / "src"))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # as the CLI test
    cs.tuner_path("cpu", torch.device("cpu"))
    trials = [x for x in lines if x.startswith("cpu | P1 ")
              and "objective" in x and "/s" in x]
    measured = {x.split(":")[0] for x in trials}
    assert len(trials) == len(measured) >= 4 + 3 + 2 + 4
    assert any(x.startswith("cpu | P1 verify: auto-applied") for x in lines)
    p2 = [x for x in lines if x.startswith("cpu | P2 ")]
    assert len(p2) == 3 and "3 owners loaded" in p2[0]
    assert "'dma_threshold_bytes': 24576" in p2[2]
    assert sum(x.startswith("cpu | P3 policy_serve_") for x in lines) == 2
    assert tune.active_policy() is None
