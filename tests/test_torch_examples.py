"""The port's four examples (``examples/*_torch.py``) on the CPU, against the
reference's (``examples/*.py``) where the counts do not depend on the
device: steps and doorbells, tokens, transfer protocols, merged shards,
span profiles.

Each example runs in a subprocess with ``--device cpu``; the reference's
run beside them under ``JAX_PLATFORMS=cpu``.  A module fixture starts every
process at once (the two train_lm runs one after the other), so the file
takes about as long as its slowest example.  One in-process test holds
serve_lm's tokens to the reference ``Server``'s in fp32, on weights carried
across by ``weights.params_from_jax``.
"""
import dataclasses
import importlib.util
import os
import re
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest

from repro.configs import SMOKE_ARCHS as REF_SMOKE
from repro.runtime.server import Request as RefRequest
from repro.runtime.server import Server as RefServer

from repro_torch.runtime.server import Request, Server
from repro_torch.weights import params_from_jax

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
EXAMPLES = os.path.join(ROOT, "examples")
TIMEOUT = 600
#: small train_lm flags: two launches of two steps, one checkpoint at
#: the end (each holds the 102M params' fp32 master and moments)
TRAIN_FLAGS = ["--steps", "4", "--seq", "32", "--batch", "2",
               "--steps-per-launch", "2", "--ckpt-every", "4"]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env(jax_side):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    if jax_side:
        env["JAX_PLATFORMS"] = "cpu"
    return env


def _start(script, args=(), jax_side=False):
    return subprocess.Popen(
        [sys.executable, os.path.join(EXAMPLES, script), *args],
        env=_env(jax_side), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _finish(proc):
    out, _ = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 0, out[-3000:]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every example's output, by name; all started at once."""
    ckpt = str(tmp_path_factory.mktemp("train_lm_ckpt"))
    procs = {
        "quickstart": _start("quickstart_torch.py", ["--device", "cpu"]),
        "serve_lm": _start("serve_lm_torch.py", ["--device", "cpu"]),
        "tour": _start("command_stream_tour_torch.py", ["--device", "cpu"]),
        "ref_quickstart": _start("quickstart.py", jax_side=True),
        "ref_serve_lm": _start("serve_lm.py", jax_side=True),
        "ref_tour": _start("command_stream_tour.py", jax_side=True),
    }
    train = {}

    def train_twice():
        args = TRAIN_FLAGS + ["--device", "cpu", "--ckpt-dir", ckpt]
        try:
            train["first"] = _finish(_start("train_lm_torch.py", args))
            args[1] = "6"           # on from the restored step 4
            train["second"] = _finish(_start("train_lm_torch.py", args))
        except BaseException as e:  # raised in the test that reads it
            train["error"] = e

    thread = threading.Thread(target=train_twice)
    thread.start()
    out = {name: _finish(p) for name, p in procs.items()}
    thread.join(TIMEOUT)
    if "error" in train:
        raise train["error"]
    out.update(train_lm=train["first"], train_lm_again=train["second"])
    return out


def _one(pattern, text):
    found = re.findall(pattern, text, re.M)
    assert len(found) == 1, (pattern, text[-2000:])
    return found[0]


def test_quickstart_steps_and_doorbells(runs):
    pat = (r"^trained (\d+) steps in [\d.]+s, (\d+) doorbells "
           r"\((\d+) steps/doorbell\), final loss ([-\d.naif]+)$")
    got = _one(pat, runs["quickstart"])
    assert got[:3] == _one(pat, runs["ref_quickstart"])[:3] == ("4", "2", "2")
    assert np.isfinite(float(got[3]))
    for text in (runs["quickstart"], runs["ref_quickstart"]):
        assert "Submission captured: train_step" in text
    # compile, two dispatches and their progress fences, and the bytes the
    # trainer staged: the reference's session
    head = r"^events=(\d+) dropped=0 payload=(\d+)B"
    assert (_one(head, runs["quickstart"])
            == _one(head, runs["ref_quickstart"]))
    roof = r"^roofline: compute=[\d.]+us memory=[\d.]+us collective=0.0us"
    _one(roof, runs["quickstart"])


def test_serve_lm_doorbells_and_tokens(runs):
    pat = (r"^tokens_per_launch=(\d+): (\d+) tokens, (\d+) doorbells "
           r"\(([\d.]+) tok/doorbell\)")
    got = re.findall(pat, runs["serve_lm"], re.M)
    assert got == re.findall(pat, runs["ref_serve_lm"], re.M)
    assert got == [("1", "48", "12", "4.0"), ("4", "48", "4", "12.0")]
    assert "head_dim=64 (smoke: 32)" in runs["serve_lm"]


def test_train_lm_params_doorbells_and_restore(runs):
    ref_train_lm = _example("train_lm")
    port_train_lm = _example("train_lm_torch")
    for arch in ("qwen3-8b", "deepseek-7b"):
        want = ref_train_lm.hundred_m_variant(arch).param_counts()
        assert port_train_lm.hundred_m_variant(arch).param_counts() == want
    total, active = ref_train_lm.hundred_m_variant("qwen3-8b").param_counts()
    line = (f"training qwen3-8b-100m variant: {total/1e6:.0f}M params "
            f"({active/1e6:.0f}M active)")
    first, again = runs["train_lm"], runs["train_lm_again"]
    assert line in first and line in again
    assert "restored" not in first
    pat = r"^steps=(\d+) wall=[\d.]+s doorbells=(\d+) loss ([\d.]+) -> ([\d.]+)$"
    assert _one(pat, first)[:2] == ("4", "2")
    assert _one(r"^restored from checkpoint at step (\d+)$", again) == "4"
    # one launch of two steps on from step 4
    assert _one(pat, again)[:2] == ("6", "1")
    assert "submission report: {'total_doorbells': 2" in first


def _tour_parts(text):
    return dict(re.findall(r"^(\d)\. (.*)$", text, re.M))


def test_tour_parts_equal_the_reference(runs):
    got, want = runs["tour"], runs["ref_tour"]
    assert _tour_parts(got) == _tour_parts(want)
    # 1: the serve step's submission
    assert "Submission captured: serve_step" in got
    assert "Command-stream entries:" in got
    # 2: the five sizes' protocols at the 24 KiB switch
    proto = r"^\s+(\d+) B -> (inline|direct) "
    assert re.findall(proto, got, re.M) == re.findall(proto, want, re.M)
    assert [m for _, m in re.findall(proto, got, re.M)] == [
        "inline"] * 3 + ["direct"] * 2
    counts = r"^  protocol counts: (.*) \(threshold"
    assert _one(counts, got) == _one(counts, want)
    # 3: needs the card
    assert "needs the card" in got
    # 4: the timeline holds the capture and the transfers, with the
    # reference's payload (the reference's also holds part 3's launches)
    kinds = r"^compile=(\d+)"
    assert _one(kinds, got) == "1"
    transfers = r"transfer=(\d+)"
    assert (re.findall(transfers, got.split("4. The unified")[1])[:1]
            == re.findall(transfers, want.split("4. The unified")[1])[:1]
            == ["5"])
    pay = r"^events=\d+ dropped=0 payload=(\d+)B"
    assert (re.findall(pay, got, re.M)[:1] == re.findall(pay, want, re.M)[:1])
    # 5: two processes merged, aligned by the barrier
    merged = r"^==== AGGREGATED TIMELINE \((\d+) shards, (\d+) events\) ===="
    assert _one(merged, got) == _one(merged, want) == ("2", "10")
    via = r"^  shard \S+/p(\d): offset=[-+\d.]+ ms via (\w+)$"
    assert re.findall(via, got, re.M) == re.findall(via, want, re.M) == [
        ("0", "reference"), ("1", "barrier")]
    # 6: the span profile, the Perfetto export and the store
    for pat in (r"^  request: doorbells/span p50=([\d.]+) ",
                r"^  Perfetto export: (\d+) trace events, (\d+) span slices",
                r"^  stored (\d+) metrics as run "):
        assert _one(pat, got) == _one(pat, want)


@pytest.mark.parametrize("T", [1, 4])
def test_serve_lm_tokens_equal_the_reference_in_fp32(T):
    """serve_lm's config and requests in fp32, the reference's weights
    carried over: the port's tokens are the reference ``Server``'s."""
    cfg = dataclasses.replace(_example("serve_lm_torch").config(),
                              param_dtype="float32")
    ref_cfg = dataclasses.replace(REF_SMOKE["qwen3-8b"], head_dim=cfg.hd,
                                  param_dtype="float32")
    ref = RefServer(ref_cfg, batch_size=4, max_seq=64, tokens_per_launch=T,
                    seed=0)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref.params),
                             cfg, "cpu")
    srv = Server(cfg, batch_size=4, max_seq=64, tokens_per_launch=T,
                 device="cpu", params=params)

    def prompts():
        rng = np.random.default_rng(0)
        return [rng.integers(0, cfg.vocab_size, size=6).astype(np.int32)
                for _ in range(4)]

    ref_reqs = [RefRequest(i, p, 12) for i, p in enumerate(prompts())]
    reqs = [Request(i, p, 12) for i, p in enumerate(prompts())]
    want = ref.serve(ref_reqs)
    got = srv.serve(reqs)
    assert [r.tokens for r in reqs] == [r.tokens for r in ref_reqs]
    assert (got["new_tokens"], got["doorbells"]) == (
        want["new_tokens"], want["doorbells"])


def test_chip_smoke_phase_e_rehearsal(runs, monkeypatch):
    """Phase E's checks (``chip_smoke.check_examples``) on this file's CPU
    runs, with the reference's part-3 lines (the CPU has no graph to read
    a footprint from) and the CPU's train_lm flags; a wrong count fails,
    and so does (the card's check) a loss that does not fall or a restored
    run that starts afresh."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "E_TRAIN", TRAIN_FLAGS)
    monkeypatch.setattr(chip_smoke, "E_TRAIN_AGAIN", 6)
    part3 = "\n".join(line for line in runs["ref_tour"].splitlines()
                      if line.startswith("  K="))
    out = {"quickstart_torch.py": runs["quickstart"],
           "serve_lm_torch.py": runs["serve_lm"],
           "command_stream_tour_torch.py": runs["tour"] + "\n" + part3,
           "train_lm first": runs["train_lm"],
           "train_lm_torch.py": runs["train_lm_again"]}
    chip_smoke.check_examples("cpu", out, learned=False)
    for name, old, new in (
            ("serve_lm_torch.py", "12 doorbells", "13 doorbells"),
            ("command_stream_tour_torch.py", "per_op     doorbells=  10",
             "per_op     doorbells=   1"),
            ("command_stream_tour_torch.py", "(2 shards", "(1 shards"),
            ("train_lm_torch.py", "at step 4", "at step 2")):
        bad = dict(out, **{name: out[name].replace(old, new)})
        assert bad[name] != out[name], (name, old)
        with pytest.raises(AssertionError, match="^E "):
            chip_smoke.check_examples("cpu", bad, learned=False)
    # on the card the loss must fall and the restored run resume from it:
    # a second run that starts again near the first run's first loss (its
    # weights drawn afresh) fails

    def losses(first, again):
        def put(text, pair):
            return re.sub(r"loss \S+ -> \S+$", "loss %s -> %s" % pair, text,
                          flags=re.M)
        return dict(out, **{"train_lm first": put(out["train_lm first"],
                                                  first),
                            "train_lm_torch.py": put(
                                out["train_lm_torch.py"], again)})
    chip_smoke.check_examples("cpu", losses(("10.867", "10.398"),
                                            ("10.274", "10.334")))
    for first, again in ((("10.867", "10.398"), ("10.861", "10.402")),
                         (("10.867", "10.912"), ("10.905", "10.899"))):
        with pytest.raises(AssertionError, match="^E train_lm"):
            chip_smoke.check_examples("cpu", losses(first, again))
