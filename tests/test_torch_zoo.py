"""The port's MoE, hybrid and llama3 models against the JAX reference.

qwen2-moe-smoke (routed and shared experts, silu), grok-smoke (gelu experts,
top-2 of 4, GQA), jamba-smoke (one period of 8: attention at 4, Mamba2
elsewhere, MoE every second layer; also at ``n_layers=16``, two groups) and
llama3-smoke (dense, rope theta 5e5) run on the reference's weights
(``init_params(PRNGKey(0))`` carried over by ``params_from_jax``):

- fp32 prefill logits within 1e-4 and 8 greedy tokens equal; bf16 logits of
  a teacher-forced prefill and 8 decode steps within 1e-1 relative L2 (a
  bf16 rounding that flips one top-k choice near a tie moves that token's
  MoE output whole: 7.0e-2 at qwen2-moe-smoke's prefill, 1e-2 to 3e-2
  elsewhere);
- ``loss`` and its metrics within 1e-5 and every gradient leaf within 1e-4
  relative L2 of ``jax.grad`` (fp32, remat on);
- ``Server.serve`` tokens, doorbells and payload bytes at T=1 and T=4 (fp32:
  greedy tokens are the parity target there);
- ``ContinuousBatchingServer`` on ``DenseKV``: tokens, counts and payload
  bytes equal the reference engine's, and the first requests' tokens a
  batch-1 one-shot ``Server``'s;
- MoE on ``PagedKV`` and with chunked prefill: ``bench_kv.py``'s spec gives
  the reference's counts, pages and prefix hits, and paged tokens equal
  dense-chunked ones; the hybrid refuses both, as the reference does;
- every registered config, field for field and by ``param_counts()``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SMOKE_ARCHS as REF_SMOKE
from repro.core.session import TraceSession as RefSession
from repro.models import get_model as ref_get_model
from repro.runtime.server import ContinuousBatchingServer as RefEngine
from repro.runtime.server import Request as RefRequest
from repro.runtime.server import Server as RefServer
from repro.runtime.traffic import TrafficSpec as RefSpec
from repro.runtime.traffic import generate as ref_generate
from repro.runtime.traffic import replay as ref_replay
from repro_torch.configs import ARCHS, SMOKE_ARCHS
from repro_torch.core.session import TraceSession
from repro_torch.launch import serve
from repro_torch.models import HybridLM, TransformerLM, get_model
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.server import (ContinuousBatchingServer, Request,
                                        Server)
from repro_torch.runtime.steps import grads_of
from repro_torch.runtime.traffic import TrafficSpec, generate, replay
from repro_torch.weights import opt_state_from_jax, params_from_jax

ZOO = ["qwen2-moe-a2.7b", "grok-1-314b", "jamba-v0.1-52b", "llama3-405b"]
MOE = ["qwen2-moe-a2.7b", "grok-1-314b"]
# (arch, config overrides): jamba also at two groups
MODELS = [(a, ()) for a in ZOO] + [("jamba-v0.1-52b", (("n_layers", 16),))]
MODEL_IDS = ZOO + ["jamba-v0.1-52b-16L"]
FP32_TOL = 1e-4
BF16_REL_L2 = 1e-1
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
B, S, MAX_SEQ, STEPS = 2, 16, 32, 8
# tests/test_torch_server.py's ragged prompts
PROMPT_LENS = (3, 9, 6, 12)
MAX_NEW = (5, 7, 4, 7)
COUNTS = ("doorbells", "new_tokens", "tokens_per_doorbell", "trace_events")
# benchmarks/bench_loadtest.py's traffic, fewer requests; bench_kv.py's
C_SPEC = dict(n_requests=12, rate=200.0, prompt_lens=(4, 8),
              new_tokens=(5, 9), seed=0)
C_ENGINE = dict(batch_size=4, max_seq=64)
ENGINE_COUNTS = ("requests", "completed", "evicted", "rejected",
                 "new_tokens", "doorbells", "tokens_per_doorbell")
KV_SPEC = dict(n_requests=8, rate=1000.0, prompt_lens=(4, 8),
               new_tokens=(5, 9), seed=0, prefix_len=24)
KV_MODES = {"dense_chunk8": dict(kv="dense", prefill_chunk=8),
            "paged_pt8_chunk8": dict(kv="paged", kv_page_tokens=8,
                                     prefill_chunk=8)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread a worker, as in test_torch_continuous.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def configs(arch, dtype="float32", kw=()):
    kw = dict(kw, param_dtype=dtype)
    return (dataclasses.replace(REF_SMOKE[arch], **kw),
            dataclasses.replace(SMOKE_ARCHS[arch], **kw))


@functools.lru_cache(maxsize=None)
def reference(arch, dtype="float32", kw=()):
    """(reference model, its params, its jitted prefill and decode step,
    the port's config and params on the reference's weights)."""
    ref_cfg, cfg = configs(arch, dtype, kw)
    model = ref_get_model(ref_cfg)
    rp = model.init_params(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, rp), cfg,
                             "cpu")
    return (model, rp, jax.jit(model.prefill, static_argnums=(2,)),
            jax.jit(model.decode_step), cfg, params)


def prompt():
    return np.random.default_rng(5).integers(0, 256, size=(B, S)).astype(
        np.int32)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def argmax(logits):
    return np.asarray(logits, np.float32)[:, -1:].argmax(-1).astype(np.int32)


# -- configs ----------------------------------------------------------------

@pytest.mark.parametrize("arch", list(ARCHS))
def test_registered_configs_are_copies_of_the_reference(arch):
    assert set(ARCHS) == set(SMOKE_ARCHS) and len(ARCHS) == 8
    assert set(ARCHS) < set(REF_ARCHS)
    for mine, theirs in ((ARCHS, REF_ARCHS), (SMOKE_ARCHS, REF_SMOKE)):
        assert dataclasses.asdict(mine[arch]) == dataclasses.asdict(
            theirs[arch])
        assert mine[arch].param_counts() == theirs[arch].param_counts()


def test_get_model_builds_the_families():
    for arch, cls in (("qwen2-moe-a2.7b", TransformerLM),
                      ("grok-1-314b", TransformerLM),
                      ("jamba-v0.1-52b", HybridLM),
                      ("llama3-405b", TransformerLM)):
        assert type(get_model(SMOKE_ARCHS[arch], device="cpu")) is cls
    for family in ("audio", "vlm"):
        cfg = dataclasses.replace(SMOKE_ARCHS["qwen2-moe-a2.7b"],
                                  family=family)
        with pytest.raises(NotImplementedError):
            get_model(cfg, device="cpu")


# -- weights ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-v0.1-52b"])
def test_params_and_opt_state_from_jax(arch):
    """A bf16 model keeps the router (and Mamba's A_log, D, dt_bias) in
    fp32; the AdamW state carries over fp32 leaf for leaf."""
    model, rp, _, _, cfg, params = reference(arch, "bfloat16")
    host = jax.tree_util.tree_map(np.asarray, rp)
    ref_leaves = jax.tree_util.tree_leaves(host)
    mine = tree_leaves(params)
    assert [tuple(t.shape) for t in mine] == [a.shape for a in ref_leaves]
    assert [t.dtype == torch.float32 for t in mine] == [
        a.dtype == np.float32 for a in ref_leaves]
    routers = ([params["layers"]["moe"]["router"]] if "layers" in params
               else [sub["moe"]["router"]
                     for sub in params["groups"].values() if "moe" in sub])
    assert routers and all(r.dtype == torch.float32 for r in routers)
    f32 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), host)
    st = opt_state_from_jax(np.int32(3), f32, f32, f32, cfg, "cpu")
    assert int(st.step) == 3
    for t, a in zip(tree_leaves(st.master), ref_leaves):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), a.astype(np.float32))


# -- prefill and decode -----------------------------------------------------

@pytest.mark.parametrize("impl", ["cuda", "ref"])
@pytest.mark.parametrize("arch,kw", MODELS, ids=MODEL_IDS)
def test_fp32_prefill_and_greedy_tokens_match(arch, kw, impl):
    _, rp, ref_prefill, ref_decode, cfg, params = reference(arch, "float32",
                                                            kw)
    toks = prompt()
    model = get_model(cfg, impl=impl, device="cpu")
    state, logits = model.prefill(params, torch.from_numpy(toks), MAX_SEQ)
    rstate, rlogits = ref_prefill(rp, jnp.asarray(toks), MAX_SEQ)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                               rtol=FP32_TOL, atol=FP32_TOL)
    mine, theirs = [], []
    for _ in range(STEPS):
        nxt, rnxt = argmax(logits.numpy()), argmax(rlogits)
        mine.append(nxt[:, 0].tolist())
        theirs.append(rnxt[:, 0].tolist())
        state, logits = model.decode_step(params, state,
                                          torch.from_numpy(nxt))
        rstate, rlogits = ref_decode(rp, rstate, jnp.asarray(rnxt))
    assert mine == theirs
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                               rtol=FP32_TOL, atol=FP32_TOL)
    want = jax.tree_util.tree_leaves(rstate)
    got = tree_leaves(state)
    assert [tuple(t.shape) for t in got] == [a.shape for a in want]
    for t, a in zip(got, want):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(a, np.float32),
                                   rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("impl", ["cuda", "ref"])
@pytest.mark.parametrize("arch,kw", MODELS, ids=MODEL_IDS)
def test_bf16_teacher_forced_logits_match(arch, kw, impl):
    _, rp, ref_prefill, ref_decode, cfg, params = reference(arch, "bfloat16",
                                                            kw)
    toks = prompt()
    model = get_model(cfg, impl=impl, device="cpu")
    state, logits = model.prefill(params, torch.from_numpy(toks), MAX_SEQ)
    rstate, rlogits = ref_prefill(rp, jnp.asarray(toks), MAX_SEQ)
    assert logits.dtype == torch.bfloat16
    errs = [rel_l2(logits.float().numpy(), np.asarray(rlogits, np.float32))]
    for _ in range(STEPS):
        nxt = argmax(rlogits)                     # the reference's token
        state, logits = model.decode_step(params, state,
                                          torch.from_numpy(nxt))
        rstate, rlogits = ref_decode(rp, rstate, jnp.asarray(nxt))
        errs.append(rel_l2(logits.float().numpy(),
                           np.asarray(rlogits, np.float32)))
    assert max(errs) < BF16_REL_L2, errs


def test_hybrid_prefill_state_is_zero_at_length_s():
    """Kept from the reference: the hybrid's prefill returns a zero KV
    cache and a zero SSM state at length S."""
    _, _, _, _, cfg, params = reference("jamba-v0.1-52b")
    model = get_model(cfg, impl="ref", device="cpu")
    state = model.init_decode_state(B, MAX_SEQ)
    for t in tree_leaves(state):
        t.fill_(1)
    out, _ = model.prefill(params, torch.from_numpy(prompt()), MAX_SEQ,
                           state=state)
    assert out is state and int(state["length"]) == S
    assert all(not t.any() for t in tree_leaves(
        {k: v for k, v in state.items() if k != "length"}))
    assert state["k"].shape == (1, 1, B, MAX_SEQ, cfg.n_kv_heads, cfg.hd)
    assert state["ssm"]["h"].shape[:3] == (1, 7, B)


def test_hybrid_prompt_not_a_multiple_of_the_chunk_raises():
    _, _, _, _, cfg, params = reference("jamba-v0.1-52b")
    model = get_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="ssm chunk"):
        model.prefill(params, torch.zeros(1, 24, dtype=torch.int32), 32)


# -- loss and gradients -----------------------------------------------------

@pytest.mark.parametrize("arch,kw", MODELS, ids=MODEL_IDS)
def test_loss_and_grads_match_jax(arch, kw):
    kw = kw + (("remat", True),)
    model, rp, _, _, cfg, params = reference(arch, "float32", kw)
    toks = np.random.default_rng(9).integers(0, 256, size=(B, 32)).astype(
        np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        model.loss, has_aux=True))(rp, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    loss, metrics, grads = grads_of(
        get_model(cfg, impl="ref", device="cpu"), params,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_TOL)
    assert set(metrics) == set(want_m)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(want_m[k]),
                                   rtol=LOSS_TOL, atol=1e-7)
    if cfg.n_experts:
        assert float(metrics["aux"]) > 0
    ref_leaves = jax.tree_util.tree_leaves_with_path(want_g)
    mine = tree_leaves(grads)
    assert len(mine) == len(ref_leaves)
    for g, (path, r) in zip(mine, ref_leaves):
        assert tuple(g.shape) == r.shape, path
        assert rel_l2(g.numpy(), r) < GRAD_TOL, (path, rel_l2(g.numpy(), r))


# -- one-shot serving -------------------------------------------------------

def dispatches(session):
    return [(e.name, e.payload_bytes)
            for e in session.timeline(kinds="dispatch")]


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("arch", ZOO)
def test_serve_matches_reference(arch, T):
    ref_cfg, cfg = configs(arch)
    ref = RefServer(ref_cfg, batch_size=4, max_seq=MAX_SEQ,
                    tokens_per_launch=T, seed=0)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref.params),
                             cfg, "cpu")
    srv = Server(cfg, batch_size=4, max_seq=MAX_SEQ, tokens_per_launch=T,
                 device="cpu", params=params)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    ref_reqs = [RefRequest(i, p, m)
                for i, (p, m) in enumerate(zip(prompts, MAX_NEW))]
    reqs = [Request(i, p, m) for i, (p, m) in enumerate(zip(prompts, MAX_NEW))]
    want = ref.serve(ref_reqs)
    got = srv.serve(reqs)
    assert [r.tokens for r in reqs] == [r.tokens for r in ref_reqs]
    assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}
    assert got["doorbells"] == 1 + -(-(max(MAX_NEW) - 1) // T)
    assert dispatches(srv.session) == dispatches(ref.session)


# -- continuous batching ----------------------------------------------------

def payload_by_name(session):
    out = {}
    for e in session.timeline(kinds="dispatch"):
        n, b = out.get(e.name, (0, 0))
        out[e.name] = (n + 1, b + e.payload_bytes)
    return out


def tokens(tickets):
    return {t.uid: list(t.tokens) for t in tickets}


@functools.lru_cache(maxsize=None)
def engine_run(which, arch, spec_items, engine_items):
    """One synchronous replay of a traffic spec through the reference's
    engine or the port's, fp32, on the reference's weights (seed 0)."""
    spec, kw = dict(spec_items), dict(engine_items)
    ref_cfg, cfg = configs(arch)
    if which == "ref":
        eng = RefEngine(ref_cfg, seed=0, session=RefSession(name="zoo"), **kw)
        return (eng,) + ref_replay(eng, ref_generate(RefSpec(**spec),
                                                     ref_cfg.vocab_size),
                                   realtime=False)
    eng = ContinuousBatchingServer(cfg, device="cpu",
                                   session=TraceSession(name="zoo"),
                                   params=reference(arch)[5], **kw)
    return (eng,) + replay(eng, generate(TrafficSpec(**spec), cfg.vocab_size),
                           realtime=False)


def both(arch, spec, **kw):
    key = (arch, tuple(sorted(spec.items())), tuple(sorted(kw.items())))
    return engine_run("ref", *key), engine_run("port", *key)


@pytest.mark.parametrize("arch", ZOO)
def test_continuous_dense_matches_reference_and_oneshot(arch):
    (ref, ref_tix, ref_m), (eng, tix, m) = both(arch, C_SPEC, **C_ENGINE,
                                                tokens_per_launch=1)
    assert m["completed"] == C_SPEC["n_requests"]
    assert {k: m[k] for k in ENGINE_COUNTS} == {k: ref_m[k]
                                                for k in ENGINE_COUNTS}
    assert tokens(tix) == tokens(ref_tix)
    assert payload_by_name(eng.session) == payload_by_name(ref.session)
    # the first requests through a batch-1 one-shot server on the same
    # weights
    _, cfg = configs(arch)
    one = Server(cfg, batch_size=1, max_seq=C_ENGINE["max_seq"],
                 tokens_per_launch=1, device="cpu", params=eng.params)
    for t in tix[:4]:
        req = Request(t.uid, np.asarray(t.request.prompt, np.int32),
                      t.request.max_new_tokens)
        one.serve([req])
        assert req.tokens == list(t.tokens)


@pytest.mark.parametrize("mode", list(KV_MODES))
@pytest.mark.parametrize("arch", MOE)
def test_moe_paged_and_chunked_counts_match_reference(arch, mode):
    """bench_kv.py's spec: counts, pages, prefix hits, payload bytes and
    tokens equal the reference's."""
    (ref, ref_tix, ref_m), (eng, tix, m) = both(
        arch, KV_SPEC, batch_size=4, max_seq=64, tokens_per_launch=4,
        **KV_MODES[mode])
    assert m["kv"] == ref_m["kv"]
    assert {k: m[k] for k in ENGINE_COUNTS} == {k: ref_m[k]
                                                for k in ENGINE_COUNTS}
    assert payload_by_name(eng.session) == payload_by_name(ref.session)
    assert tokens(tix) == tokens(ref_tix)
    if mode.startswith("paged"):
        assert m["kv"]["prefix_hits"] == 4
        (_, _, _), (_, dense, _) = both(
            arch, KV_SPEC, batch_size=4, max_seq=64, tokens_per_launch=4,
            **KV_MODES["dense_chunk8"])
        assert tokens(tix) == tokens(dense)


@pytest.mark.parametrize("kw", [dict(kv="paged"), dict(prefill_chunk=4)],
                         ids=["paged", "chunked"])
def test_hybrid_refuses_paged_and_chunked_as_reference(kw):
    ref_cfg, cfg = configs("jamba-v0.1-52b")
    with pytest.raises(ValueError, match="prefill_extend"):
        ContinuousBatchingServer(cfg, batch_size=1, max_seq=32,
                                 device="cpu", **kw)
    with pytest.raises(ValueError, match="prefill_extend"):
        RefEngine(ref_cfg, batch_size=1, max_seq=32, **kw)


# -- the CLIs ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-v0.1-52b"])
def test_serve_cli_smoke_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--new-tokens", "4", "--continuous", "--requests", "3"])
    assert "'completed': 3" in capsys.readouterr().out


@pytest.mark.parametrize("cli,arch", [("train", "qwen2-moe-a2.7b"),
                                      ("train", "jamba-v0.1-52b"),
                                      ("loadtest", "jamba-v0.1-52b"),
                                      ("loadtest", "grok-1-314b"),
                                      ("loadtest paged", "grok-1-314b"),
                                      ("tune", "llama3-405b")])
def test_clis_take_the_new_archs(cli, arch, tmp_path, monkeypatch, capsys):
    """The train, loadtest and tuner CLIs take the new names through
    ``--arch``, with no new flag.  MoE also runs paged and chunked, but is
    not verified against the one-shot there: its capacity follows the
    chunk's length (the reference's verify fails the same way)."""
    from repro_torch.launch import loadtest, train
    from repro_torch.tune.__main__ import main as tune_main
    monkeypatch.setenv("REPRO_POLICY_DIR", str(tmp_path))
    if cli == "train":
        train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                    "4", "--seq", "32", "--batch", "2"])
        assert "'steps': 4," in capsys.readouterr().out
    elif cli == "loadtest":
        assert loadtest.main(["--arch", arch, "--quick", "--device", "cpu",
                              "--verify", "2"]) == 0
        assert "equivalence: OK" in capsys.readouterr().out
    elif cli == "loadtest paged":
        assert loadtest.main(["--arch", arch, "--quick", "--device", "cpu",
                              "--kv", "paged", "--prefill-chunk", "4",
                              "--prefix-len", "8", "--verify", "0"]) == 0
        assert "kv=paged chunk=4" in capsys.readouterr().out
    else:
        tune_main(["--arch", arch, "--device", "cpu", "--workloads",
                   "serve", "--rounds", "1", "--no-verify"])
        assert list((tmp_path / "torch").glob("llama3-smoke__cpu__d1.json"))


# -- chip_smoke -------------------------------------------------------------

def test_chip_smoke_phase_z_rehearsal(monkeypatch):
    """The CPU path of ``chip_smoke.py``'s phase Z at smoke size: smoke
    configs under the full names, short prompts, no path kernels (launch
    counts are 0 on the CPU); what needs the card (CUDA events, profiler
    windows, the graphs' footprints and decoded nodes) is stubbed.  Every
    route agrees, C1 at T=4 gives the reference's 45 doorbells, and K1 the
    reference's BENCH_10 rows with paged tokens equal to dense-chunked."""
    import collections
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from repro_torch.core.graphs import CapturedStep

    lines = []
    short = dict(max_seq=48, kernels=())
    monkeypatch.setattr(cs, "ARCHS", dict(SMOKE_ARCHS))
    for name, lens in (("QWEN_MOE", (3, 5, 9, 12)), ("JAMBA", (5, 9, 12, 16)),
                       ("GROK", (3, 5, 9, 12))):
        monkeypatch.setattr(cs, name, dataclasses.replace(
            getattr(cs, name), prompt_lens=lens, **short))
    monkeypatch.setattr(cs, "ZOO_PATHS", (cs.QWEN_MOE, cs.JAMBA))
    monkeypatch.setattr(cs, "C_KERNELS", {k: () for k in cs.C_KERNELS})
    monkeypatch.setattr(cs, "log", lines.append)
    monkeypatch.setattr(cs, "time_ms", lambda fn, reps=20, warmup=3: (
        fn(), 1.0)[1])
    monkeypatch.setattr(cs, "device_ms", lambda fn, reps=20: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "profile_window",
                        lambda fn, label, top=8, kernels=(): fn())
    monkeypatch.setattr(cs, "_profile", lambda fn, reps=1, warmup=True,
                        label="", retakes=0: (fn(), cs.Window(
                            [], 1.0, collections.Counter()))[1])
    monkeypatch.setattr(cs, "held_to_graph", lambda label, step, c: {})
    monkeypatch.setattr(cs, "held_to_profiler", lambda eng, spec, label,
                        measured=None: (measured, {}))
    monkeypatch.setattr(CapturedStep, "footprint", lambda self: (0, 0))
    counts, engines = cs.zoo_path("cpu", torch.device("cpu"))
    assert set(counts) == {"qwen2-moe-a2.7b", "jamba-v0.1-52b"}
    assert set(engines["qwen2-moe-a2.7b"]) == {"C1", "K1"}
    assert set(engines["jamba-v0.1-52b"]) == {"C1"}
    c1 = [x for x in lines if "spec=bench_loadtest" in x]
    assert len(c1) == 2 and all("doorbells 45," in x for x in c1)
    k1 = [x for x in lines if "spec=K1" in x]
    assert len(k1) == 2 and "(8, 56, 29, 20, 576, 26, 17, 12, 4) (BENCH_10" \
        in k1[1]
    assert any("paged tokens equal dense_chunk8's in 8/8" in x for x in lines)
    assert sum("moe_sorted (C = S" in x for x in lines) == 2
    fp32 = [x for x in lines if "fp32 prefill logits max|err|" in x]
    assert len(fp32) == 3
    assert sum("expert choices held to the kernel route's" in x
               for x in lines) == 7
