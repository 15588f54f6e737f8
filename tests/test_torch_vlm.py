"""The port's llava (vlm family, ``models/vlm.py``) against the JAX reference
on the same inputs.

llava-smoke (2 layers, d 64, GQA 4/2 of 16, 8 patches) runs on the
reference's weights (``init_params(PRNGKey(0))`` carried over by
``params_from_jax``); patch embeddings and tokens are numpy draws from a
seed.  On the CPU the port's kernel route (``impl="cuda"``) takes the flash
and RMSNorm kernels' plain versions.  Tolerances:

- fp32: logits and hidden states within 1e-4, 8 greedy tokens equal, the
  loss within 1e-5 relative and every gradient leaf within 1e-4 relative
  L2 of ``jax.grad``;
- bf16: relative L2 within 2e-2; the reference's own
  ``test_vlm_prefill_decode_continuity`` bound (4e-2, prefill and decode
  against the full forward) on the port;
- text-only serving (``Server``, the continuous engine on ``DenseKV`` and
  ``PagedKV`` with chunked prefill): tokens, counts, doorbells and payload
  bytes equal the reference's (fp32);
- two trainer launches: losses within 1e-4 relative (fp32).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as REF_SMOKE
from repro.configs.shapes import ShapeConfig as RefShape
from repro.core.session import TraceSession as RefSession
from repro.models import get_model as ref_get_model
from repro.runtime.server import ContinuousBatchingServer as RefEngine
from repro.runtime.server import Request as RefRequest
from repro.runtime.server import Server as RefServer
from repro.runtime.steps import make_prefill_step as ref_prefill_step
from repro.runtime.traffic import TrafficSpec as RefSpec
from repro.runtime.traffic import generate as ref_generate
from repro.runtime.traffic import replay as ref_replay
from repro.runtime.trainer import Trainer as RefTrainer
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core.session import TraceSession
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models import TransformerLM, VlmLM, get_model
from repro_torch.models.layers import unembed
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.server import (ContinuousBatchingServer, Request,
                                        Server)
from repro_torch.runtime.steps import (grads_of, make_decode_step,
                                       make_prefill_step)
from repro_torch.runtime.traffic import TrafficSpec, generate, replay
from repro_torch.runtime.trainer import Trainer
from repro_torch.weights import params_from_jax

ARCH = "llava-next-34b"
B, S_TEXT, MAX_SEQ, STEPS = 2, 10, 40, 8
FP32_TOL = 1e-4
BF16_REL_L2 = 2e-2
CONTINUITY_TOL = 4e-2          # tests/test_models.py's bf16 bound
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
TRAIN_TOL = 1e-4
SHAPE = ShapeConfig("tiny", 32, 4, "train")
REF_SHAPE = RefShape("tiny", 32, 4, "train")
# tests/test_torch_server.py's ragged prompts; bench_loadtest's and
# bench_kv's traffic, fewer requests (as tests/test_torch_zoo.py)
PROMPT_LENS = (3, 9, 6, 12)
MAX_NEW = (5, 7, 4, 7)
COUNTS = ("doorbells", "new_tokens", "tokens_per_doorbell", "trace_events")
C_SPEC = dict(n_requests=12, rate=200.0, prompt_lens=(4, 8),
              new_tokens=(5, 9), seed=0)
KV_SPEC = dict(n_requests=8, rate=1000.0, prompt_lens=(4, 8),
               new_tokens=(5, 9), seed=0, prefix_len=24)
ENGINE_COUNTS = ("requests", "completed", "evicted", "rejected",
                 "new_tokens", "doorbells", "tokens_per_doorbell")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread a worker, as in test_torch_continuous.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def configs(dtype="float32", **kw):
    kw = dict(kw, param_dtype=dtype)
    return (dataclasses.replace(REF_SMOKE[ARCH], **kw),
            dataclasses.replace(SMOKE_ARCHS[ARCH], **kw))


@functools.lru_cache(maxsize=None)
def reference(dtype="float32", remat=False):
    """(reference model, its params, the port's config and params on the
    reference's weights)."""
    ref_cfg, cfg = configs(dtype, remat=remat)
    model = ref_get_model(ref_cfg)
    rp = model.init_params(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, rp), cfg,
                             "cpu")
    return model, rp, cfg, params


def inputs(dtype="float32", seed=4):
    """Tokens [B, S_TEXT] and patch embeddings [B, 8, 64] in ``dtype`` (the
    same numpy values on both sides)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, size=(B, S_TEXT)).astype(np.int32)
    patches = rng.standard_normal((B, 8, 64)).astype(np.float32)
    return (toks, torch.from_numpy(patches).to(getattr(torch, dtype)),
            jnp.asarray(patches, getattr(jnp, dtype)))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def close(t, j, tol=FP32_TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


def agree(t, j, dtype):
    if dtype == "float32":
        close(t, j)
    else:
        err = rel_l2(t.float().numpy(), np.asarray(j, np.float32))
        assert err < BF16_REL_L2, err


def argmax(logits):
    return np.asarray(logits, np.float32)[:, -1:].argmax(-1).astype(np.int32)


# -- forward ----------------------------------------------------------------

def test_get_model_builds_vlm_on_the_text_model():
    model = get_model(SMOKE_ARCHS[ARCH], device="cpu")
    assert type(model) is VlmLM and isinstance(model, TransformerLM)
    with pytest.raises(NotImplementedError, match="vlm"):
        TransformerLM(SMOKE_ARCHS[ARCH], device="cpu")
    with pytest.raises(NotImplementedError):
        VlmLM(SMOKE_ARCHS["gemma-2b"], device="cpu")


@pytest.mark.parametrize("impl", ["cuda", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inject_forward_embeds_and_prefill_match(impl, dtype):
    """``_inject`` (patches cast to the text's type, prepended),
    ``_forward_embeds`` and the prefill with patches: logits and the KV
    cache of all ``n_patches + S_text`` positions."""
    model, rp, cfg, params = reference(dtype)
    toks, patches, patches_j = inputs("float32")   # cast by _inject
    mine = get_model(cfg, impl=impl, device="cpu")
    x = mine._inject(params, torch.from_numpy(toks), patches)
    x_j = model._inject(rp, jnp.asarray(toks), patches_j)
    assert x.dtype == getattr(torch, dtype) and x.shape == (B, 8 + S_TEXT, 64)
    close(x, x_j, 0)
    h = mine._forward_embeds(params, x, mode="serve")
    h_j = model._forward_embeds(rp, x_j, mode="eval")
    agree(h, h_j, dtype)
    state, logits = mine.prefill(params, torch.from_numpy(toks), MAX_SEQ,
                                 patch_embeds=patches)
    rstate, rlogits = model.prefill(rp, jnp.asarray(toks), MAX_SEQ,
                                    patch_embeds=patches_j)
    agree(logits, rlogits, dtype)
    assert int(state["length"]) == int(rstate["length"]) == 8 + S_TEXT
    for t, a in zip(tree_leaves(state), jax.tree_util.tree_leaves(rstate)):
        assert tuple(t.shape) == a.shape
        agree(t, a, dtype)


def test_text_prefill_is_the_text_models():
    _, rp, cfg, params = reference()
    toks, _, _ = inputs()
    mine = get_model(cfg, device="cpu")
    text = TransformerLM.prefill(mine, params, torch.from_numpy(toks),
                                 MAX_SEQ)
    state = mine.init_decode_state(B, MAX_SEQ)
    got = mine.prefill(params, torch.from_numpy(toks), MAX_SEQ, state=state)
    assert got[0] is state and torch.equal(got[1], text[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_continuity(dtype):
    """The reference's ``test_vlm_prefill_decode_continuity`` case on the
    port, with its inputs (``PRNGKey(0)`` draws: 10 tokens, bf16 patches):
    a prefill of the patches and the first 6 tokens, then decode steps over
    the rest, each against the full forward's logits at its position (bf16:
    the reference's 4e-2; fp32: 1e-4), and every step's logits against the
    reference's."""
    model, rp, cfg, params = reference(dtype)
    key = jax.random.PRNGKey(0)
    toks = np.asarray(jax.random.randint(key, (1, S_TEXT), 0, cfg.vocab_size),
                      np.int32)
    patches_j = jax.random.normal(key, (1, cfg.n_patches, cfg.d_model),
                                  jnp.bfloat16).astype(getattr(jnp, dtype))
    patches = torch.from_numpy(np.asarray(patches_j, np.float32)).to(
        getattr(torch, dtype))
    mine = get_model(cfg, device="cpu")
    full = unembed(params["emb"], mine._forward_embeds(
        params, mine._inject(params, torch.from_numpy(toks), patches),
        mode="serve"))
    tol = FP32_TOL if dtype == "float32" else CONTINUITY_TOL
    state, lg = mine.prefill(params, torch.from_numpy(toks[:, :6]), 64,
                             patch_embeds=patches)
    rstate, rlg = model.prefill(rp, jnp.asarray(toks[:, :6]), 64,
                                patch_embeds=patches_j)
    close(lg[0, -1], full[0, cfg.n_patches + 5].float(), tol)
    agree(lg, rlg, dtype)
    dec = jax.jit(model.decode_step)
    for t in range(6, S_TEXT):
        state, lg = mine.decode_step(params, state,
                                     torch.from_numpy(toks[:, t:t + 1]))
        rstate, rlg = dec(rp, rstate, jnp.asarray(toks[:, t:t + 1]))
        close(lg[0, 0], full[0, cfg.n_patches + t].float(), tol)
        agree(lg, rlg, dtype)


def test_greedy_tokens_after_an_image_prompt():
    """fp32: 8 greedy tokens after a prefill with patches equal the
    reference's; the last logits within 1e-4."""
    model, rp, cfg, params = reference()
    toks, patches, patches_j = inputs()
    mine = get_model(cfg, impl="cuda", device="cpu")
    state, logits = mine.prefill(params, torch.from_numpy(toks), MAX_SEQ,
                                 patch_embeds=patches)
    rstate, rlogits = model.prefill(rp, jnp.asarray(toks), MAX_SEQ,
                                    patch_embeds=patches_j)
    dec = jax.jit(model.decode_step)
    mine_t, theirs = [], []
    for _ in range(STEPS):
        nxt, rnxt = argmax(logits.numpy()), argmax(rlogits)
        mine_t.append(nxt[:, 0].tolist())
        theirs.append(rnxt[:, 0].tolist())
        state, logits = mine.decode_step(params, state, torch.from_numpy(nxt))
        rstate, rlogits = dec(rp, rstate, jnp.asarray(rnxt))
    assert mine_t == theirs
    close(logits, rlogits)


# -- loss and gradients -----------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    """The loss over the text positions only, its metrics, and every
    gradient leaf, against ``jax.grad`` of the reference's loss (fp32)."""
    model, rp, cfg, params = reference(remat=remat)
    b = SyntheticTokens(cfg, SHAPE, seed=0).batch_at(0)
    assert b["patch_embeds"].shape == (4, 8, 64)
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        model.loss, has_aux=True))(rp, {k: jnp.asarray(v)
                                        for k, v in b.items()})
    loss, metrics, grads = grads_of(
        get_model(cfg, impl="ref", device="cpu"), params,
        {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_TOL)
    assert set(metrics) == set(want_m) == {"ce"}
    ref_leaves = jax.tree_util.tree_leaves_with_path(want_g)
    mine = tree_leaves(grads)
    assert len(mine) == len(ref_leaves)
    for g, (path, r) in zip(mine, ref_leaves):
        assert tuple(g.shape) == r.shape, path
        assert rel_l2(g.numpy(), r) < GRAD_TOL, (path, rel_l2(g.numpy(), r))


def test_bf16_loss_on_fp32_patches():
    """The pipeline's fp32 patches are cast to the text's type, as the
    reference's ``_inject`` does: bf16 losses within 2e-2 relative."""
    model, rp, cfg, params = reference("bfloat16")
    b = SyntheticTokens(cfg, SHAPE, seed=0).batch_at(1)
    want, _ = model.loss(rp, {k: jnp.asarray(v) for k, v in b.items()})
    loss, _, _ = grads_of(get_model(cfg, impl="ref", device="cpu"), params,
                          {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(loss), float(want), rtol=BF16_REL_L2)


# -- steps ------------------------------------------------------------------

def test_make_prefill_step_takes_the_image_prompt():
    """The vlm batch (tokens, patch_embeds) through ``make_prefill_step``
    equals the model's prefill with patches, and the reference's step."""
    model, rp, cfg, params = reference()
    toks, patches, patches_j = inputs()
    mine = get_model(cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(toks), "patch_embeds": patches}
    state = mine.init_decode_state(B, MAX_SEQ)
    got_s, got = make_prefill_step(mine, cfg, MAX_SEQ)(params, batch,
                                                       state=state)
    _, want = mine.prefill(params, batch["tokens"], MAX_SEQ,
                           patch_embeds=patches)
    assert got_s is state and torch.equal(got, want)
    _, rl = ref_prefill_step(model, cfg, MAX_SEQ)(
        rp, {"tokens": jnp.asarray(toks), "patch_embeds": patches_j})
    close(got, rl)
    nxt = torch.from_numpy(argmax(got.numpy()))
    _, a = make_decode_step(mine, cfg)(params, got_s, nxt)
    assert a.shape == (B, 1, cfg.vocab_padded)


# -- text-only serving ------------------------------------------------------

def dispatches(session):
    return [(e.name, e.payload_bytes)
            for e in session.timeline(kinds="dispatch")]


@pytest.mark.parametrize("T", [1, 4])
def test_text_serve_matches_reference(T):
    """``Server.serve`` of llava-smoke on token prompts: tokens, counts,
    doorbells and their payload bytes equal the reference ``Server``'s."""
    ref_cfg, cfg = configs()
    ref = RefServer(ref_cfg, batch_size=4, max_seq=32, tokens_per_launch=T,
                    seed=0)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref.params),
                             cfg, "cpu")
    srv = Server(cfg, batch_size=4, max_seq=32, tokens_per_launch=T,
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


def payload_by_name(session):
    out = {}
    for e in session.timeline(kinds="dispatch"):
        n, b = out.get(e.name, (0, 0))
        out[e.name] = (n + 1, b + e.payload_bytes)
    return out


@pytest.mark.parametrize("spec,kw", [
    (C_SPEC, dict(batch_size=4, max_seq=64, tokens_per_launch=1)),
    (KV_SPEC, dict(batch_size=4, max_seq=64, tokens_per_launch=4, kv="paged",
                   kv_page_tokens=8, prefill_chunk=8))],
    ids=["dense", "paged_pt8_chunk8"])
def test_text_engine_matches_reference(spec, kw):
    """The continuous engine serves llava text-only on ``DenseKV`` and on
    ``PagedKV`` with chunked prefill (``prefill_extend``): counts, pages,
    payload bytes and tokens equal the reference engine's."""
    ref_cfg, cfg = configs()
    ref = RefEngine(ref_cfg, seed=0, session=RefSession(name="vlm"), **kw)
    ref_tix, ref_m = ref_replay(ref, ref_generate(RefSpec(**spec),
                                                  ref_cfg.vocab_size),
                                realtime=False)
    eng = ContinuousBatchingServer(cfg, device="cpu",
                                   session=TraceSession(name="vlm"),
                                   params=reference()[3], **kw)
    tix, m = replay(eng, generate(TrafficSpec(**spec), cfg.vocab_size),
                    realtime=False)
    assert m["completed"] == spec["n_requests"]
    assert {k: m[k] for k in ENGINE_COUNTS} == {k: ref_m[k]
                                                for k in ENGINE_COUNTS}
    assert m.get("kv") == ref_m.get("kv")
    assert payload_by_name(eng.session) == payload_by_name(ref.session)
    assert ({t.uid: list(t.tokens) for t in tix}
            == {t.uid: list(t.tokens) for t in ref_tix})


# -- training ---------------------------------------------------------------

def test_trainer_matches_reference():
    """Two fp32 launches of llava-smoke from the reference trainer's
    weights: the fixed buffers hold the fp32 patch embeddings and the [B,
    S - 8] tokens and labels, every loss within 1e-4 relative, and the
    doorbells' names and payload bytes equal the reference's."""
    ref_cfg, cfg = configs()
    ref = RefTrainer(ref_cfg, REF_SHAPE, seed=3, peak_lr=1e-3)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref.params),
                             cfg, "cpu")
    mine = Trainer(cfg, SHAPE, seed=3, peak_lr=1e-3, device="cpu",
                   params=params)
    assert {k: (tuple(t.shape), t.dtype) for k, t in mine._batch.items()} == {
        "patch_embeds": ((4, 8, 64), torch.float32),
        "tokens": ((4, 24), torch.int32), "labels": ((4, 24), torch.int32)}
    want = ref.train(2)
    got = mine.train(2)
    np.testing.assert_allclose([m["loss"] for m in mine.metrics_log],
                               [m["loss"] for m in ref.metrics_log],
                               rtol=TRAIN_TOL)
    for key in ("steps", "doorbells", "steps_per_doorbell"):
        assert got[key] == want[key], key
    assert dispatches(mine.session) == dispatches(ref.session)


# -- chip_smoke.py phase W, rehearsed at smoke size -------------------------

def test_chip_smoke_phase_w_rehearsal(monkeypatch):
    """Phase W's control flow on the CPU at smoke size: whisper-smoke's
    prefill and decode steps (graph replays on the card, direct calls here)
    with their doorbells, the eager control, phase 6 in bf16 and fp32;
    llava-smoke's text path through phases 4-7 and its image prompt.  The
    profiler, the timers and the graph decoder are stubbed; launch counts
    are 0 on the CPU, so the expected launches are emptied too."""
    import collections
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from repro_torch.core.graphs import CapturedStep

    lines = []
    monkeypatch.setattr(cs, "ARCHS", dict(SMOKE_ARCHS))
    monkeypatch.setattr(cs, "W_SHAPE", ShapeConfig("prefill", 32, 2,
                                                   "prefill"))
    monkeypatch.setattr(cs, "W_MAX_SEQ", 48)
    monkeypatch.setattr(cs, "W_DECODE", 4)
    monkeypatch.setattr(cs, "W_IMAGE_TEXT", 8)
    monkeypatch.setattr(cs, "W_IMAGE_MAX_SEQ", 40)
    monkeypatch.setattr(cs, "LLAVA", dataclasses.replace(
        cs.LLAVA, prompt_lens=(3, 5, 9, 12), max_seq=48, kernels=(),
        n_layers=None))
    monkeypatch.setattr(cs, "step_launches", lambda cfg: ({}, {}))
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
    monkeypatch.setattr(CapturedStep, "footprint", lambda self: (0, 0))
    counts, steps = cs.w_path("cpu", torch.device("cpu"))
    assert set(counts) == {"llava-next-34b"}
    assert set(steps) == {"whisper-medium", "llava-next-34b image"}
    for label, B in (("whisper-medium", 2), ("llava-next-34b image", 4)):
        assert any(x.startswith(f"{label}: 5 doorbells") for x in lines)
        assert any(x.startswith(f"{label}: {B} x 5 tokens equal the eager")
                   for x in lines)
    assert steps["whisper-medium"]["bf16_rel_l2"] < cs.W_BF16_REL_TOL
    assert steps["whisper-medium"]["fp32_max_err"] < cs.W_FP32_ABS_TOL
    assert sum("fp32 prefill logits max|err|" in x for x in lines) == 2
    assert any("phase W2: llava-smoke image prompt" in x for x in lines)


def test_chip_smoke_step_launches_count_the_kernels():
    """The launches phase W expects of whisper-medium's prefill and decode
    step (72 flash and 122 RMSNorm; 73 RMSNorm) and of llava's on 8
    layers."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from repro_torch.configs import ARCHS
    assert cs.step_launches(ARCHS["whisper-medium"]) == (
        {"flash_attention": 72, "rms_norm": 122}, {"rms_norm": 73})
    assert cs.step_launches(cs.LLAVA.cfg) == (
        {"flash_attention": 8, "rms_norm": 17}, {"rms_norm": 17})
