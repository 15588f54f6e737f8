"""The port's whisper (audio family, ``models/encdec.py``) against the JAX
reference on the same inputs.

whisper-smoke (2 encoder and 2 decoder layers, d 64, 4 heads of 16) runs on
the reference's weights (``init_params(PRNGKey(0))`` carried over by
``params_from_jax``); inputs are numpy draws from a seed.  On the CPU the
port's kernel route (``impl="cuda"``) takes the flash and RMSNorm kernels'
plain versions.  Tolerances:

- fp32: logits, encoder and decoder states within 1e-4 (absolute and
  relative); 8 greedy tokens equal; loss within 1e-5 relative and every
  gradient leaf within 1e-4 relative L2 of ``jax.grad``;
- bf16: relative L2 within 2e-2 (a few bf16 roundings, 2^-8, per layer;
  the kernel route's flash keeps fp32 probabilities where the reference's
  dense route rounds them to bf16);
- the losses of two trainer launches within 1e-4 relative (fp32), as in
  ``tests/test_torch_train.py``.

Also: ``sinusoidal_positions``, ``attention(kv_override=...)`` on both
routes, ``decode_step`` from the reference's zero-cache prefill and from a
seeded non-zero state (the only check of the decode's cross-attention
arithmetic, since the prefill leaves the cross KV at zero), the bf16
encoder on fp32 frames (mixed-type promotion), ``params_from_jax``,
``make_prefill_step`` / ``make_decode_step``, ``make_input_specs`` for
every (arch, shape), and ``Server.serve`` refusing the family in both
packages.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import SMOKE_ARCHS as REF_SMOKE
from repro.configs.shapes import ShapeConfig as RefShape
from repro.models import get_model as ref_get_model
from repro.models.attention import attention as ref_attention
from repro.models.attention import init_attention as ref_init_attention
from repro.models.layers import sinusoidal_positions as ref_sinusoidal
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.runtime.server import Request as RefRequest
from repro.runtime.server import Server as RefServer
from repro.runtime.steps import make_input_specs as ref_input_specs
from repro.runtime.trainer import Trainer as RefTrainer
from repro_torch.configs import ARCHS, SHAPES, SMOKE_ARCHS
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models import EncDecLM, get_model
from repro_torch.models.attention import attention
from repro_torch.models.encdec import CROSS_LEN
from repro_torch.models.layers import sinusoidal_positions
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.server import Request, Server
from repro_torch.runtime.steps import (grads_of, make_decode_step,
                                       make_input_specs, make_prefill_step)
from repro_torch.runtime.trainer import Trainer
from repro_torch.weights import opt_state_from_jax, params_from_jax

ARCH = "whisper-medium"
B, S_ENC, S_DEC, MAX_SEQ, STEPS = 2, 32, 8, 24, 8
FP32_TOL = 1e-4
BF16_REL_L2 = 2e-2
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
TRAIN_TOL = 1e-4
SHAPE = ShapeConfig("tiny", 32, 4, "train")
REF_SHAPE = RefShape("tiny", 32, 4, "train")


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


def inputs(dtype="float32", seed=5):
    """Frames [B, S_ENC, D] in ``dtype`` (numpy fp32 values, rounded alike
    on both sides) and decoder tokens [B, S_DEC]."""
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, S_ENC, 64)).astype(np.float32)
    toks = rng.integers(0, 256, size=(B, S_DEC)).astype(np.int32)
    return (torch.from_numpy(frames).to(getattr(torch, dtype)),
            jnp.asarray(frames, getattr(jnp, dtype)), toks)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def close(t, j, tol=FP32_TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


def argmax(logits):
    return np.asarray(logits, np.float32)[:, -1:].argmax(-1).astype(np.int32)


# -- layers -----------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(32, 64), (1500, 1024), (7, 10)])
def test_sinusoidal_positions_match_reference(n, d):
    got = sinusoidal_positions(n, d)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    # sin and cos of fp32 angles up to n, whose frequencies may differ in
    # their last bit: two fp32 ulps of the largest angle
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_sinusoidal(n, d)),
                               rtol=0, atol=2 * n * 2.0 ** -23)


@pytest.mark.parametrize("impl", ["cuda", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("extra", [(), (("qk_norm", True),
                                        ("pos_embed", "rope"))],
                         ids=["learned", "qk_norm_rope"])
def test_attention_kv_override_matches_reference(impl, dtype, extra):
    """Cross-attention: queries of 8 positions against 20 external K/V
    (GQA 4/2); neither the k-norm nor RoPE touches the override, and the
    port returns it as given."""
    ref_cfg, cfg = configs(dtype, n_kv_heads=2, **dict(extra))
    rp = ref_init_attention(jax.random.PRNGKey(1), ref_cfg,
                            getattr(jnp, dtype))
    if cfg.qk_norm:     # non-zero norm scales, so that a k-norm would show
        rp = dict(rp, q_norm={"scale": jnp.full((16,), 0.5, rp["wq"].dtype)},
                  k_norm={"scale": jnp.full((16,), 0.5, rp["wq"].dtype)})
    p = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
            getattr(torch, dtype)), rp)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 8, 64)).astype(np.float32)
    kv = [rng.standard_normal((B, 20, 2, 16)).astype(np.float32)
          for _ in range(2)]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in [x] + kv]
    jj = [jnp.asarray(a, getattr(jnp, dtype)) for a in [x] + kv]
    want = ref_attention(rp, ref_cfg, jj[0], causal=False,
                         kv_override=(jj[1], jj[2]))
    out, k, v = attention(p, cfg, tt[0], causal=False, impl=impl,
                          kv_override=(tt[1], tt[2]))
    assert k is tt[1] and v is tt[2]
    assert out.dtype == tt[0].dtype and out.shape == (B, 8, 64)
    if dtype == "float32":
        close(out, want)
    else:
        assert rel_l2(out.float().numpy(),
                      np.asarray(want, np.float32)) < BF16_REL_L2


def test_attention_kv_override_promotes_mixed_types():
    """bf16 queries against fp32 K/V (the reference's decoder meeting an
    fp32 encoder output) are computed in fp32 and give fp32, as ``jnp``
    promotes them."""
    ref_cfg, cfg = configs("bfloat16")
    rp = ref_init_attention(jax.random.PRNGKey(1), ref_cfg, jnp.bfloat16)
    p = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16(), rp)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 8, 64)).astype(np.float32)
    kv = [rng.standard_normal((B, 20, 4, 16)).astype(np.float32)
          for _ in range(2)]
    want = ref_attention(rp, ref_cfg, jnp.asarray(x, jnp.bfloat16),
                         causal=False,
                         kv_override=tuple(jnp.asarray(a) for a in kv))
    assert want.dtype == jnp.float32
    for impl in ("ref", "cuda"):
        out, _, _ = attention(p, cfg, torch.from_numpy(x).bfloat16(),
                              causal=False, impl=impl,
                              kv_override=tuple(torch.from_numpy(a)
                                                for a in kv))
        assert out.dtype == torch.float32
        assert rel_l2(out.numpy(), np.asarray(want)) < BF16_REL_L2


# -- forward ----------------------------------------------------------------

@pytest.mark.parametrize("impl", ["cuda", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_decode_train_and_prefill_match(impl, dtype):
    model, rp, cfg, params = reference(dtype)
    frames, frames_j, toks = inputs(dtype)
    mine = get_model(cfg, impl=impl, device="cpu")
    enc_j = model.encode(rp, frames_j, mode="eval")
    enc = mine.encode(params, frames)
    x_j = model.decode_train(rp, jnp.asarray(toks), enc_j, mode="eval")
    x = mine.decode_train(params, torch.from_numpy(toks), enc)
    state, logits = mine.prefill(params, frames, torch.from_numpy(toks),
                                 MAX_SEQ)
    rstate, rlogits = model.prefill(rp, frames_j, jnp.asarray(toks), MAX_SEQ)
    assert enc.dtype == frames.dtype and logits.shape == (B, 1, 256)
    pairs = ((enc, enc_j), (x, x_j), (logits, rlogits))
    if dtype == "float32":
        for t, j in pairs:
            close(t, j)
    else:
        errs = [rel_l2(t.float().numpy(), np.asarray(j, np.float32))
                for t, j in pairs]
        assert max(errs) < BF16_REL_L2, errs
    assert int(state["length"]) == int(rstate["length"]) == S_DEC
    got, want = tree_leaves(state), jax.tree_util.tree_leaves(rstate)
    assert [tuple(t.shape) for t in got] == [a.shape for a in want]
    assert state["xk"].shape == (cfg.n_layers, B, CROSS_LEN, cfg.n_kv_heads,
                                 cfg.hd)


def test_prefill_fills_a_given_state_in_place_with_zero_caches():
    """Kept from the reference: the prefill leaves the self-attention and
    cross-attention caches at zero and sets the length; a given state is
    reset in place (fixed addresses, for a CUDA graph)."""
    _, _, cfg, params = reference()
    model = get_model(cfg, impl="ref", device="cpu")
    frames, _, toks = inputs()
    state = model.init_decode_state(B, MAX_SEQ)
    for t in tree_leaves(state):
        t.fill_(1)
    out, _ = model.prefill(params, frames, torch.from_numpy(toks), MAX_SEQ,
                           state=state)
    assert out is state and int(state["length"]) == S_DEC
    assert all(not state[k].any() for k in ("k", "v", "xk", "xv"))
    with pytest.raises(ValueError, match="does not fit"):
        model.prefill(params, frames, torch.from_numpy(toks), MAX_SEQ + 1,
                      state=state)


def test_greedy_decode_from_zero_cache_prefill():
    """8 fp32 greedy tokens equal the reference's, from its own zero-cache
    prefill; the last logits and the state within 1e-4."""
    model, rp, cfg, params = reference()
    frames, frames_j, toks = inputs()
    mine = get_model(cfg, impl="cuda", device="cpu")
    state, logits = mine.prefill(params, frames, torch.from_numpy(toks),
                                 MAX_SEQ)
    pre = jax.jit(model.prefill, static_argnums=(3,))
    dec = jax.jit(model.decode_step)
    rstate, rlogits = pre(rp, frames_j, jnp.asarray(toks), MAX_SEQ)
    close(logits, rlogits)
    mine_t, theirs = [], []
    for _ in range(STEPS):
        nxt, rnxt = argmax(logits.numpy()), argmax(rlogits)
        mine_t.append(nxt[:, 0].tolist())
        theirs.append(rnxt[:, 0].tolist())
        state, logits = mine.decode_step(params, state, torch.from_numpy(nxt))
        rstate, rlogits = dec(rp, rstate, jnp.asarray(rnxt))
    assert mine_t == theirs
    close(logits, rlogits)
    for t, a in zip(tree_leaves(state), jax.tree_util.tree_leaves(rstate)):
        close(t, a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_from_seeded_nonzero_state(dtype):
    """``k``, ``v``, ``xk`` and ``xv`` random and ``length`` 5: the
    decode's self- and cross-attention over non-zero keys, 3 steps, logits
    and the updated caches against the reference's."""
    model, rp, cfg, params = reference(dtype)
    rng = np.random.default_rng(11)
    mine = get_model(cfg, device="cpu")
    shapes = {k: tuple(t.shape) for k, t in
              mine.init_decode_state(B, MAX_SEQ).items() if k != "length"}
    draws = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    state = {k: torch.from_numpy(a).to(getattr(torch, dtype))
             for k, a in draws.items()}
    state["length"] = torch.tensor(5, dtype=torch.int32)
    rstate = {k: jnp.asarray(a, getattr(jnp, dtype))
              for k, a in draws.items()}
    rstate["length"] = jnp.asarray(5, jnp.int32)
    dec = jax.jit(model.decode_step)
    for step in range(3):
        nxt = rng.integers(0, 256, size=(B, 1)).astype(np.int32)
        state, logits = mine.decode_step(params, state, torch.from_numpy(nxt))
        rstate, rlogits = dec(rp, rstate, jnp.asarray(nxt))
        if dtype == "float32":
            close(logits, rlogits)
        else:
            assert rel_l2(logits.float().numpy(),
                          np.asarray(rlogits, np.float32)) < BF16_REL_L2
    assert int(state["length"]) == 8
    for k in ("k", "v", "xk", "xv"):
        tol = FP32_TOL if dtype == "float32" else 2e-2
        close(state[k], rstate[k], tol)


# -- loss and gradients -----------------------------------------------------

def train_batch(cfg):
    return SyntheticTokens(cfg, SHAPE, seed=0).batch_at(0)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    """fp32: the loss and its metrics within 1e-5, every gradient leaf
    within 1e-4 relative L2 of ``jax.grad`` of the reference's loss."""
    model, rp, cfg, params = reference(remat=remat)
    b = train_batch(cfg)
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        model.loss, has_aux=True))(rp, {k: jnp.asarray(v)
                                        for k, v in b.items()})
    loss, metrics, grads = grads_of(
        get_model(cfg, impl="ref", device="cpu"), params,
        {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_TOL)
    assert set(metrics) == set(want_m)
    np.testing.assert_allclose(float(metrics["ce"]), float(want_m["ce"]),
                               rtol=LOSS_TOL)
    ref_leaves = jax.tree_util.tree_leaves_with_path(want_g)
    mine = tree_leaves(grads)
    assert len(mine) == len(ref_leaves)
    for g, (path, r) in zip(mine, ref_leaves):
        assert tuple(g.shape) == r.shape, path
        assert rel_l2(g.numpy(), r) < GRAD_TOL, (path, rel_l2(g.numpy(), r))


def test_bf16_weights_on_fp32_frames_promote_as_the_reference():
    """bf16 weights and the trainer's fp32 frames: the reference's encoder
    runs in fp32 (``jnp`` promotes the products), and so does the port's,
    within the fp32 tolerance.  The reference's decoder then fails: its
    layer scan's carry enters in bf16 and leaves in fp32 once the
    cross-attention adds fp32 (a ``TypeError``).  The port has no scan; its
    residual stream is promoted to fp32 there, and the loss and the bf16
    gradients are finite."""
    model, rp, cfg, params = reference("bfloat16")
    b = train_batch(cfg)
    assert b["frames"].dtype == np.float32
    want = model.encode(rp, jnp.asarray(b["frames"]), mode="train")
    mine = get_model(cfg, impl="ref", device="cpu")
    got = mine.encode(params, torch.from_numpy(b["frames"]), mode="train")
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    close(got, want)
    # the serving route too, on the kernel route: the norm kernel's wrapper
    # takes the scale cast up to the activations' fp32
    close(get_model(cfg, device="cpu").encode(
        params, torch.from_numpy(b["frames"])), want)
    with pytest.raises(TypeError, match="carry"):
        model.loss(rp, {k: jnp.asarray(v) for k, v in b.items()})
    loss, _, grads = grads_of(mine, params, {k: torch.from_numpy(v)
                                             for k, v in b.items()})
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
               for g in tree_leaves(grads))


def test_train_path_needs_the_plain_route():
    _, _, cfg, params = reference()
    b = {k: torch.from_numpy(v) for k, v in train_batch(cfg).items()}
    with pytest.raises(ValueError, match="plain route"):
        get_model(cfg, impl="cuda", device="cpu").loss(params, b)


# -- weights, steps, specs --------------------------------------------------

def test_params_and_opt_state_from_jax():
    """Every leaf of the reference's tree carried over exactly, in its
    spec's type: pos_dec, the stacked encoder and decoder/xattn leaves."""
    _, rp, cfg, params = reference()
    want = jax.tree_util.tree_leaves_with_path(rp)
    got = tree_leaves(params)
    assert len(got) == len(want)
    for t, (path, a) in zip(got, want):
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32, path
        assert np.array_equal(t.numpy(), np.asarray(a)), path
    assert params["pos_dec"].shape == (cfg.max_position, cfg.d_model)
    assert params["encoder"]["attn"]["wq"].shape[0] == cfg.n_enc_layers
    assert params["decoder"]["xattn"]["wk"].shape[0] == cfg.n_layers
    ro = ref_adamw_init(rp)
    opt = opt_state_from_jax(*(jax.tree_util.tree_map(np.asarray, x)
                               for x in (ro.step, ro.master, ro.m, ro.v)),
                             cfg, "cpu")
    assert int(opt.step) == 0
    for t, a in zip(tree_leaves(opt.master), jax.tree_util.tree_leaves(
            ro.master)):
        assert np.array_equal(t.numpy(), np.asarray(a))
    bf = params_from_jax(jax.tree_util.tree_map(np.asarray, rp),
                         configs("bfloat16")[1], "cpu")
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(bf))


def test_init_params_shapes_and_model_class():
    cfg = SMOKE_ARCHS[ARCH]
    model = get_model(cfg, device="cpu")
    assert type(model) is EncDecLM
    rp = ref_get_model(REF_SMOKE[ARCH]).init_params(jax.random.PRNGKey(0))
    mine = model.init_params(seed=3)
    assert [tuple(t.shape) for t in tree_leaves(mine)] == [
        a.shape for a in jax.tree_util.tree_leaves(rp)]
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(mine))
    with pytest.raises(ValueError, match="encoder-decoder"):
        EncDecLM(SMOKE_ARCHS["gemma-2b"], device="cpu")


def test_make_prefill_and_decode_steps_equal_the_model():
    """``make_prefill_step`` takes the audio batch (frames, tokens) and
    fills a given state in place; ``make_decode_step`` is the model's
    decode step."""
    _, _, cfg, params = reference()
    model = get_model(cfg, device="cpu")
    frames, _, toks = inputs()
    batch = {"frames": frames, "tokens": torch.from_numpy(toks)}
    want_s, want = model.prefill(params, frames, batch["tokens"], MAX_SEQ)
    state = model.init_decode_state(B, MAX_SEQ)
    got_s, got = make_prefill_step(model, cfg, MAX_SEQ)(params, batch,
                                                        state=state)
    assert got_s is state and torch.equal(got, want)
    nxt = torch.from_numpy(argmax(got.numpy()))
    _, a = make_decode_step(model, cfg)(params, got_s, nxt)
    _, b = model.decode_step(params, want_s, nxt)
    assert torch.equal(a, b)


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_make_input_specs_match_reference(arch, shape):
    """Every (arch, shape) cell: the port's ``meta`` tensors have the
    reference's keys, shapes and types."""
    got = make_input_specs(ARCHS[arch], SHAPES[shape])
    want = ref_input_specs(REF_ARCHS[arch], REF_SHAPES[shape])
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == want[k].shape, k
        assert _dtype_name(t.dtype) == want[k].dtype.name, k


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-34b",
                                  "gemma-2b"])
@pytest.mark.parametrize("k", [1, 2])
def test_trainer_buffers_take_the_pipelines_batch(arch, k):
    """The Trainer's fixed buffers have the keys, shapes and types of every
    batch the pipeline yields (K of them stacked when K > 1)."""
    cfg = SMOKE_ARCHS[arch]
    batch = SyntheticTokens(cfg, SHAPE, seed=1).batch_at(2)
    mine = Trainer(cfg, SHAPE, steps_per_launch=k, seed=1, device="cpu")
    lead = () if k == 1 else (k,)
    assert {key: (tuple(t.shape), t.dtype)
            for key, t in mine._batch.items()} == {
        key: (lead + a.shape, torch.from_numpy(a).dtype)
        for key, a in batch.items()}


# -- serving and training ---------------------------------------------------

def test_server_refuses_the_audio_family_in_both_packages():
    """The reference's ``Server.serve`` passes token prompts to the
    encoder-decoder's ``prefill(params, frames, tokens, max_seq)`` and fails
    with a ``TypeError``; the port's raises one naming the family."""
    ref_cfg, cfg = configs()
    prompts = [np.arange(4, dtype=np.int32), np.arange(6, dtype=np.int32)]
    ref = RefServer(ref_cfg, batch_size=2, max_seq=MAX_SEQ,
                    tokens_per_launch=1)
    with pytest.raises(TypeError):
        ref.serve([RefRequest(i, p, 4) for i, p in enumerate(prompts)])
    srv = Server(cfg, batch_size=2, max_seq=MAX_SEQ, tokens_per_launch=1,
                 device="cpu")
    with pytest.raises(TypeError, match="audio"):
        srv.serve([Request(i, p, 4) for i, p in enumerate(prompts)])
    assert srv.tracker.count == 0


def test_trainer_matches_reference():
    """Two fp32 launches of whisper-smoke from the reference trainer's
    weights: the fixed buffers hold the fp32 frames and the [B, S / 4]
    tokens and labels, every loss within 1e-4 relative, and the doorbells'
    names and payload bytes equal the reference's."""
    ref_cfg, cfg = configs()
    ref = RefTrainer(ref_cfg, REF_SHAPE, seed=3, peak_lr=1e-3)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref.params),
                             cfg, "cpu")
    mine = Trainer(cfg, SHAPE, seed=3, peak_lr=1e-3, device="cpu",
                   params=params)
    assert {k: (tuple(t.shape), t.dtype) for k, t in mine._batch.items()} == {
        "frames": ((4, 32, 64), torch.float32),
        "tokens": ((4, 8), torch.int32), "labels": ((4, 8), torch.int32)}
    want = ref.train(2)
    got = mine.train(2)
    np.testing.assert_allclose([m["loss"] for m in mine.metrics_log],
                               [m["loss"] for m in ref.metrics_log],
                               rtol=TRAIN_TOL)
    for key in ("steps", "doorbells", "steps_per_doorbell"):
        assert got[key] == want[key], key
    dispatches = lambda s: [(e.name, e.payload_bytes)
                            for e in s.timeline(kinds="dispatch")]
    assert dispatches(mine.session) == dispatches(ref.session)
