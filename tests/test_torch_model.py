"""The port's dense transformer against the JAX reference on the same weights.

The reference's ``init_params(PRNGKey(0))`` is carried over through numpy by
``repro_torch.weights.params_from_jax``.  fp32 variants of the smoke configs
must agree within 1e-5 and give equal greedy tokens.  bf16 is held to 6e-2:
both frameworks round activations to bf16 at different places, and one bf16
step at the logits' magnitude (about 4) is 2^-5 = 0.031; the smoke models
differ by one to one and a half such steps.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as REF_SMOKE
from repro.models.layers import embed as ref_embed
from repro.models.transformer import TransformerLM as RefLM
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.models import TransformerLM, get_model
from repro_torch.models.layers import embed
from repro_torch.weights import params_from_jax

ARCHS = ["gemma-2b", "qwen3-8b"]
TOL = {"float32": 1e-5, "bfloat16": 6e-2}
MAX_SEQ = 24


class Ref:
    """The reference model with jitted entry points (compiled once per test
    module, so the parity sweep stays fast)."""

    def __init__(self, cfg):
        model = RefLM(cfg)
        self.hidden_states = jax.jit(model.hidden_states,
                                     static_argnames=("mode",))
        self.prefill = jax.jit(model.prefill, static_argnums=(2,))
        self.decode_step = jax.jit(model.decode_step)
        self.params = model.init_params(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def reference(arch: str, dtype: str):
    cfg = dataclasses.replace(SMOKE_ARCHS[arch], param_dtype=dtype)
    ref = Ref(dataclasses.replace(REF_SMOKE[arch], param_dtype=dtype))
    np_tree = jax.tree_util.tree_map(np.asarray, ref.params)
    return cfg, ref, params_from_jax(np_tree, cfg, "cpu")


def setup(arch: str, dtype: str, impl: str):
    cfg, ref, params = reference(arch, dtype)
    return ref, ref.params, TransformerLM(cfg, impl=impl, device="cpu"), params


def tokens(B: int, S: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(3).integers(0, vocab, size=(B, S)).astype(np.int32)


def close(t: torch.Tensor, j, tol: float) -> None:
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


def test_configs_are_copies_of_the_reference():
    for arch in ARCHS:
        assert dataclasses.asdict(SMOKE_ARCHS[arch]) == dataclasses.asdict(
            REF_SMOKE[arch])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["cuda", "ref"])
def test_hidden_states_match(arch, dtype, impl):
    ref, ref_params, model, params = setup(arch, dtype, impl)
    toks = tokens(2, 11, model.cfg.vocab_size)
    want, _ = ref.hidden_states(ref_params, jnp.asarray(toks), mode="eval")
    got = model.hidden_states(params, torch.from_numpy(toks))
    close(got, want, TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["cuda", "ref"])
def test_prefill_and_decode_match(arch, dtype, impl):
    """Prefill logits and K/V cache, then three decode steps."""
    ref, ref_params, model, params = setup(arch, dtype, impl)
    toks = tokens(3, 9, model.cfg.vocab_size)
    tol = TOL[dtype]
    rs, rl = ref.prefill(ref_params, jnp.asarray(toks), MAX_SEQ)
    ps, pl = model.prefill(params, torch.from_numpy(toks), MAX_SEQ)
    close(pl, rl, tol)
    for key in ("k", "v"):
        close(ps[key], rs[key], tol)
    assert ps["length"].dtype == torch.int32 and ps["length"].dim() == 0
    assert int(ps["length"]) == int(rs["length"]) == 9
    nxt = np.asarray(jnp.argmax(rl[:, -1:, :], axis=-1)).astype(np.int32)
    for _ in range(3):
        rs, rl = ref.decode_step(ref_params, rs, jnp.asarray(nxt))
        ps, pl = model.decode_step(params, ps, torch.from_numpy(nxt))
        close(pl, rl, tol)
        for key in ("k", "v"):
            close(ps[key], rs[key], tol)
        assert int(ps["length"]) == int(rs["length"])
        nxt = np.asarray(jnp.argmax(rl[:, -1:, :], axis=-1)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_greedy_tokens_equal(arch):
    ref, ref_params, model, params = setup(arch, "float32", "cuda")
    toks = tokens(2, 6, model.cfg.vocab_size)
    rs, rl = ref.prefill(ref_params, jnp.asarray(toks), MAX_SEQ)
    ps, pl = model.prefill(params, torch.from_numpy(toks), MAX_SEQ)
    for _ in range(8):
        rn = np.asarray(jnp.argmax(rl[:, -1:, :], axis=-1)).astype(np.int32)
        pn = torch.argmax(pl[:, -1:, :], dim=-1).to(torch.int32)
        np.testing.assert_array_equal(pn.numpy(), rn)
        rs, rl = ref.decode_step(ref_params, rs, jnp.asarray(rn))
        ps, pl = model.decode_step(params, ps, pn)


def test_decode_write_clamps_at_cache_end():
    """A decode at length == max_seq writes the last slot, as
    ``dynamic_update_slice`` clamps, and attends to every position."""
    ref, ref_params, model, params = setup("gemma-2b", "float32", "cuda")
    toks = tokens(1, 6, model.cfg.vocab_size)
    rs, _ = ref.prefill(ref_params, jnp.asarray(toks), 6)
    ps, _ = model.prefill(params, torch.from_numpy(toks), 6)
    nxt = np.array([[5]], np.int32)
    rs, rl = ref.decode_step(ref_params, rs, jnp.asarray(nxt))
    ps, pl = model.decode_step(params, ps, torch.from_numpy(nxt))
    close(pl, rl, TOL["float32"])
    close(ps["k"], rs["k"], TOL["float32"])


def test_unported_family_raises():
    audio = dataclasses.replace(SMOKE_ARCHS["gemma-2b"], family="audio")
    with pytest.raises(NotImplementedError):
        get_model(audio, device="cpu")
    with pytest.raises(NotImplementedError):
        TransformerLM(dataclasses.replace(SMOKE_ARCHS["gemma-2b"],
                                          family="hybrid"), device="cpu")
    with pytest.raises(NotImplementedError):
        TransformerLM(dataclasses.replace(SMOKE_ARCHS["gemma-2b"],
                                          pos_embed="learned"), device="cpu")


def test_params_from_jax_checks_shapes():
    cfg = SMOKE_ARCHS["gemma-2b"]
    ref = RefLM(REF_SMOKE["gemma-2b"])
    tree = jax.tree_util.tree_map(np.asarray, ref.init_params(jax.random.PRNGKey(0)))
    tree["final_norm"]["scale"] = np.zeros(cfg.d_model + 1, np.float32)
    with pytest.raises(ValueError):
        params_from_jax(tree, cfg, "cpu")


def test_own_init_matches_reference_shapes_and_dtype():
    cfg = SMOKE_ARCHS["qwen3-8b"]
    ours = TransformerLM(cfg, device="cpu").init_params(seed=1)
    theirs = RefLM(REF_SMOKE["qwen3-8b"]).init_params(jax.random.PRNGKey(0))
    shapes_ours = jax.tree_util.tree_map(lambda t: tuple(t.shape), ours)
    shapes_ref = jax.tree_util.tree_map(lambda t: tuple(t.shape), theirs)
    assert shapes_ours == shapes_ref
    for leaf in jax.tree_util.tree_leaves(ours):
        assert leaf.dtype == torch.bfloat16 and leaf.device.type == "cpu"


def test_embed_scale_is_rounded_to_activation_type():
    """sqrt(d) is rounded to bf16 before the multiply, as the reference
    rounds ``jnp.asarray(sqrt(d), bf16)``: at gemma-2b's d=2048 the factor
    is 45.25, not 45.2548..., and the rounding shows in the output."""
    rng = np.random.default_rng(5)
    table = rng.standard_normal((16, 2048)).astype(np.float32)
    toks = rng.integers(0, 16, size=(2, 7)).astype(np.int32)
    p = {"embed": torch.from_numpy(table).to(torch.bfloat16)}
    got = embed(p, torch.from_numpy(toks), scale=True)
    want = ref_embed({"embed": jnp.asarray(table, jnp.bfloat16)},
                     jnp.asarray(toks), scale=True)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    unrounded = (p["embed"][torch.from_numpy(toks)].float()
                 * 2048 ** 0.5).to(torch.bfloat16)
    assert not torch.equal(got, unrounded)


def test_bf16_embed_scale_keeps_reference_logits_and_tokens():
    """gemma-smoke widened to d_model 128, where sqrt(d) = 11.3137 is no
    bf16 value (it rounds to 11.3125): bf16 prefill logits within the bf16
    tolerance and 8 greedy tokens equal to the reference's."""
    cfg = dataclasses.replace(SMOKE_ARCHS["gemma-2b"], d_model=128)
    ref = Ref(dataclasses.replace(REF_SMOKE["gemma-2b"], d_model=128))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref.params),
                             cfg, "cpu")
    model = TransformerLM(cfg, device="cpu")
    toks = tokens(2, 9, cfg.vocab_size)
    rs, rl = ref.prefill(ref.params, jnp.asarray(toks), MAX_SEQ)
    ps, pl = model.prefill(params, torch.from_numpy(toks), MAX_SEQ)
    close(pl, rl, TOL["bfloat16"])
    for _ in range(8):
        rn = np.asarray(jnp.argmax(rl[:, -1:, :], axis=-1)).astype(np.int32)
        pn = torch.argmax(pl[:, -1:, :], dim=-1).to(torch.int32)
        np.testing.assert_array_equal(pn.numpy(), rn)
        rs, rl = ref.decode_step(ref.params, rs, jnp.asarray(rn))
        ps, pl = model.decode_step(params, ps, pn)
