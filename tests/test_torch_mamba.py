"""The port's Mamba2 LM against the JAX reference on the same weights.

The reference's ``MambaLM(cfg).init_params(PRNGKey(0))`` is carried over
through numpy by ``repro_torch.weights.params_from_jax``.  fp32 is held to
1e-4: the scans sum in another order than XLA's and the decode state is
compared leaf by leaf.  bf16 is held to 6e-2, as for the dense models: the
frameworks round activations to bf16 at different places, one bf16 step at
the logits' magnitude is 2^-5 to 2^-4.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as REF_SMOKE
from repro.configs.mamba2_780m import CONFIG as REF_CONFIG
from repro.models.ssm import MambaLM as RefLM
from repro_torch.configs import ARCHS, SMOKE_ARCHS
from repro_torch.models import MambaLM, get_model
from repro_torch.weights import params_from_jax

ARCH = "mamba2-780m"
TOL = {"float32": 1e-4, "bfloat16": 6e-2}
STATE_KEYS = ("h", "conv_x", "conv_B", "conv_C")
MAX_SEQ = 32


class Ref:
    """The reference model with jitted entry points, compiled once."""

    def __init__(self, cfg, impl="ref"):
        model = RefLM(cfg, impl)
        self.hidden_states = jax.jit(model.hidden_states,
                                     static_argnames=("mode",))
        self.prefill = jax.jit(model.prefill, static_argnums=(2,))
        self.decode_step = jax.jit(model.decode_step)
        self.params = model.init_params(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def reference(dtype: str):
    cfg = dataclasses.replace(SMOKE_ARCHS[ARCH], param_dtype=dtype)
    ref = Ref(dataclasses.replace(REF_SMOKE[ARCH], param_dtype=dtype))
    np_tree = jax.tree_util.tree_map(np.asarray, ref.params)
    return cfg, ref, params_from_jax(np_tree, cfg, "cpu")


def tokens(B: int, S: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(5).integers(0, vocab, size=(B, S)).astype(np.int32)


def close(t: torch.Tensor, j, tol: float) -> None:
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


def test_configs_are_copies_of_the_reference():
    assert dataclasses.asdict(SMOKE_ARCHS[ARCH]) == dataclasses.asdict(
        REF_SMOKE[ARCH])
    assert dataclasses.asdict(ARCHS[ARCH]) == dataclasses.asdict(REF_CONFIG)


# S = 12 is one chunk of 12 (min(ssm_chunk, S)); S = 48 is three chunks of
# 16, so the state is carried across chunks
@pytest.mark.parametrize("S", [12, 48])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["cuda", "ref"])
def test_hidden_states_match(S, dtype, impl):
    cfg, ref, params = reference(dtype)
    toks = tokens(2, S, cfg.vocab_size)
    want, _ = ref.hidden_states(ref.params, jnp.asarray(toks), mode="eval")
    got = MambaLM(cfg, impl, "cpu").hidden_states(params,
                                                  torch.from_numpy(toks))
    assert got.dtype == getattr(torch, dtype)
    close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["cuda", "ref"])
def test_prefill_and_decode_match(dtype, impl):
    """Prefill logits and the (zero) state, then three decode steps with
    every state leaf."""
    cfg, ref, params = reference(dtype)
    model = MambaLM(cfg, impl, "cpu")
    toks = tokens(3, 32, cfg.vocab_size)
    tol = TOL[dtype]
    rs, rl = ref.prefill(ref.params, jnp.asarray(toks), MAX_SEQ)
    ps, pl = model.prefill(params, torch.from_numpy(toks), MAX_SEQ)
    close(pl, rl, tol)
    for _ in range(4):
        for key in STATE_KEYS:
            assert ps[key].shape == rs[key].shape
            assert ps[key].dtype == (torch.float32 if key == "h"
                                     else getattr(torch, dtype))
            close(ps[key], rs[key], tol)
        nxt = np.asarray(jnp.argmax(rl[:, -1:, :], axis=-1)).astype(np.int32)
        rs, rl = ref.decode_step(ref.params, rs, jnp.asarray(nxt))
        ps, pl = model.decode_step(params, ps, torch.from_numpy(nxt))
        close(pl, rl, tol)


def test_pallas_route_of_the_reference_matches():
    """The reference's Pallas SSD route (interpret mode on the CPU) gives
    the port's prefill logits too."""
    cfg, ref, params = reference("float32")
    pallas = Ref(dataclasses.replace(REF_SMOKE[ARCH], param_dtype="float32"),
                 "pallas")
    toks = tokens(2, 32, cfg.vocab_size)
    _, want = pallas.prefill(ref.params, jnp.asarray(toks), MAX_SEQ)
    _, got = MambaLM(cfg, "cuda", "cpu").prefill(params,
                                                 torch.from_numpy(toks), MAX_SEQ)
    close(got, want, TOL["float32"])


def test_fp32_greedy_tokens_equal():
    cfg, ref, params = reference("float32")
    model = MambaLM(cfg, "cuda", "cpu")
    toks = tokens(2, 16, cfg.vocab_size)
    rs, rl = ref.prefill(ref.params, jnp.asarray(toks), MAX_SEQ)
    ps, pl = model.prefill(params, torch.from_numpy(toks), MAX_SEQ)
    for _ in range(8):
        rn = np.asarray(jnp.argmax(rl[:, -1:, :], axis=-1)).astype(np.int32)
        pn = torch.argmax(pl[:, -1:, :], dim=-1).to(torch.int32)
        np.testing.assert_array_equal(pn.numpy(), rn)
        rs, rl = ref.decode_step(ref.params, rs, jnp.asarray(rn))
        ps, pl = model.decode_step(params, ps, pn)


def test_prompt_not_a_multiple_of_the_chunk_raises():
    cfg, _, params = reference("float32")
    model = MambaLM(cfg, "cuda", "cpu")
    toks = torch.from_numpy(tokens(1, 20, cfg.vocab_size))   # chunk 16
    with pytest.raises(ValueError, match="chunk"):
        model.prefill(params, toks, MAX_SEQ)
    with pytest.raises(ValueError, match="chunk"):
        model.hidden_states(params, toks)


def test_own_init_matches_reference_shapes_and_dtypes():
    cfg = SMOKE_ARCHS[ARCH]
    ours = get_model(cfg, device="cpu").init_params(seed=1)
    theirs = RefLM(REF_SMOKE[ARCH]).init_params(jax.random.PRNGKey(0))
    assert (jax.tree_util.tree_map(lambda t: (tuple(t.shape), str(t.dtype)), ours)
            == jax.tree_util.tree_map(
                lambda a: (tuple(a.shape), "torch." + str(a.dtype)), theirs))
    m = ours["layers"]["mamba"]
    for key in ("A_log", "D", "dt_bias"):
        assert m[key].dtype == torch.float32
    assert torch.equal(m["D"], torch.ones_like(m["D"]))
    assert not m["A_log"].any() and not m["dt_bias"].any()
    assert m["z_proj"].dtype == torch.bfloat16


def test_params_from_jax_keeps_fp32_leaves_in_a_bf16_model():
    _, _, params = reference("bfloat16")
    m = params["layers"]["mamba"]
    assert m["x_proj"].dtype == torch.bfloat16
    assert all(m[k].dtype == torch.float32 for k in ("A_log", "D", "dt_bias"))


def test_unported_families_raise():
    for family in ("audio", "vlm"):
        cfg = dataclasses.replace(SMOKE_ARCHS[ARCH], family=family)
        with pytest.raises(NotImplementedError):
            get_model(cfg, device="cpu")
