"""The port's MoE block (``repro_torch.models.moe``) against the reference's.

The reference's ``init_moe`` weights are carried over through numpy; the
inputs are seeded numpy arrays.  Each function is held to the reference's
on the same inputs: the router (weights, expert ids, aux loss), the dense
oracle and the sorted capacity dispatch, at full capacity (``capacity_factor
= E/k``: no slot dropped) and at ``capacity_factor = 1.0`` (slots dropped),
with and without shared experts, with silu and gelu experts.

Tolerances: fp32 1e-5.  bf16 2^-6 (one bf16 step at magnitude 1-2): the
products agree to rounding, silu is the reference's formula and gives equal
bits; gelu is ``F.gelu``'s tanh form, rounded once where XLA rounds each
step, so single values differ by one bf16 step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as REF_SMOKE
from repro.models.moe import _router as ref_router
from repro.models.moe import init_moe
from repro.models.moe import moe_block as ref_block
from repro.models.moe import moe_dense as ref_dense
from repro.models.moe import moe_sorted as ref_sorted
from repro_torch.models.moe import (_router, capacity, moe_block, moe_dense,
                                    moe_sorted)

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
B, S = 2, 24


def setup(arch, dtype, **kw):
    """(config, reference params, port params, reference x, port x)."""
    cfg = dataclasses.replace(REF_SMOKE[arch], param_dtype=dtype, **kw)
    jd = jnp.dtype(dtype)
    rp = init_moe(jax.random.PRNGKey(1), cfg, jd)
    td = getattr(torch, dtype)

    def leaf(a):
        t = torch.from_numpy(np.array(a, np.float32))
        return t if a.dtype == jnp.float32 else t.to(td)
    tp = jax.tree_util.tree_map(leaf, rp)
    x = np.random.default_rng(3).standard_normal((B, S, cfg.d_model))
    xj = jnp.asarray(x, jnp.float32).astype(jd)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(td)
    return cfg, rp, tp, xj, xt


def close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


# (arch, shared-expert count): qwen2-moe with its shared experts and
# without, grok's gelu experts (no shared)
CASES = [("qwen2-moe-a2.7b", None), ("qwen2-moe-a2.7b", 0),
         ("grok-1-314b", None)]


def _kw(arch, shared, cf):
    kw = {} if shared is None else {"n_shared_experts": shared}
    cfg = REF_SMOKE[arch]
    kw["capacity_factor"] = (cfg.n_experts / cfg.top_k if cf == "full"
                             else cf)
    return kw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "grok-1-314b",
                                  "jamba-v0.1-52b"])
def test_router_matches(arch, dtype):
    cfg, rp, tp, xj, xt = setup(arch, dtype)
    w, ids, aux = _router(tp, cfg, xt)
    rw, rids, raux = ref_router(rp, cfg, xj)
    assert w.dtype == torch.float32 and ids.shape == (B, S, cfg.top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    close(w, rw, 1e-5)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)


def test_router_breaks_ties_to_the_lower_expert():
    """Equal probabilities keep the lower expert first, as ``lax.top_k``."""
    cfg, rp, tp, xj, xt = setup("grok-1-314b", "float32")
    w, ids, _ = _router({"router": torch.zeros_like(tp["router"])}, cfg, xt)
    _, rids, _ = ref_router({"router": jnp.zeros_like(rp["router"])}, cfg, xj)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    assert (ids.numpy() == np.arange(cfg.top_k)).all()
    np.testing.assert_allclose(w.numpy(), 1.0 / cfg.top_k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", ["full", 1.0])
@pytest.mark.parametrize("arch,shared", CASES)
def test_moe_dense_and_sorted_match(arch, shared, cf, dtype):
    cfg, rp, tp, xj, xt = setup(arch, dtype, **_kw(arch, shared, cf))
    for mine, theirs in ((moe_dense, ref_dense), (moe_sorted, ref_sorted)):
        y, aux = mine(tp, cfg, xt)
        ry, raux = theirs(rp, cfg, xj)
        assert y.dtype == xt.dtype and y.shape == xt.shape
        close(y, ry, TOL[dtype])
        np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)


@pytest.mark.parametrize("arch,shared", CASES)
def test_capacity_one_drops_the_reference_slots(arch, shared):
    """At capacity_factor 1.0 slots are dropped (the sorted output leaves
    the dense one), and the sorted output equals the reference's: the same
    slots were dropped."""
    cfg, rp, tp, xj, xt = setup(arch, "float32", **_kw(arch, shared, 1.0))
    assert capacity(cfg, S) < S
    y, _ = moe_sorted(tp, cfg, xt)
    dense, _ = moe_dense(tp, cfg, xt)
    assert not torch.allclose(y, dense, rtol=1e-3, atol=1e-3)
    close(y, ref_sorted(rp, cfg, xj)[0], TOL["float32"])


@pytest.mark.parametrize("arch,shared", CASES)
def test_sorted_matches_dense_with_full_capacity(arch, shared):
    """The port's own paths, as ``tests/test_models.py``'s
    ``test_moe_sorted_matches_dense_with_full_capacity``."""
    cfg, _, tp, _, xt = setup(arch, "float32", **_kw(arch, shared, "full"))
    assert capacity(cfg, S) == S
    y_s, _ = moe_sorted(tp, cfg, xt)
    y_d, _ = moe_dense(tp, cfg, xt)
    np.testing.assert_allclose(y_s.numpy(), y_d.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("impl", ["sorted", "sorted_smap", "dense"])
def test_moe_block_dispatches_like_the_reference(impl):
    """One token a row (decode: capacity 1 a row), every impl."""
    cfg, rp, tp, xj, xt = setup("qwen2-moe-a2.7b", "float32", moe_impl=impl)
    y, _ = moe_block(tp, cfg, xt[:, :1])
    close(y, ref_block(rp, cfg, xj[:, :1])[0], TOL["float32"])
    assert capacity(cfg, 1) == 1


def test_capacity_formula():
    cfg = REF_SMOKE["qwen2-moe-a2.7b"]               # E=8, k=4, cf=1.25
    assert [capacity(cfg, s) for s in (1, 2, 7, 24, 255)] == [
        1, 1, 4, 15, 159]
    big = dataclasses.replace(cfg, capacity_factor=8.0)
    assert capacity(big, 24) == 24                   # clipped at S
