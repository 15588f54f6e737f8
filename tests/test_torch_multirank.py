"""The port's distributed layer on a 2 x 2 mesh of spawned gloo ranks.

Each test starts four ranks (``tests/torch_ranks.py``: context ``spawn``, a
``FileStore`` under ``tmp_path``, a 120 s limit after which the ranks are
terminated and the test fails) over ``make_mesh(2, 2, device="cpu")``:
stages or the batch over ``data``, tensor parallelism over ``model``.  The
JAX reference runs here, in the test process, never in a rank.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import SMOKE_ARCHS as REF_SMOKE
from repro.configs.base import ModelConfig as RefConfig
from repro.models import get_model as ref_get_model
from repro.models.moe import init_moe, moe_sorted

from torch_ranks import (SHARD_SPECS, config_fields, run_ranks, save_tree)

# tests/test_multidevice.py's PP config, and one whose 3 layers pad a
# virtual layer over 2 stages
PP_CFG = RefConfig(name="t", family="dense", n_layers=4, d_model=32,
                   n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
                   vocab_size=64, param_dtype="float32", remat=False,
                   attn_chunk=0, loss_chunk=16)
PP_CFGS = {"4_layers": PP_CFG,
           "3_layers_padded": dataclasses.replace(PP_CFG, n_layers=3)}
PP_TOL = 3e-4


@pytest.mark.parametrize("name", sorted(PP_CFGS))
def test_pp_decode_matches_sequential_with_lag(tmp_path, name):
    """PP (2 stages x 2-way TP, T=2, 3 launches) against the reference's
    sequential ``decode_step``: µbatch u's logits of launch n appear at
    launch n + (u + n_stages - 1) // n_stages, the reference's lag rule.
    max_seq 8 puts positions 0-5 across both sequence shards (4 rows
    each), so a row written by the wrong shard shows."""
    cfg = PP_CFGS[name]
    B, S_max, n_steps, T = 4, 8, 3, 2
    model = ref_get_model(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (n_steps, B, T), 0,
                              cfg.vocab_size)
    state = model.init_decode_state(B, S_max)
    dec = jax.jit(model.decode_step)
    ref = []
    for n in range(n_steps):
        per_t = []
        for j in range(T):
            state, lg = dec(params, state, toks[n][:, j:j + 1])
            per_t.append(np.asarray(lg, np.float32)[:, 0])
        ref.append(np.stack(per_t, axis=1))
    inputs = tmp_path / "pp_inputs.npz"
    save_tree(inputs, {**jax.tree_util.tree_map(np.asarray, params),
                       "tokens": np.asarray(toks, np.int32)})
    ranks = run_ranks(tmp_path, "pp", cfg=config_fields(cfg),
                      inputs=str(inputs), batch=B, max_seq=S_max,
                      tokens_per_launch=T)
    out = ranks[0]["logits"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["logits"], out)
    ns = 2
    lps = -(-cfg.n_layers // ns)
    np.testing.assert_array_equal(
        ranks[0]["valid"],
        (np.arange(ns * lps) < cfg.n_layers).reshape(ns, lps))
    assert int(ranks[0]["length"]) == n_steps * T
    mb = B // ns
    checked = 0
    for n in range(n_steps):
        for u in range(ns):
            lag = (u + ns - 1) // ns
            if n + lag >= n_steps:
                continue
            np.testing.assert_allclose(
                out[n + lag][u * mb:(u + 1) * mb, :, :cfg.vocab_size],
                ref[n][u * mb:(u + 1) * mb], rtol=PP_TOL, atol=PP_TOL)
            checked += 1
    assert checked == n_steps * ns - 1


@pytest.mark.parametrize("shared", [0, 2])
def test_moe_smap_matches_sorted_on_mesh(tmp_path, shared):
    """``moe_sorted_smap`` on 2 x 2 (batch over data, expert FFNs over
    model, one psum after the combine) against the reference's
    ``moe_sorted``, with and without shared experts."""
    cfg = dataclasses.replace(REF_SMOKE["qwen2-moe-a2.7b"], d_ff=32,
                              capacity_factor=2.0, n_shared_experts=shared,
                              param_dtype="float32", moe_impl="sorted_smap")
    key = jax.random.PRNGKey(0)
    p = init_moe(key, cfg, jnp.float32)
    x = jax.random.normal(key, (4, 32, cfg.d_model), jnp.float32)
    y_ref, aux_ref = moe_sorted(p, cfg, x)
    inputs = tmp_path / "moe_inputs.npz"
    save_tree(inputs, {**jax.tree_util.tree_map(np.asarray, p),
                       "x": np.asarray(x)})
    ranks = run_ranks(tmp_path, "moe", cfg=config_fields(cfg),
                      inputs=str(inputs))
    for r in ranks:
        np.testing.assert_allclose(r["y"], np.asarray(y_ref), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r["aux"], np.asarray(aux_ref), rtol=1e-5,
                                   atol=1e-6)


def _block(t: np.ndarray, spec, coord) -> np.ndarray:
    sizes = {"data": 2, "model": 2}
    where = {"data": coord[0], "model": coord[1]}
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        axes = (axis,) if isinstance(axis, str) else axis
        idx, n = 0, 1
        for a in axes:
            idx, n = idx * sizes[a] + where[a], n * sizes[a]
        blk = t.shape[d] // n
        t = np.take(t, np.arange(idx * blk, (idx + 1) * blk), axis=d)
    return t


def test_local_shard_and_placements_match_numpy_blocks(tmp_path):
    """Each rank's ``local_shard`` block and its DTensor block under
    ``to_placements`` equal the numpy slice of the spec, a tuple axis
    ("data", "model") included (data-major); ``process_info`` inside the
    group gives the rank of 4."""
    shape = [8, 6]
    ranks = run_ranks(tmp_path, "shard", shape=shape)
    t = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    coords = set()
    for rank, r in enumerate(ranks):
        coord = tuple(int(c) for c in r["coord"])
        coords.add(coord)
        assert coord == (rank // 2, rank % 2)
        for name, spec in SHARD_SPECS.items():
            want = _block(t, spec, coord)
            np.testing.assert_array_equal(r[f"local/{name}"], want)
            np.testing.assert_array_equal(r[f"dtensor/{name}"], want)
        assert r["info"].tolist() == [rank, 4]
    assert len(coords) == 4
