"""The port's optimizer, compression, data pipeline, checkpoints and fault
tolerance against the JAX reference, and the reference's substrate cases
(``tests/test_substrate.py``) run on the port.

Inputs are made from a seed with numpy.  Tolerances: fp32 updates 1e-6
relative (both compute the same fp32 formula, in other operation orders);
the schedule 1e-6; int8 codes and data batches exactly.
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as REF_SMOKE
from repro.configs.shapes import ShapeConfig as RefShape
from repro.data.pipeline import SyntheticTokens as RefTokens
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import compress_int8 as ref_compress
from repro.optim import cosine_schedule as ref_cosine
from repro.optim import decompress_int8 as ref_decompress
from repro.optim import ef_compress_update as ref_ef_update
from repro.optim import ef_init as ref_ef_init
from repro.runtime.checkpoint import restore as ref_restore
from repro.runtime.checkpoint import save as ref_save
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.data.pipeline import SyntheticTokens, make_pipeline
from repro_torch.optim import (adamw_init, adamw_update, adamw_update_,
                               clip_by_global_norm, compress_int8,
                               cosine_schedule, decompress_int8,
                               ef_compress_update, ef_init, linear_warmup)
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.checkpoint import (CheckpointManager, latest_step,
                                            restore, save)
from repro_torch.runtime.fault_tolerance import (FaultPolicy, FleetMonitor,
                                                 plan_elastic_mesh)

RTOL = 1e-6


def tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((7, 5)) * scale).astype(np.float32),
            "b": {"c": (rng.standard_normal(300) * scale).astype(np.float32),
                  "d": (rng.standard_normal((2, 3, 4)) * scale
                        ).astype(np.float32)}}


def to_torch(t, dtype=torch.float32):
    if isinstance(t, dict):
        return {k: to_torch(v, dtype) for k, v in t.items()}
    return torch.from_numpy(np.asarray(t, np.float32)).to(dtype)


def to_jax(t, dtype=jnp.float32):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), t)


def leaves_close(mine, theirs, rtol=RTOL, atol=0.0):
    ref = jax.tree_util.tree_leaves(theirs)
    got = tree_leaves(mine)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r, np.float32), rtol=rtol,
                                   atol=atol)


# ------------------------------------------------------------------ optim
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])
def test_adamw_update_matches_reference(dtype, grad_scale):
    """Five steps from the same params and grads: params, master, moments,
    step and metrics (grad_scale 10 clips, 1e-3 does not)."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    params = tree(0)
    jp, tp = to_jax(params, jdt), to_torch(params, tdt)
    js, ts = ref_adamw_init(jp), adamw_init(tp)
    for s in range(5):
        g = tree(10 + s, grad_scale)
        lr = float(ref_cosine(s, 2, 10, 1e-2))
        jp, js, jm = ref_adamw_update(to_jax(g, jdt), js, jp, lr)
        tp, ts, tm = adamw_update(to_torch(g, tdt), ts, tp, lr)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL)
    assert int(ts.step) == int(js.step) == 5 and ts.step.dtype == torch.int32
    for a, b in ((ts.master, js.master), (ts.m, js.m), (ts.v, js.v)):
        leaves_close(a, b, rtol=1e-5, atol=1e-9)
    # params: the master cast to the param type
    leaves_close(tp, jp, rtol=1e-5 if dtype == "float32" else 8e-3, atol=1e-9)
    assert all(t.dtype == tdt for t in tree_leaves(tp))


def test_adamw_update_in_place_keeps_addresses():
    """``adamw_update_`` writes the step, moments, master and params in
    place (a CUDA Graph replays it on fixed tensors) and equals the
    functional form."""
    tp = to_torch(tree(0))
    st = adamw_init(tp)
    g = to_torch(tree(1))
    want_p, want_s, _ = adamw_update(g, st, tp, 1e-2)
    ptrs = [t.data_ptr() for t in tree_leaves((tp, st))]
    adamw_update_(g, st, tp, torch.tensor(1e-2))
    assert [t.data_ptr() for t in tree_leaves((tp, st))] == ptrs
    for a, b in zip(tree_leaves((tp, st)), tree_leaves((want_p, want_s))):
        assert torch.equal(a, b)


def test_clip_by_global_norm_matches_reference():
    g = tree(3, 5.0)
    want, wn = ref_clip(to_jax(g), 1.0)
    got, gn = clip_by_global_norm(to_torch(g), 1.0)
    np.testing.assert_allclose(float(gn), float(wn), rtol=RTOL)
    leaves_close(got, want)


def test_cosine_schedule_matches_reference():
    steps = list(range(0, 130, 3))
    want = [float(ref_cosine(s, 10, 100, 3e-4)) for s in steps]
    got = [float(cosine_schedule(s, 10, 100, 3e-4)) for s in steps]
    np.testing.assert_allclose(got, want, rtol=RTOL)
    dev = cosine_schedule(torch.tensor(12, dtype=torch.int32), 10, 100, 3e-4)
    assert dev.dtype == torch.float32 and dev.dim() == 0
    assert float(linear_warmup(5, 10, 2.0)) == pytest.approx(1.0)


@pytest.mark.parametrize("n,scale", [(1000, 0.01), (256, 1.0), (37, 3.0),
                                     (0, 1.0)])
def test_int8_codes_equal_reference(n, scale):
    """Block size 256, zero padding, half-to-even rounding, clip ±127: the
    int8 codes equal the reference's exactly, the scales and the round trip
    to fp32 rounding."""
    x = (np.random.default_rng(n).standard_normal(n) * scale).astype(
        np.float32)
    x[:3] = [0.5 * scale, -1.5 * scale, 0.0][:min(3, n)] if n else x[:3]
    jq, js = ref_compress(jnp.asarray(x))
    tq, ts = compress_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and tuple(tq.shape) == jq.shape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL)
    np.testing.assert_allclose(
        decompress_int8(tq, ts, (n,), torch.float32).numpy(),
        np.asarray(ref_decompress(jq, js, (n,), jnp.float32)), rtol=RTOL)


def test_ef_compress_update_matches_reference():
    g = tree(5, 1e-3)
    jef, tef = ref_ef_init(to_jax(g)), ef_init(to_torch(g))
    for s in range(3):
        gs = tree(20 + s, 1e-3)
        jg, jef = ref_ef_update(to_jax(gs), jef)
        tg, tef = ef_compress_update(to_torch(gs), tef)
        leaves_close(tg, jg, rtol=1e-5, atol=1e-12)
        leaves_close(tef.residual, jef.residual, rtol=1e-4, atol=1e-12)


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma-2b", "mamba2-780m"])
@pytest.mark.parametrize("n_hosts", [1, 2])
def test_synthetic_tokens_byte_equal(arch, n_hosts):
    shape = ShapeConfig("t", 32, 8, "train")
    ref_shape = RefShape("t", 32, 8, "train")
    for host in range(n_hosts):
        mine = SyntheticTokens(SMOKE_ARCHS[arch], shape, seed=3,
                               host_id=host, n_hosts=n_hosts)
        ref = RefTokens(REF_SMOKE[arch], ref_shape, seed=3, host_id=host,
                        n_hosts=n_hosts)
        for step in (0, 1, 17):
            a, b = mine.batch_at(step), ref.batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert a[k].tobytes() == b[k].tobytes()


# ------------------------------------------------------------------ checkpoints
def test_checkpoints_interchange_with_reference():
    """The layout is the reference's: a port checkpoint restores in the
    reference and the other way round, bf16 leaves and the step included."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    t_tree = ({"w": torch.from_numpy(w).bfloat16(),
               "v": torch.arange(5, dtype=torch.int32)},
              (torch.tensor(7, dtype=torch.int32),))
    j_tree = ({"w": jnp.asarray(w, jnp.bfloat16),
               "v": jnp.arange(5, dtype=jnp.int32)},
              (jnp.asarray(7, jnp.int32),))
    with tempfile.TemporaryDirectory() as d:
        save(d, 3, t_tree, extra={"next_step": 3})
        out, step, extra = ref_restore(d, j_tree)
        assert step == 3 and extra == {"next_step": 3}
        np.testing.assert_array_equal(np.asarray(out[0]["w"], np.float32),
                                      t_tree[0]["w"].float().numpy())
        assert int(out[1][0]) == 7
    with tempfile.TemporaryDirectory() as d:
        ref_save(d, 4, j_tree)
        out, step, _ = restore(d, t_tree)
        assert step == 4 and out[0]["w"].dtype == torch.bfloat16
        assert torch.equal(out[0]["w"], t_tree[0]["w"])
        assert torch.equal(out[0]["v"], t_tree[0]["v"])
        assert out[1][0].shape == () and int(out[1][0]) == 7


# ------------------------------------------------------------------ the
# reference's substrate cases (tests/test_substrate.py), on the port
def test_adamw_reduces_quadratic_loss():
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = adamw_init(params)
    for _ in range(200):
        g = {"w": 2 * params["w"]}
        params, opt, _ = adamw_update(g, opt, params, lr=0.05,
                                      weight_decay=0.0)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


def test_grad_clip():
    clipped, gn = clip_by_global_norm({"a": torch.ones(4) * 100.0}, 1.0)
    assert float(gn) == pytest.approx(200.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0,
                                                                   rel=1e-3)


def test_cosine_schedule_monotone_regions():
    w, total, peak = 10, 100, 1.0
    lrs = [float(cosine_schedule(s, w, total, peak)) for s in range(100)]
    assert lrs[0] == 0.0
    assert max(lrs) == pytest.approx(peak, rel=1e-3)
    assert lrs[-1] < lrs[15]


def test_int8_roundtrip_error_small():
    x = torch.from_numpy((np.random.default_rng(0).normal(size=(1000,))
                          * 0.01).astype(np.float32))
    q, s = compress_int8(x)
    y = decompress_int8(q, s, x.shape, torch.float32)
    assert float(torch.linalg.norm(y - x) / torch.linalg.norm(x)) < 0.01
    assert q.dtype == torch.int8


def test_error_feedback_preserves_signal():
    g = {"w": torch.from_numpy((np.random.default_rng(1).normal(size=(512,))
                                * 1e-4).astype(np.float32))}
    ef = ef_init(g)
    acc = torch.zeros(512)
    for _ in range(20):
        cg, ef = ef_compress_update(g, ef)
        acc = acc + cg["w"]
    true = 20 * g["w"]
    assert float(torch.linalg.norm(acc - true) / torch.linalg.norm(true)) < 0.05


def test_pipeline_deterministic_and_host_sharded():
    cfg = SMOKE_ARCHS["deepseek-7b"]
    shape = ShapeConfig("t", 32, 8, "train")
    a = SyntheticTokens(cfg, shape, seed=3).batch_at(17)
    b = SyntheticTokens(cfg, shape, seed=3).batch_at(17)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = SyntheticTokens(cfg, shape, seed=3).batch_at(18)
    assert not np.array_equal(a["tokens"], c["tokens"])
    h0 = SyntheticTokens(cfg, shape, seed=3, host_id=0, n_hosts=2)
    h1 = SyntheticTokens(cfg, shape, seed=3, host_id=1, n_hosts=2)
    assert h0.host_batch == 4
    assert not np.array_equal(h0.batch_at(0)["tokens"],
                              h1.batch_at(0)["tokens"])
    assert a["tokens"].max() < cfg.vocab_size


def test_prefetcher_orders_steps():
    pipe = make_pipeline(SMOKE_ARCHS["deepseek-7b"],
                         ShapeConfig("t", 32, 4, "train"), start_step=5)
    s0, _ = pipe.next()
    s1, _ = pipe.next()
    pipe.stop()
    assert (s0, s1) == (5, 6)


def test_checkpoint_roundtrip_bf16():
    t = {"a": torch.tensor([[1.5, -2.25]], dtype=torch.bfloat16),
         "b": {"c": torch.arange(6, dtype=torch.int32)}}
    with tempfile.TemporaryDirectory() as d:
        save(d, 7, t, extra={"next_step": 8})
        out, step, extra = restore(d, t)
        assert step == 7 and extra["next_step"] == 8
        assert out["a"].dtype == torch.bfloat16
        assert torch.equal(out["a"], t["a"])
        assert torch.equal(out["b"]["c"], t["b"]["c"])


def test_checkpoint_manager_retention():
    t = {"w": torch.zeros(4)}
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep_last_n=2, every_steps=1)
        for s in (1, 2, 3, 4):
            mgr.maybe_save(s, t)
        mgr.wait()
        mgr._gc()
        steps = sorted(int(x.split("_")[1]) for x in os.listdir(d)
                       if x.startswith("step_"))
        assert steps == [3, 4]
        assert latest_step(d) == 4


def test_checkpoint_atomicity_no_tmp_left():
    with tempfile.TemporaryDirectory() as d:
        save(d, 1, {"w": torch.zeros(4)})
        assert not any(x.startswith("tmp.") for x in os.listdir(d))


def test_fleet_monitor_detects_dead_and_restarts():
    mon = FleetMonitor(4, FaultPolicy(dead_timeout_s=5.0))
    t = 0.0
    for _ in range(8):
        for w in range(4):
            if w == 2 and t > 3:
                continue  # worker 2 dies at t=3
            mon.step_completed(w, t)
        t += 1.0
    stragglers, dead = mon.check(now=t + 5)
    assert 2 in dead
    assert mon.should_restart(dead)


def test_plan_elastic_mesh_divisibility():
    dims = [53248, 128, 16384]
    assert plan_elastic_mesh(256, dims) == (16, 16)
    data, model = plan_elastic_mesh(240, dims)
    assert data * model <= 240
    assert all(d % model == 0 for d in dims)
    assert plan_elastic_mesh(7, [5, 3]) == (7, 1)
