"""The port's train path against the JAX reference on the same inputs.

Weights are the reference's ``init_params(PRNGKey(seed))``, carried over by
``repro_torch.weights.params_from_jax``; batches are both packages'
``SyntheticTokens`` (byte-equal, ``test_torch_optim.py``).  Everything runs
in fp32 on the CPU.  Tolerances: losses 1e-5 relative for one forward, 1e-4
relative after training steps (the frameworks sum matmuls in other orders
and AdamW's normalised update carries that difference on); gradients 1e-4
in relative L2 norm per leaf (a leaf's near-zero elements have no relative
error of their own).
"""
import dataclasses
import functools
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as REF_SMOKE
from repro.configs.shapes import ShapeConfig as RefShape
from repro.models import get_model as ref_get_model
from repro.models.attention import (
    chunked_causal_attention as ref_chunked,
    dense_causal_attention as ref_dense,
    triangle_chunked_attention as ref_triangle)
from repro.models.layers import cross_entropy_loss as ref_ce
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.runtime.steps import make_train_step as ref_make_train_step
from repro.runtime.trainer import Trainer as RefTrainer
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core.stream import recorded_call, record_ops
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models import get_model
from repro_torch.models.attention import (chunked_causal_attention,
                                          dense_causal_attention,
                                          triangle_chunked_attention)
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.steps import grads_of, init_all, make_train_step
from repro_torch.runtime.trainer import Trainer
from repro_torch.weights import (ef_state_from_jax, opt_state_from_jax,
                                 params_from_jax)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["gemma-2b", "qwen3-8b", "deepseek-7b", "mamba2-780m"]
SHAPE = ShapeConfig("tiny", 32, 4, "train")
REF_SHAPE = RefShape("tiny", 32, 4, "train")
LOSS_TOL = 1e-5
TRAIN_TOL = 1e-4
GRAD_TOL = 1e-4


def fp32(arch, **kw):
    return (dataclasses.replace(REF_SMOKE[arch], param_dtype="float32", **kw),
            dataclasses.replace(SMOKE_ARCHS[arch], param_dtype="float32", **kw))


@functools.lru_cache(maxsize=None)
def ref_params(arch, seed=0, **kw):
    ref_cfg, _ = fp32(arch, **kw)
    params = ref_get_model(ref_cfg).init_params(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, params)


def port_params(arch, seed=0, **kw):
    return params_from_jax(ref_params(arch, seed, **kw), fp32(arch, **kw)[1],
                           "cpu")


def batch_np(cfg, step=0):
    return SyntheticTokens(cfg, SHAPE, seed=0).batch_at(step)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("S,chunk,V,valid,tied", [
    (10, 4, 48, 40, True),       # two chunks and a remainder, padded vocab
    (8, 8, 32, None, False),     # one chunk, untied
    (12, 5, 40, 33, False),      # remainder of 2, padded vocab
    (6, 16, 32, 32, True),       # chunk longer than S
])
def test_cross_entropy_loss_matches(S, chunk, V, valid, tied):
    rng = np.random.default_rng(0)
    B, D = 3, 16
    emb = {"embed": rng.standard_normal((V, D)).astype(np.float32)}
    if not tied:
        emb["unembed"] = rng.standard_normal((D, V)).astype(np.float32)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    labels = rng.integers(0, valid or V, size=(B, S)).astype(np.int32)
    want = ref_ce({k: jnp.asarray(v) for k, v in emb.items()},
                  jnp.asarray(x), jnp.asarray(labels), chunk, valid)
    got = cross_entropy_loss({k: torch.from_numpy(v) for k, v in emb.items()},
                             torch.from_numpy(x), torch.from_numpy(labels),
                             chunk, valid)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)


# ------------------------------------------------------------------ attention
@pytest.mark.parametrize("S,chunk", [(64, 16), (48, 16), (64, 32), (40, 16)])
def test_chunked_attention_matches_reference_and_dense(S, chunk):
    """A port of ``tests/test_models.py::test_chunked_attention_matches_dense``
    with the reference's functions beside: n = 4 chunks (the triangle
    folds), 3 (odd: the triangle takes the plain chunked path), 2, and S
    not a multiple of the chunk (dense)."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, S, 4, 16)).astype(np.float32)
               for _ in range(3))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    dense = dense_causal_attention(tq, tk, tv)
    np.testing.assert_allclose(dense.numpy(), np.asarray(ref_dense(jq, jk, jv)),
                               atol=1e-5)
    for mine, theirs in ((chunked_causal_attention, ref_chunked),
                         (triangle_chunked_attention, ref_triangle)):
        got = mine(tq, tk, tv, chunk)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(theirs(jq, jk, jv, chunk)),
                                   atol=1e-5)
        np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-5)
    # the triangle meets each q chunk's kv chunks in the plain path's order
    assert torch.equal(triangle_chunked_attention(tq, tk, tv, chunk),
                       chunked_causal_attention(tq, tk, tv, chunk))


@pytest.mark.parametrize("tri", [False, True])
def test_model_routes_long_sequences_through_chunked_attention(tri):
    """``impl="ref"`` past ``attn_chunk`` runs the chunked route, as the
    reference does: the train loss equals the reference's at S = 4 chunks."""
    ref_cfg, cfg = fp32("deepseek-7b", attn_chunk=8, attn_tri=tri)
    params = params_from_jax(ref_params("deepseek-7b"), cfg, "cpu")
    b = batch_np(cfg)
    want, _ = jax.jit(ref_get_model(ref_cfg).loss)(
        jax.tree_util.tree_map(jnp.asarray, ref_params("deepseek-7b")),
        {k: jnp.asarray(v) for k, v in b.items()})
    got, _ = get_model(cfg, impl="ref", device="cpu").loss(
        params, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)


# ------------------------------------------------------------------ loss, grads
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(arch, remat):
    """Loss and metrics within 1e-5, every leaf's grad within 1e-4 (relative
    L2) of ``jax.grad`` of the reference's loss; remat (activation
    checkpointing) changes neither."""
    ref_cfg, cfg = fp32(arch, remat=remat)
    ref_model = ref_get_model(ref_cfg)
    rp = jax.tree_util.tree_map(jnp.asarray, ref_params(arch))
    b = batch_np(cfg)
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        ref_model.loss, has_aux=True))(rp, {k: jnp.asarray(v)
                                            for k, v in b.items()})
    model = get_model(cfg, impl="ref", device="cpu")
    loss, metrics, grads = grads_of(model, port_params(arch), {
        k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_TOL)
    assert set(metrics) == set(want_m)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(want_m[k]),
                                   rtol=LOSS_TOL, atol=1e-7)
    ref_leaves = jax.tree_util.tree_leaves_with_path(want_g)
    mine = tree_leaves(grads)
    assert len(mine) == len(ref_leaves)
    for g, (path, r) in zip(mine, ref_leaves):
        assert tuple(g.shape) == r.shape, path
        assert rel_l2(g.numpy(), r) < GRAD_TOL, (path, rel_l2(g.numpy(), r))


def test_train_path_needs_the_plain_route():
    cfg = SMOKE_ARCHS["gemma-2b"]
    model = get_model(cfg, impl="cuda", device="cpu")
    toks = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="plain route"):
        model.loss(model.init_params(), {"tokens": toks, "labels": toks})


# ------------------------------------------------------------------ train step
@pytest.mark.parametrize("arch,microbatch", [("deepseek-7b", 2),
                                             ("mamba2-780m", 2),
                                             ("gemma-2b", 1)])
def test_make_train_step_matches_reference(arch, microbatch):
    """Two steps of ``make_train_step`` (microbatch 2: fp32 accumulation over
    two sequential halves) against the reference's jitted step: loss,
    grad norm, lr and every param leaf."""
    ref_cfg, cfg = fp32(arch, microbatch=microbatch)
    ref_step = jax.jit(ref_make_train_step(ref_get_model(ref_cfg), ref_cfg,
                                           peak_lr=1e-3, warmup=1))
    rp = jax.tree_util.tree_map(jnp.asarray, ref_params(arch))
    ro = ref_adamw_init(rp)
    model = get_model(cfg, impl="ref", device="cpu")
    params, opt = init_all(model, cfg, params=port_params(arch))
    step = make_train_step(model, cfg, peak_lr=1e-3, warmup=1)
    for s in range(2):
        b = batch_np(cfg, s)
        rp, ro, rm = ref_step(rp, ro, {k: jnp.asarray(v) for k, v in b.items()})
        p2, o2, m = step(params, opt, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
        assert p2 is params and o2 is opt
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(rm[key]),
                                       rtol=TRAIN_TOL)
    assert int(opt.step) == int(ro.step) == 2
    for mine, (path, r) in zip(tree_leaves(params),
                               jax.tree_util.tree_leaves_with_path(rp)):
        assert rel_l2(mine.numpy(), r) < TRAIN_TOL, path


# ------------------------------------------------------------------ trainer
def ref_trainer(arch, seed, **kw):
    ref_cfg, _ = fp32(arch)
    return RefTrainer(ref_cfg, REF_SHAPE, seed=seed, peak_lr=1e-3, **kw)


def port_trainer(arch, ref, **kw):
    _, cfg = fp32(arch)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref.params),
                             cfg, "cpu")
    return Trainer(cfg, SHAPE, seed=ref.seed, peak_lr=1e-3, device="cpu",
                   params=params, **kw)


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-7b",
                                  "qwen2-moe-a2.7b"])
def test_trainer_matches_reference(arch):
    """8 fp32 steps from the reference's weights: every launch's loss, the
    doorbells, their names and payload bytes, and the run's dict.  The MoE
    smoke config trains through the sorted dispatch (capacity 20 of a row's
    128 slots over 8 experts), its routes its own in each package."""
    ref = ref_trainer(arch, seed=3)
    mine = port_trainer(arch, ref)
    want = ref.train(8)
    got = mine.train(8)
    np.testing.assert_allclose([m["loss"] for m in mine.metrics_log],
                               [m["loss"] for m in ref.metrics_log],
                               rtol=TRAIN_TOL)
    assert [m["step"] for m in mine.metrics_log] == list(range(1, 9))
    for key in ("steps", "doorbells", "steps_per_doorbell", "trace_events"):
        assert got[key] == want[key], key
    assert mine.losses == [m["loss"] for m in mine.metrics_log]
    dispatches = lambda s: [(e.name, e.payload_bytes)
                            for e in s.timeline(kinds="dispatch")]
    assert dispatches(mine.session) == dispatches(ref.session)
    spans = [e.meta["span_path"] for e in mine.session.timeline(
        kinds="progress")]
    assert spans == [e.meta["span_path"]
                     for e in ref.session.timeline(kinds="progress")]


def test_multistep_launch_fewer_doorbells_same_result():
    """K=4: one doorbell for the 4 steps of four K=1 launches, and the same
    losses step by step (the reference's
    ``test_multistep_launch_fewer_doorbells_same_result``, held tighter)."""
    _, cfg = fp32("deepseek-7b")
    a = Trainer(cfg, SHAPE, steps_per_launch=1, seed=5, device="cpu",
                params=port_params("deepseek-7b", 5))
    oa = a.train(4)
    b = Trainer(cfg, SHAPE, steps_per_launch=4, seed=5, device="cpu",
                params=port_params("deepseek-7b", 5))
    ob = b.train(4)
    assert oa["doorbells"] == 4 and ob["doorbells"] == 1
    assert [r.name for r in b.tracker.records] == ["train_k_steps"]
    assert ob["steps_per_doorbell"] == 4.0
    np.testing.assert_allclose(b.losses, a.losses, rtol=1e-6)
    assert list(b._batch["tokens"].shape) == [4, 4, 32]


def test_checkpoint_restart_exact():
    """Stop at step 4, restore, continue to 6: equal to a straight run to 6;
    and a restore into a trainer that has already stepped writes the
    checkpoint into its fixed tensors (which its launches go on training)."""
    _, cfg = fp32("deepseek-7b")
    mk = lambda **kw: Trainer(cfg, SHAPE, seed=9, device="cpu",
                              params=port_params("deepseek-7b", 9), **kw)
    straight = mk()
    straight.train(6)
    with tempfile.TemporaryDirectory() as d:
        a = mk(ckpt_dir=d, ckpt_every=4)
        a.train(4)
        b = mk(ckpt_dir=d, ckpt_every=4)
        assert b.maybe_restore() and b.step == 4
        b.train(6)
        c = mk(ckpt_dir=d, ckpt_every=100)
        c.train(2)                       # has stepped, its graph bound
        fixed = [t.data_ptr() for t in tree_leaves((c.params, c.opt_state))]
        assert c.maybe_restore() and c.step == 4
        assert [t.data_ptr() for t in tree_leaves(
            (c.params, c.opt_state))] == fixed
        assert int(c.opt_state.step) == 4
        c.train(6)
    assert b.metrics_log[-1]["loss"] == straight.metrics_log[-1]["loss"]
    assert c.losses[-2:] == straight.losses[-2:]
    for x, y in zip(tree_leaves(c.params), tree_leaves(straight.params)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("arch", ["deepseek-7b"])
def test_grad_compression_int8_matches_reference(arch):
    """Four K=1 steps with int8 error feedback, from the same weights."""
    ref = ref_trainer(arch, seed=1, grad_compression="int8")
    mine = port_trainer(arch, ref, grad_compression="int8")
    ref.train(4)
    mine.train(4)
    assert mine.ef_state is not None
    np.testing.assert_allclose([m["loss"] for m in mine.metrics_log],
                               [m["loss"] for m in ref.metrics_log],
                               rtol=TRAIN_TOL)
    for g, (path, r) in zip(tree_leaves(mine.ef_state.residual),
                            jax.tree_util.tree_leaves_with_path(
                                ref.ef_state.residual)):
        assert g.shape == r.shape, path


@pytest.mark.parametrize("compression", [None, "int8"])
def test_trainer_from_reference_mid_run_state(compression):
    """Both trainers from the same mid-run state (after 3 reference steps:
    params, AdamW state and, with int8, the error-feedback residuals
    carried over) agree for 3 more steps."""
    ref = ref_trainer("deepseek-7b", seed=4, grad_compression=compression)
    ref.train(3)
    _, cfg = fp32("deepseek-7b")
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    mine = Trainer(cfg, SHAPE, seed=4, peak_lr=1e-3, device="cpu",
                   grad_compression=compression,
                   params=params_from_jax(host(ref.params), cfg, "cpu"))
    st = ref.opt_state
    carried = opt_state_from_jax(np.asarray(st.step), host(st.master),
                                 host(st.m), host(st.v), cfg, "cpu")
    fixed, state = [mine.opt_state], [carried]
    if compression:
        fixed.append(mine.ef_state)
        state.append(ef_state_from_jax(host(ref.ef_state.residual), cfg,
                                       "cpu"))
    for dst, src in zip(tree_leaves(fixed), tree_leaves(state)):
        dst.copy_(src)
    mine.step = ref.step
    ref.train(6)
    mine.train(6)
    np.testing.assert_allclose([m["loss"] for m in mine.metrics_log],
                               [m["loss"] for m in ref.metrics_log[3:]],
                               rtol=TRAIN_TOL)


# ------------------------------------------------------------------ op stream
def stacked_shapes(params):
    return [tuple(t.shape) for t in tree_leaves(params["layers"])]


def result_shape(entry):
    return entry.raw.rsplit("-> ", 1)[-1]


def test_train_step_op_stream():
    """Dense smoke, remat off: the recorded grads' matmul FLOPs are exactly
    three times the forward's (each product's two backward products), and
    each stacked [L, ...] leaf gets its gradient in one write (the unbind's
    backward ``stack``), with no [L, ...] zero gradient added into."""
    _, cfg = fp32("deepseek-7b")
    model = get_model(cfg, impl="ref", device="cpu")
    params = port_params("deepseek-7b")
    b = {k: torch.from_numpy(v) for k, v in batch_np(cfg).items()}
    fwd = record_ops(lambda: model.loss(params, b))
    _, bwd, _ = recorded_call(lambda: grads_of(model, params, b))
    flops = lambda cs: sum(e.flops for e in cs.entries
                           if e.engine == "compute")
    assert flops(fwd) > 0 and flops(bwd) == 3 * flops(fwd)
    shapes = {str(list(s)) for s in stacked_shapes(params)}
    writes = [e for e in bwd.entries if result_shape(e) in shapes]
    assert sorted(e.opcode for e in writes) == ["stack"] * len(
        stacked_shapes(params))


def test_captured_train_step_records_op_stream():
    """Inside ``record_captures`` the trainer's step records its op stream
    on its first launch, as the card's eager warm-up does."""
    from repro_torch.core.graphs import record_captures
    _, cfg = fp32("deepseek-7b")
    tr = Trainer(cfg, SHAPE, seed=0, device="cpu",
                 params=port_params("deepseek-7b"))
    with record_captures():
        tr.train(2)
    ops = tr.graphs()["train K=1"].ops
    assert ops is not None and ops.total_flops > 0
    assert ops.counts_by_opcode().get("stack", 0) >= len(
        stacked_shapes(tr.params))


# ------------------------------------------------------------------ CLI
def test_train_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "deepseek-7b", "--smoke", "--device", "cpu", "--steps", "4"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "'steps': 4" in proc.stdout and "'doorbells': 1" in proc.stdout
    assert "train_k_steps" in proc.stdout


# ------------------------------------------------------------------ chip_smoke
# phase T4-T6 at smoke size: each family's own small shape (whisper: 64
# frames, 16 decoder tokens; llava: 8 patches, 24 text tokens), remat on as
# on the card, the cut configs on 1 of their 2 layers
T_SMOKE_SHAPES = {"qwen2-moe-a2.7b": ShapeConfig("train", 32, 2, "train"),
                  "whisper-medium": ShapeConfig("train", 64, 2, "train"),
                  "llava-next-34b": ShapeConfig("train", 32, 2, "train")}


def test_chip_smoke_t_work():
    """Phase T's tokens and model FLOPs a step: gemma-2b's are T1's and
    T3's before (B*S and 6 x the params T3 summed, 2506172416 at published
    widths: the count of the spec tree, which the trainer's params equal);
    qwen2-moe on 4 layers counts its active parameters (0.967 B), whisper
    its encoder against the frames and the rest but the position table
    against the decoder's tokens, llava every parameter against its
    patches and text."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import ARCHS as FULL
    from repro_torch.models import param_specs

    tokens, flops, formula = cs.t_work(FULL["gemma-2b"], cs.T_SHAPE)
    assert (tokens, flops) == (2048, 6.0 * 2506172416 * 2048)
    assert formula == "6 x 2506172416 params x 2048 tokens"
    smoke = SMOKE_ARCHS["gemma-2b"]
    tr = Trainer(smoke, SHAPE, steps_per_launch=1, device="cpu")
    n = sum(t.numel() for t in tree_leaves(tr.params))
    assert cs.t_work(smoke, SHAPE)[:2] == (128, 6.0 * n * 128)

    moe = dataclasses.replace(FULL["qwen2-moe-a2.7b"], n_layers=4)
    active = moe.param_counts()[1]
    assert round(active / 1e9, 3) == 0.967
    assert cs.t_work(moe, cs.T_SHAPE)[:2] == (2048, 6.0 * active * 2048)
    assert "active params" in cs.t_work(moe, cs.T_SHAPE)[2]

    whisper = FULL["whisper-medium"]
    specs = param_specs(whisper)
    enc = cs.spec_numel(specs["encoder"])
    dec = cs.spec_numel(specs) - enc - whisper.max_position * whisper.d_model
    shape = cs.T_FAMILIES[1].shape
    assert cs.t_work(whisper, shape)[:2] == (
        8 * 375, 6.0 * (enc * 8 * 1500 + dec * 8 * 375))

    llava = dataclasses.replace(FULL["llava-next-34b"], n_layers=4)
    n = cs.spec_numel(param_specs(llava))
    assert round(n / 1e9, 3) == 3.149
    assert cs.t_work(llava, cs.T_FAMILIES[2].shape)[:2] == (
        4 * 1024, 6.0 * n * 4 * 1024)


def test_chip_smoke_phase_t_rehearsal(monkeypatch):
    """The CPU path of ``chip_smoke.py``'s phase T at smoke size: smoke
    configs under the full names, a small shape; what needs the card (CUDA
    events, memory statistics, the graph's footprint, the profiler's hold
    of the decoded graph) is stubbed.  T1's captured and eager losses must
    agree, T2's doorbells be 16 / 4 / 1 and its K=1 and K=4 losses agree.
    T4-T6 run qwen2-moe-, whisper- and llava-smoke (``T_SMOKE_SHAPES``):
    one line a run, held to its eager control, whisper's K=4 run two
    doorbells for 8 steps, each K=1 graph decoded with its model FLOPs
    (MoE: the active parameters of the cut config)."""
    import contextlib
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.graphs import CapturedStep

    class Event:
        def elapsed_time(self, other):
            return 1.0

    @contextlib.contextmanager
    def timed(graph, events):
        call = CapturedStep.__call__
        monkeypatch.setattr(CapturedStep, "__call__", lambda self: (
            events.append((Event(), Event())), call(self))[1])
        yield
        monkeypatch.setattr(CapturedStep, "__call__", call)

    lines = []
    archs = {a: SMOKE_ARCHS[a] for a in ("gemma-2b", "mamba2-780m")}
    archs.update((a, dataclasses.replace(SMOKE_ARCHS[a], remat=True))
                 for a in T_SMOKE_SHAPES)
    monkeypatch.setattr(cs, "ARCHS", archs)
    monkeypatch.setattr(cs, "T_SHAPE", ShapeConfig("train", 32, 4, "train"))
    monkeypatch.setattr(cs, "T_FAMILIES", tuple(
        dataclasses.replace(r, shape=T_SMOKE_SHAPES[r.arch],
                            n_layers=r.n_layers and 1)
        for r in cs.T_FAMILIES))
    monkeypatch.setattr(cs, "replays_timed", timed)
    monkeypatch.setattr(cs, "peak_gib", lambda: 0.0)
    monkeypatch.setattr(cs, "held_to_graph", lambda label, step, c: {})
    monkeypatch.setattr(cs, "log", lines.append)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    monkeypatch.setattr(CapturedStep, "footprint", lambda self: (0, 0))
    cs.train_path("cpu", torch.device("cpu"))
    runs = [x for x in lines if x.startswith("cpu | train ")]
    assert len(runs) == 5 + 7 and "K=4" in runs[2] and "doorbells 2 for 8" in runs[2]
    economy = [x for x in lines if "train_economy" in x]
    assert [x.split("doorbells ")[1].split(",")[0] for x in economy] == [
        "16", "4", "1"]
    assert any("train K=1 graph" in x and "TFLOP" in x for x in lines)
    # T4-T6: the eager control, then each run's line with its cut and state
    assert [x.split(":")[0] for x in runs[5:]] == [
        "cpu | train qwen2-moe-smoke eager control",
        "cpu | train qwen2-moe-smoke K=1 B=2 S=32 (1 of 2 layers; state "
        + runs[6].split("state ")[1].split(")")[0] + ")",
        "cpu | train whisper-smoke eager control",
        "cpu | train whisper-smoke K=1 B=2 S=64 (2 + 2 layers, uncut; 64 "
        "frames, 16 decoder tokens; state "
        + runs[8].split("state ")[1].split(")")[0] + ")",
        "cpu | train whisper-smoke K=4 B=2 S=64 (2 + 2 layers, uncut; 64 "
        "frames, 16 decoder tokens; state "
        + runs[9].split("state ")[1].split(")")[0] + ")",
        "cpu | train llava-smoke eager control",
        "cpu | train llava-smoke K=1 B=2 S=32 (1 of 2 layers; 8 patch "
        "embeddings, 24 text tokens; state "
        + runs[11].split("state ")[1].split(")")[0] + ")"]
    assert "doorbells 4 for 4 steps" in runs[6]
    assert "doorbells 2 for 8 steps" in runs[9]
    assert all("GiB" in runs[i].split("state ")[1] for i in (6, 8, 9, 11))
    for name, cfg in (("qwen2-moe-smoke", "qwen2-moe-a2.7b"),
                      ("whisper-smoke", "whisper-medium"),
                      ("llava-smoke", "llava-next-34b")):
        graph = [x for x in lines if x.startswith(f"cpu | {name} train K=1 "
                                                   f"graph:")]
        assert len(graph) == 1 and "TFLOP" in graph[0], name
        run = next(r for r in cs.T_FAMILIES if r.arch == cfg)
        cut = dataclasses.replace(archs[cfg],
                                  n_layers=run.n_layers or archs[cfg].n_layers)
        tokens, flops, formula = cs.t_work(cut, run.shape)
        assert f"model FLOPs {flops:.6e} = {formula};" in graph[0], name
    moe = dataclasses.replace(archs["qwen2-moe-a2.7b"], n_layers=1)
    assert (f"= 6 x {moe.param_counts()[1]} active params x 64 tokens"
            in "".join(lines))
    assert any(x.startswith("cpu | phase T: ") for x in lines)
