"""The port's distributed layer in one process: the mesh helpers, the
``shard_map`` MoE's fallback, the pipeline schedule, and ``PPDecoder`` on a
one-rank gloo mesh against the reference's ``PPDecoder`` on
``make_mesh(1, 1)`` (fp32, logits and every state leaf after each launch).

The multi-rank cases (2 x 2 gloo ranks) are in
``tests/test_torch_multirank.py``; ``tests/test_torch_mesh_cuda.py`` runs
the pipeline on a one-rank NCCL mesh on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import SMOKE_ARCHS as REF_SMOKE
from repro.distributed.pp_decode import PPDecoder as RefPPDecoder
from repro.launch.mesh import make_mesh as ref_make_mesh
from repro.models.moe import init_moe
from repro.models.moe import moe_sorted as ref_sorted
from repro.models.moe import moe_sorted_smap as ref_smap

from repro_torch.configs import ARCHS, SMOKE_ARCHS, resolve
from repro_torch.distributed import context
from repro_torch.distributed.context import P, local_shard, shard_map
from repro_torch.distributed.pp_decode import PPDecoder
from repro_torch.launch.mesh import (MULTI_POD, SINGLE_POD, MeshLayout,
                                     fleet_session, make_mesh,
                                     make_production_mesh)
from repro_torch.models import TransformerLM
from repro_torch.models.layers import map_params
from repro_torch.models.moe import moe_sorted, moe_sorted_smap
from repro_torch.weights import params_from_jax

rng = np.random.default_rng(11)
PP_TOL = 1e-4


@pytest.fixture
def gloo_one(tmp_path):
    """A one-rank gloo process group over a FileStore, and its (1, 1)
    mesh; destroyed after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield make_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def test_pp_decoder_schedule_math():
    """Stage/µbatch bookkeeping invariants on the port's SINGLE_POD: every
    stage serves every µbatch once a launch, and µbatch m wraps at stage s
    exactly when the tick is below s (the position-offset rule)."""
    n_stages = SINGLE_POD[0]
    n_micro = n_stages
    served = {}
    for t in range(n_micro):
        for s in range(n_stages):
            served.setdefault(s, []).append((t - s) % n_micro)
    for s, mbs in served.items():
        assert sorted(mbs) == list(range(n_micro))
    for m in range(n_micro):
        for s in range(n_stages):
            t = (m + s) % n_micro
            assert (t - s) % n_micro == m
            assert (t < s) == (m + s >= n_micro)


def test_moe_smap_falls_back_without_mesh():
    """Without a mesh the shard_map MoE is ``moe_sorted``, bit for bit, and
    holds to the reference's fallback."""
    context.set_mesh(None, ())
    cfg = dataclasses.replace(REF_SMOKE["qwen2-moe-a2.7b"],
                              n_shared_experts=0, capacity_factor=2.0)
    p = init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    tp = map_params(lambda a: torch.from_numpy(np.array(a)), p)
    y1, _ = moe_sorted(tp, cfg, torch.from_numpy(x))
    y2, _ = moe_sorted_smap(tp, cfg, torch.from_numpy(x))
    assert torch.equal(y1, y2)
    yr, _ = ref_smap(p, cfg, jnp.asarray(x))
    np.testing.assert_allclose(y2.numpy(), np.asarray(yr), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        y2.numpy(), np.asarray(ref_sorted(p, cfg, jnp.asarray(x))[0]),
        rtol=1e-5, atol=1e-5)


def test_mesh_layouts_and_production_mesh_raise_at_the_wrong_world():
    """The production layouts are the reference's shapes; a production
    mesh needs 256 (512) ranks and raises, naming the layout, otherwise;
    ``make_mesh`` needs a running process group, and on ``cuda`` NCCL."""
    single, multi = MeshLayout.production(), MeshLayout.production(True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.sizes == MULTI_POD and single.sizes == SINGLE_POD
    assert MeshLayout.of(2, 2).axis_names == ("data", "model")
    assert MeshLayout.of(2, 2, pod=2).axis_names == ("pod", "data", "model")
    for multi_pod in (False, True):
        with pytest.raises(ValueError, match="MeshLayout.production"):
            make_production_mesh(multi_pod=multi_pod, device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(1, 1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(1, 1)


def test_cuda_mesh_refuses_gloo(gloo_one, monkeypatch):
    """A ``cuda`` mesh over a gloo group raises: no fallback to gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="needs the nccl backend"):
        make_mesh(1, 1, device="cuda")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh(2, 2, device="cpu")
    assert gloo_one.mesh_dim_names == ("data", "model")


@pytest.mark.parametrize("pid,count,want", [
    (None, None, "trace.jsonl"), ("3", "4", "trace.p3.jsonl"),
    ("0", "1", "trace.jsonl")])
def test_fleet_session_shard_paths(monkeypatch, tmp_path, pid, count, want):
    """``fleet_session`` tags its session with the process and writes at
    the per-process shard path, as the reference's."""
    for var, val in (("REPRO_PROCESS_ID", pid),
                     ("REPRO_PROCESS_COUNT", count)):
        if val is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, val)
    sess, path = fleet_session("t", str(tmp_path / "trace.jsonl"))
    assert path == str(tmp_path / want)
    assert sess.tags["process"] == int(pid or 0)
    assert fleet_session("t")[1] is None


def test_shard_map_and_collectives_on_one_rank(gloo_one):
    """On a one-rank mesh each block is the whole tensor (a view where it
    is contiguous), the collectives are the identity, a self-pair ppermute
    copies, and out-specs reassemble the blocks; collectives refuse to run
    outside a body."""
    mesh = gloo_one
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert local_shard(x, P("data", None, "model"), mesh).data_ptr() == \
        x.data_ptr()

    def body(a, b):
        assert context.axis_index("data") == context.axis_index("model") == 0
        s = context.psum(a * 1, ("data", "model"))
        m = context.pmax(a * 1, "model")
        g = context.all_gather(b, "model", dim=1, tiled=True)
        st = context.all_gather(b, "data", dim=0, tiled=False)
        r = context.ppermute(b, "data", [(0, 0)])
        z = context.ppermute(b, "data", [])
        return s, m, g, st, r, z

    s, m, g, st, r, z = shard_map(
        body, mesh, in_specs=(P("data"), P(None, "model")),
        out_specs=(P("data"), P(), P(), P(), P(None, "model"), P()))(x, x)
    for t in (s, m, g, r):
        assert torch.equal(t, x)
    assert torch.equal(st, x[None]) and torch.equal(z, torch.zeros_like(x))
    with pytest.raises(RuntimeError, match="inside a shard_map body"):
        context.psum(x, "model")


def test_pp_decoder_checks_the_reference_checks():
    """Dense/vlm only, and the local Q-head block must map to one KV
    group, as the reference's ``__post_init__`` asserts."""
    layout = MeshLayout.of(2, 2)
    with pytest.raises(ValueError, match="dense LMs"):
        PPDecoder(SMOKE_ARCHS["qwen2-moe-a2.7b"], layout)
    cfg = dataclasses.replace(SMOKE_ARCHS["llama3-405b"], n_heads=6,
                              n_kv_heads=2)
    with pytest.raises(ValueError, match="one KV group"):
        PPDecoder(cfg, MeshLayout.of(1, 3))
    PPDecoder(cfg, MeshLayout.of(1, 2))
    PPDecoder(SMOKE_ARCHS["llava-next-34b"], layout)


@pytest.mark.parametrize("arch,multi_pod,T", [
    ("llama3-405b", False, 1), ("llama3-405b", True, 4),
    ("gemma-2b", False, 1), ("qwen3-8b", False, 2)])
def test_pp_specs_match_the_reference(arch, multi_pod, T):
    """``param_specs`` and ``state_specs`` of the production PP layout
    equal the reference's, leaf for leaf (the reference's mesh duck-typed,
    as ``tests/test_sharding.py`` does)."""
    layout = MeshLayout.production(multi_pod)
    cfg = resolve(ARCHS[arch], model_axis=layout.shape["model"])
    pp = PPDecoder(cfg, layout, tokens_per_launch=T)
    ref = RefPPDecoder(cfg, layout, tokens_per_launch=T)
    got = pp.param_specs()
    want = ref.param_specs()

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for key in tree
                    for k, v in flat(tree[key], f"{prefix}{key}/").items()}
        return {prefix[:-1]: tuple(tree)}

    assert flat(got) == flat(want)
    assert {k: tuple(v) for k, v in pp.state_specs().items()} == \
        {k: tuple(v) for k, v in ref.state_specs().items()}
    assert (pp.n_stages, pp.layers_per_stage, pp.n_virtual) == \
        (ref.n_stages, ref.layers_per_stage, ref.n_virtual)


def test_params_and_state_from_lm_share_or_pad():
    """``params_from_lm`` stacks the LM's layers as views (no copy) where
    they divide into the stages, zero-pads a virtual layer otherwise, and
    marks it invalid; ``state_from_lm`` shares the cache and length."""
    cfg = dataclasses.replace(SMOKE_ARCHS["gemma-2b"], n_layers=3)
    lm = TransformerLM(cfg, device="cpu")
    params = lm.init_params(0)
    pp = PPDecoder(cfg, MeshLayout.of(3, 1))
    stacked = pp.params_from_lm(params)
    wq = stacked["layers"]["attn"]["wq"]
    assert wq.shape == (3, 1) + params["layers"]["attn"]["wq"].shape[1:]
    assert wq.data_ptr() == params["layers"]["attn"]["wq"].data_ptr()
    assert stacked["valid"].all()
    pad = PPDecoder(cfg, MeshLayout.of(2, 1))
    padded = pad.params_from_lm(params)
    assert padded["valid"].tolist() == [[True, True], [True, False]]
    assert torch.equal(padded["layers"]["mlp"]["w_up"][1, 1],
                       torch.zeros_like(padded["layers"]["mlp"]["w_up"][1, 1]))
    assert torch.equal(padded["layers"]["mlp"]["w_up"][1, 0],
                       params["layers"]["mlp"]["w_up"][2])
    state = lm.init_decode_state(3, 8)
    pst = pp.state_from_lm(state)
    assert pst["k"].data_ptr() == state["k"].data_ptr()
    assert pst["length"] is state["length"]
    assert pst["wire"].shape == (3, 1, 1, cfg.d_model)
    with pytest.raises(TypeError, match="specs only"):
        pp.init_state(3, 8)


def _pp_reference(arch: str, T: int, B: int, S: int, n_steps: int):
    cfg = dataclasses.replace(REF_SMOKE[arch], param_dtype="float32")
    ref = RefPPDecoder(cfg, ref_make_mesh(1, 1), tokens_per_launch=T)
    params = ref.init_params(jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (n_steps, B, T), 0,
                              cfg.vocab_size)
    state = ref.init_state(B, S)
    step = jax.jit(ref.make_step(B, S))
    states, logits = [], []
    for n in range(n_steps):
        state, lg = step(params, state, toks[n])
        states.append(jax.tree_util.tree_map(np.asarray, state))
        logits.append(np.asarray(lg))
    return cfg, params, np.asarray(toks), states, logits


@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-8b", "llama3-405b"])
def test_pp_decoder_matches_reference_pp_on_one_rank(gloo_one, arch, T):
    """The port's PP step on a one-rank gloo mesh against the reference's
    on make_mesh(1, 1): the same params (the reference's ``init_params``
    through ``params_from_jax``, its bool ``valid`` included) and tokens;
    logits and k/v/wire/length after each of 3 launches within 1e-4."""
    B, S, n_steps = 4, 16, 3
    cfg, params, toks, states, logits = _pp_reference(arch, T, B, S, n_steps)
    pp = PPDecoder(cfg, gloo_one, tokens_per_launch=T)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              cfg, device="cpu")
    assert tparams["valid"].dtype == torch.bool and tparams["valid"].all()
    state = pp.init_state(B, S)
    step = pp.make_step(B, S)
    for n in range(n_steps):
        state, lg = step(tparams, state, torch.from_numpy(np.array(toks[n])))
        np.testing.assert_allclose(lg.numpy(), logits[n], rtol=PP_TOL,
                                   atol=PP_TOL)
        for key in ("k", "v", "wire"):
            np.testing.assert_allclose(state[key].numpy(), states[n][key],
                                       rtol=PP_TOL, atol=PP_TOL)
        assert int(state["length"]) == int(states[n]["length"]) == (n + 1) * T


def test_chip_smoke_phase_m_rehearsal(monkeypatch):
    """Phase M's control flow on the CPU at smoke size: a one-rank gloo
    group for NCCL, gemma-smoke and llama3-smoke (2 layers, a seeded cache)
    through the PP launch at T=1 and T=4 against the sequential decode
    (direct calls here, graph replays on the card), the fp32 copy, the
    shard_map MoE's equality and the rules.  The graph decoder's checks and
    the timers are stubbed (the op-level stream and its roofline are not);
    launch counts are 0 on the CPU."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from repro_torch.core import CommandStreamCapture, analyze

    def graph_checks(card, label, cfg, step, weight_b, n, B, T):
        c = CommandStreamCapture().capture_compiled(label, step)
        return {"nodes": c.n_ops, "copy_bytes": 0,
                "report": analyze(c, chips=1, model_flops_total=2 * n * B * T,
                                  name=label)}

    lines = []
    monkeypatch.setattr(cs, "ARCHS", dict(SMOKE_ARCHS))
    monkeypatch.setattr(cs, "M_PATHS", {
        "gemma-2b": {"n_layers": None, "batch": 4, "max_seq": 32,
                     "prompt": 8},
        "llama3-405b": {"n_layers": 2, "batch": 4, "max_seq": 32,
                        "length": 16}})
    monkeypatch.setattr(cs, "M_LAUNCHES", {1: 4, 4: 1})
    monkeypatch.setattr(cs, "M_FP32", {"arch": "gemma-2b", "n_layers": 2,
                                       "launches": {1: 2, 4: 1}})
    monkeypatch.setattr(cs, "M_MOE_SHAPE", (2, 16))
    monkeypatch.setattr(cs, "log", lines.append)
    monkeypatch.setattr(cs, "time_ms", lambda fn, reps=20, warmup=3: (
        fn(), 1.0)[1])
    monkeypatch.setattr(cs, "pp_graph_checks", graph_checks)
    counts = cs.mesh_path("cpu", torch.device("cpu"))
    assert set(counts) == {"M1 gemma-2b pp", "M2 llama3-405b pp"}
    assert all(c == {} for by_T in counts.values() for c in by_T.values())
    for label in ("M1 gemma-2b pp", "M2 llama3-405b pp",
                  "M1 gemma-2b pp fp32"):
        for T, n in ((1, 4 if "fp32" not in label else 2), (4, 1)):
            assert any(x.startswith(f"{label} T={T}: {n} launches of {T} "
                                    f"tokens, {n} doorbells") for x in lines)
    assert sum("against the sequential decode's" in x for x in lines) == 6
    assert sum("against the sequential cache's" in x for x in lines) == 6
    assert any("M3 moe_sorted_smap" in x and "bit-equal" in x
               and "NOT" not in x for x in lines)
    assert any(x.startswith("M4: every rule") for x in lines)
    assert sum(x.startswith("cpu | roofline M") for x in lines) == 4
    assert not dist.is_initialized()


def _chip_smoke():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def test_chip_smoke_held_logits_counts_ties_and_fails_a_wrong_token(
        monkeypatch):
    """Phase M's logits check: a flip at a gap under 4 row-RMS of the two
    routes' difference is a counted near-tie; a planted wrong token (a
    logit far below the top made the PP argmax) fails, as does any flip
    in fp32."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "log", lambda line: None)
    g = torch.Generator().manual_seed(0)
    want = torch.randn(2, 3, 1000, generator=g) * 4
    got = want + 1e-2 * torch.randn(2, 3, 1000, generator=g)
    top = want[0, 0].argmax()
    other = (top + 1) % 1000
    want[0, 0, other] = want[0, 0, top] - 5e-3     # a near-tie the noise
    got[0, 0, other] = got[0, 0, top] + 5e-3       # flips
    res = cs.held_logits("t", [got], [want], 3e-2, exact=False)
    assert res["flips"] == 1 and res["near_ties"] == 1
    with pytest.raises(AssertionError, match="argmax differ"):
        cs.held_logits("t", [got], [want], 3e-2, exact=True)
    wrong = got.clone()
    low = want[1, 2].argmin()
    wrong[1, 2, low] = wrong[1, 2].max() + 1.0     # a wrong token
    with pytest.raises(AssertionError, match="1 of them near-ties"):
        cs.held_logits("t", [wrong], [want], 3e-2, exact=False)


def test_chip_smoke_held_cache_fails_a_skipped_or_stray_row(monkeypatch):
    """Phase M's cache check: the window both paths wrote within the
    tolerance, all else untouched; a skipped write (the base row left) or
    a write one row past the window fails."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "log", lambda line: None)
    g = torch.Generator().manual_seed(0)
    L, B, S, H, hd, lo, n = 2, 2, 16, 1, 4, 8, 4
    base = {k: torch.randn(L, B, S, H, hd, generator=g) for k in ("k", "v")}
    base["length"] = torch.tensor(lo, dtype=torch.int32)
    seq = {k: t.clone() for k, t in base.items()}
    for k in ("k", "v"):
        seq[k][:, :, lo:lo + n] = torch.randn(L, B, n, H, hd, generator=g)
    pp = {k: seq[k] + 1e-4 * (torch.arange(S) >= lo).float()[:, None, None]
          * (torch.arange(S) < lo + n).float()[:, None, None]
          for k in ("k", "v")}
    assert cs.held_cache("t", pp, seq, base, n, 3e-2) < 1e-3
    skipped = {k: t.clone() for k, t in pp.items()}
    skipped["v"][1, :, lo + 2] = base["v"][1, :, lo + 2]
    with pytest.raises(AssertionError, match="v rows 8..12 of layer 1"):
        cs.held_cache("t", skipped, seq, base, n, 3e-2)
    stray = {k: t.clone() for k, t in pp.items()}
    stray["k"][0, :, lo + n] += 1.0
    with pytest.raises(AssertionError, match="outside the written window"):
        cs.held_cache("t", stray, seq, base, n, 3e-2)
