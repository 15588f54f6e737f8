"""The port's paged KV backend and chunked prefill against the JAX reference.

``runtime/kv.py``'s ``PagedKV`` and ``DenseKV(prefill_chunk>0)``, the
engine's chunked admission, and the plain ops under them
(``extend_attention``, ``gather_block_table``, ``scatter_block_rows``,
``TransformerLM.prefill_extend``), each held against the reference on the
same numpy inputs or the same seeded workload, with the reference's params
(``weights.params_from_jax``).  Engines run gemma-smoke in fp32, where
tokens must equal the reference engine's in the same mode.  The
reference's KV cases (``tests/test_kv.py``) run on the port; its wall-clock
pacing test becomes a count of launches.

Tolerances: fp32 1e-6 (the plain ops) and 1e-5 (a model's logits through
several layers), bf16 2e-2.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as REF_SMOKE
from repro.configs.shapes import SERVE_SHAPES as REF_SERVE_SHAPES
from repro.configs.shapes import kv_geometry as ref_kv_geometry
from repro.core.session import TraceSession as RefSession
from repro.models.attention import extend_attention as ref_extend_attention
from repro.models.attention import gather_block_table as ref_gather
from repro.models.attention import scatter_block_rows as ref_scatter
from repro.models.transformer import TransformerLM as RefLM
from repro.obs.profile import SpanProfile as RefSpanProfile
from repro.runtime.server import ContinuousBatchingServer as RefEngine
from repro.runtime.server import Request as RefRequest
from repro.runtime.traffic import TrafficSpec as RefSpec
from repro.runtime.traffic import generate as ref_generate
from repro.runtime.traffic import replay as ref_replay
from repro_torch.configs import SERVE_SHAPES, SMOKE_ARCHS, kv_geometry
from repro_torch.core.session import SPAN_EVENT, TraceSession
from repro_torch.launch import serve
from repro_torch.models.attention import (extend_attention, extend_positions,
                                          gather_block_table,
                                          scatter_block_rows)
from repro_torch.models.layers import layer_params
from repro_torch.models.transformer import TransformerLM
from repro_torch.obs.profile import SpanProfile
from repro_torch.runtime.scheduler import RequestTicket
from repro_torch.runtime.server import ContinuousBatchingServer, Request
from repro_torch.runtime.traffic import TrafficSpec, generate, replay
from repro_torch.weights import params_from_jax

REF_CFG = dataclasses.replace(REF_SMOKE["gemma-2b"], param_dtype="float32")
CFG = dataclasses.replace(SMOKE_ARCHS["gemma-2b"], param_dtype="float32")
# tests/test_kv.py's workload and engine
SPEC = dict(n_requests=10, rate=1000.0, prompt_lens=(4, 8, 16),
            new_tokens=(4, 9), seed=3)
ENGINE = dict(batch_size=4, max_seq=64, tokens_per_launch=4)
# benchmarks/bench_kv.py's spec, engine and modes, and BENCH_10's kv rows
KV_SPEC = dict(n_requests=8, rate=1000.0, prompt_lens=(4, 8),
               new_tokens=(5, 9), seed=0, prefix_len=24)
KV_MODES = {"dense_chunk8": dict(kv="dense", prefill_chunk=8),
            "paged_pt8_chunk8": dict(kv="paged", kv_page_tokens=8,
                                     prefill_chunk=8)}
BENCH_10 = {  # requests, new tokens, doorbells, prefill doorbells and
    # payload, pages allocated / peak / reused, prefix hits
    "dense_chunk8": (8, 56, 43, 32, 960, 0, 0, 0, 0),
    "paged_pt8_chunk8": (8, 56, 29, 20, 576, 26, 17, 12, 4)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread a worker, as in test_torch_continuous.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def ref_params(arch="gemma-2b", dtype="float32"):
    cfg = dataclasses.replace(REF_SMOKE[arch], param_dtype=dtype)
    return RefLM(cfg).init_params(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def port_params():
    """The reference engine's params (seed 0), converted for the port."""
    return params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params()),
                           CFG, "cpu")


def port_engine(session=None, **kw):
    return ContinuousBatchingServer(CFG, device="cpu", params=port_params(),
                                    session=session, **kw)


def ref_engine(session=None, **kw):
    return RefEngine(REF_CFG, seed=0, session=session, **kw)


def run_both(requests, **kw):
    """The same requests (``(uid, prompt, budget)``) through the reference
    engine and the port's, synchronously: both engines and their tokens by
    uid."""
    out = []
    for engine, request in ((ref_engine, RefRequest), (port_engine, Request)):
        eng = engine(**kw)
        tix = [eng.submit(request(uid=u, prompt=p, max_new_tokens=b))
               for u, p, b in requests]
        eng.run(idle_timeout_s=0.0)
        out.append((eng, {t.uid: list(t.tokens) for t in tix}))
    return out


@functools.lru_cache(maxsize=None)
def spec_run(which, spec_items, engine_items):
    """One synchronous replay of a traffic spec: (engine, tickets,
    metrics) of the reference (``which="ref"``) or the port."""
    spec, kw = dict(spec_items), dict(engine_items)
    if which == "ref":
        eng = ref_engine(session=RefSession(name="kv"), **kw)
        tickets, m = ref_replay(eng, ref_generate(RefSpec(**spec),
                                                  REF_CFG.vocab_size),
                                realtime=False)
    else:
        eng = port_engine(session=TraceSession(name="kv"), **kw)
        tickets, m = replay(eng, generate(TrafficSpec(**spec),
                                          CFG.vocab_size), realtime=False)
    return eng, tickets, m


def both_spec(spec, **kw):
    key = (tuple(sorted(spec.items())), tuple(sorted(kw.items())))
    return spec_run("ref", *key), spec_run("port", *key)


def tokens(tickets):
    return {t.uid: list(t.tokens) for t in tickets}


def payload_by_name(session):
    out = {}
    for e in session.timeline(kinds="dispatch"):
        n, b = out.get(e.name, (0, 0))
        out[e.name] = (n + 1, b + e.payload_bytes)
    return out


def kv_events(session):
    return [(e.name, e.payload_bytes) for e in session.timeline(
        kinds="progress") if e.name.startswith("kv.")]


def request_attribution(profile):
    req = profile.snapshot()["spans"]["serve.request"]
    return {k: req[k] for k in ("spans", "doorbells", "payload_bytes",
                                "graph_launches")}


def rand_tokens(rng, n):
    return rng.integers(0, CFG.vocab_size, n).astype(np.int32)


# -- geometry ---------------------------------------------------------------

def test_kv_geometry_and_serve_shapes_equal_reference():
    for args in [(64, 16, 4), (64, 8, 4), (4096, 64, 64), (32768, 128, 16),
                 (64, 64, 1)]:
        assert kv_geometry(*args) == ref_kv_geometry(*args)
    assert kv_geometry(64, 16, 4) == (4, 16)
    with pytest.raises(ValueError, match="multiple"):
        kv_geometry(64, 24, 4)
    with pytest.raises(ValueError, match="positive"):
        kv_geometry(64, 0, 4)
    assert {k: dataclasses.asdict(v) for k, v in SERVE_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SERVE_SHAPES.items()}
    for shape in SERVE_SHAPES.values():
        n_blk, pages = shape.geometry()
        assert (n_blk, pages) == REF_SERVE_SHAPES[shape.name].geometry()
        assert n_blk * shape.kv_page_tokens == shape.max_seq
        assert pages == shape.slots * n_blk


# -- the plain ops ----------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("start", [0, 7, 14])
@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-8b"])
def test_extend_attention_matches_reference(arch, start, dtype, tol):
    """A 5-token chunk at ``start`` of a 16-row cache: out and both caches
    equal the reference's; at start 14 the write clamps to rows 11-15 while
    rope and mask keep positions 14-18."""
    cfg = dataclasses.replace(SMOKE_ARCHS[arch], param_dtype=dtype)
    ref_cfg = dataclasses.replace(REF_SMOKE[arch], param_dtype=dtype)
    params = ref_params(arch, dtype)
    p_ref = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["attn"])
    p = layer_params(params_from_jax(jax.tree_util.tree_map(
        np.asarray, params), cfg, "cpu")["layers"], 0)["attn"]
    B, C, S = 2, 5, 16
    rng = np.random.default_rng(start)
    x = rng.standard_normal((B, C, cfg.d_model)).astype(np.float32)
    k = rng.standard_normal((B, S, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    want, want_k, want_v = ref_extend_attention(
        p_ref, ref_cfg, jnp.asarray(x, jdt), jnp.asarray(k, jdt),
        jnp.asarray(v, jdt), jnp.asarray(start, jnp.int32))
    kt = torch.from_numpy(k).to(tdt)
    vt = torch.from_numpy(v).to(tdt)
    got = extend_attention(p, cfg, torch.from_numpy(x).to(tdt), kt, vt,
                           extend_positions(cfg, torch.tensor(
                               start, dtype=torch.int32), C, S))
    for mine, theirs in ((got, want), (kt, want_k), (vt, want_v)):
        np.testing.assert_allclose(mine.float().numpy(),
                                   np.asarray(theirs, np.float32),
                                   rtol=tol, atol=tol)


def paged_inputs(seed, L=2, P=9, pt=4, Hk=2, hd=8, n_blk=4):
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((L, P, pt, Hk, hd)).astype(np.float32)
    table = rng.permutation(np.arange(1, P))[:n_blk].astype(np.int32)
    return rng, pool, table


def test_gather_block_table_matches_reference():
    rng, pool, table = paged_inputs(0)
    want = np.asarray(ref_gather(jnp.asarray(pool), jnp.asarray(table)))
    got = gather_block_table(torch.from_numpy(pool), torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), want)
    # B tables at once, into a fixed buffer, equal the reference slot by slot
    tables = np.stack([table, table[::-1], np.zeros_like(table)])
    out = torch.full((2, 3, 16, 2, 8), float("nan"))
    assert gather_block_table(torch.from_numpy(pool),
                              torch.from_numpy(tables), out=out) is out
    for b, t in enumerate(tables):
        np.testing.assert_array_equal(out[:, b].numpy(), np.asarray(
            ref_gather(jnp.asarray(pool), jnp.asarray(t)))[:, 0])


@pytest.mark.parametrize("start,n", [(0, 4), (5, 6), (13, 6), (15, 3)])
def test_scatter_block_rows_matches_reference(start, n):
    """Rows at start..start+n-1 of a 16-position table; with start + n > 16
    the positions clamp to 15 and the last row wins, as in the reference's
    loop."""
    rng, pool, table = paged_inputs(start)
    rows = rng.standard_normal((2, n, 2, 8)).astype(np.float32)
    want = np.asarray(ref_scatter(jnp.asarray(pool), jnp.asarray(table),
                                  jnp.asarray(rows),
                                  jnp.asarray(start, jnp.int32)))
    got = torch.from_numpy(pool.copy())
    scatter_block_rows(got, torch.from_numpy(table), torch.from_numpy(rows),
                       torch.tensor(start, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)
    if start + n > 16:
        page, off = table[3], 3
        np.testing.assert_array_equal(got.numpy()[:, page, off],
                                      rows[:, n - 1])


def test_scatter_block_rows_batched_equals_reference_slot_by_slot():
    rng, pool, _ = paged_inputs(3, P=13)
    tables = rng.permutation(np.arange(1, 13)).reshape(3, 4).astype(np.int32)
    starts = np.array([0, 9, 14], np.int32)
    rows = rng.standard_normal((2, 3, 4, 2, 8)).astype(np.float32)
    want = jnp.asarray(pool)
    for b in range(3):
        want = ref_scatter(want, jnp.asarray(tables[b]),
                           jnp.asarray(rows[:, b]), jnp.asarray(starts[b]))
    got = torch.from_numpy(pool.copy())
    scatter_block_rows(got, torch.from_numpy(tables), torch.from_numpy(rows),
                       torch.from_numpy(starts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-8b"])
def test_prefill_extend_chunks_match_reference(arch):
    """Three chunks (5, 4, 3 tokens) extend a fresh state: each chunk's
    logits, the caches and the length equal the reference's in fp32."""
    cfg = dataclasses.replace(SMOKE_ARCHS[arch], param_dtype="float32")
    ref_cfg = dataclasses.replace(REF_SMOKE[arch], param_dtype="float32")
    params = ref_params(arch)
    ref_model, model = RefLM(ref_cfg), TransformerLM(cfg, device="cpu")
    mine = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg,
                           "cpu")
    prompt = np.random.default_rng(4).integers(
        0, cfg.vocab_size, 12).astype(np.int32)
    ref_state = ref_model.init_decode_state(1, 32)
    state = model.init_decode_state(1, 32)
    pos = 0
    for c in (5, 4, 3):
        chunk = prompt[None, pos:pos + c]
        ref_state, want = ref_model.prefill_extend(params, ref_state,
                                                   jnp.asarray(chunk))
        state, got = model.prefill_extend(mine, state,
                                          torch.from_numpy(chunk))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        pos += c
    for key in ("k", "v"):
        np.testing.assert_allclose(state[key].numpy(),
                                   np.asarray(ref_state[key]),
                                   rtol=1e-5, atol=1e-5)
    assert int(state["length"]) == int(ref_state["length"]) == 12


# -- backend equivalence ----------------------------------------------------

def test_paged_tokens_equal_dense_and_reference():
    (_, ref_tix, ref_m), (_, tix, m) = both_spec(SPEC, kv="paged",
                                                 kv_page_tokens=8, **ENGINE)
    (_, _, _), (_, dense_tix, dense_m) = both_spec(SPEC, **ENGINE)
    assert tokens(tix) == tokens(ref_tix) == tokens(dense_tix)
    assert m["kv"]["backend"] == "paged"
    # default pool holds every slot fully grown: exhaustion impossible
    assert m["kv"]["pages_total"] == 4 * (64 // 8)
    assert m["evicted"] == dense_m["evicted"] == ref_m["evicted"]
    assert m["kv"] == ref_m["kv"]


@pytest.mark.parametrize("kv", [dict(kv="dense"),
                                dict(kv="paged", kv_page_tokens=8)],
                         ids=["dense", "paged"])
def test_chunked_prefill_equals_reference_both_backends(kv):
    (ref, ref_tix, ref_m), (eng, tix, m) = both_spec(
        SPEC, prefill_chunk=4, **kv, **ENGINE)
    assert tokens(tix) == tokens(ref_tix)
    assert m["kv"]["chunked_prompts"] > 0
    assert m["kv"]["prefill_chunk_launches"] > 0
    assert m["kv"] == ref_m["kv"]
    assert m["doorbells"] == ref_m["doorbells"]
    assert payload_by_name(eng.session) == payload_by_name(ref.session)


# -- page exhaustion --------------------------------------------------------

def test_page_exhaustion_evicts_with_kv_pages_reason():
    rng = np.random.default_rng(0)
    reqs = [(i, rand_tokens(rng, 20), 30) for i in range(4)]
    (ref, ref_toks), (eng, toks) = run_both(
        reqs, batch_size=4, max_seq=64, tokens_per_launch=2, kv="paged",
        kv_page_tokens=8, kv_pages=9)
    tix = eng.tickets
    assert all(t.finished for t in tix)
    evicted = [t for t in tix if t.status == "evicted"]
    assert evicted and all(t.reason == "kv_pages" for t in evicted)
    # survivors ran to their full budget untouched by the eviction
    assert any(t.status == "done" and len(t.tokens) == 30 for t in tix)
    assert toks == ref_toks
    assert [(t.status, t.reason) for t in tix] == \
        [(t.status, t.reason) for t in ref.tickets]


def test_pool_smaller_than_one_slot_rejected():
    with pytest.raises(ValueError, match="full slot"):
        port_engine(batch_size=4, max_seq=64, tokens_per_launch=2,
                    kv="paged", kv_page_tokens=8, kv_pages=4)


def test_explicit_zero_page_tokens_rejected():
    # an explicit 0 must reach kv_geometry's validation, not silently
    # coerce to the default
    with pytest.raises(ValueError, match="positive"):
        port_engine(batch_size=1, max_seq=64, tokens_per_launch=2,
                    kv="paged", kv_page_tokens=0)


@pytest.mark.parametrize("kw", [dict(kv="paged"), dict(prefill_chunk=4)],
                         ids=["paged", "chunked"])
def test_mamba2_refuses_paged_and_chunked_as_reference(kw):
    with pytest.raises(ValueError, match="prefill_extend") as mine:
        ContinuousBatchingServer(SMOKE_ARCHS["mamba2-780m"], batch_size=1,
                                 max_seq=32, device="cpu", **kw)
    with pytest.raises(ValueError) as theirs:
        RefEngine(REF_SMOKE["mamba2-780m"], batch_size=1, max_seq=32,
                  tokens_per_launch=1, **kw)
    assert str(mine.value) == str(theirs.value)


# -- shared-prefix page reuse -----------------------------------------------

def shared_prefix_requests(n=8, prefix_len=24, suffix_len=8, budget=6):
    rng = np.random.default_rng(0)
    prefix = rand_tokens(rng, prefix_len)
    return [(uid, np.concatenate([prefix, rand_tokens(rng, suffix_len)]),
             budget) for uid in range(n)]


def test_shared_prefix_reuses_pages_and_shrinks_prefill():
    common = dict(batch_size=4, max_seq=64, tokens_per_launch=2,
                  prefill_chunk=8)
    (_, ref_dense), (dense, d_toks) = run_both(shared_prefix_requests(),
                                               **common)
    (ref, ref_toks), (eng, p_toks) = run_both(
        shared_prefix_requests(), kv="paged", kv_page_tokens=8, **common)
    assert p_toks == d_toks == ref_toks == ref_dense  # reuse keeps the bits
    kv, d_kv = eng.kv.stats(), dense.kv.stats()
    assert kv == ref.kv.stats()
    assert kv["prefix_hits"] > 0 and kv["pages_reused"] > 0
    # strictly fewer prefill doorbells AND prefill payload bytes than dense
    assert kv["prefill_launches"] < d_kv["prefill_launches"]
    assert kv["prefill_payload_bytes"] < d_kv["prefill_payload_bytes"]
    names = [name for name, _ in kv_events(eng.session)]
    assert names.count("kv.prefix_hit") == kv["prefix_hits"]
    assert "kv.alloc" in names and "kv.free" in names
    assert kv_events(eng.session) == kv_events(ref.session)


def test_shared_prefix_pinned_under_pool_pressure():
    """Shared prefix pages are pinned *before* fresh pages are allocated: a
    refcount-0 shared page sits in the reclaimable cache, and reclaiming it
    as a prefill target of the very request attaching to it would put one
    physical page twice in the block table."""
    eng = port_engine(batch_size=1, max_seq=64, tokens_per_launch=2,
                      kv="paged", kv_page_tokens=8, kv_pages=8)
    rng = np.random.default_rng(7)
    prefix = rand_tokens(rng, 24)
    # A fills the whole 8-page pool (4-page prompt + decode growth to the
    # cap), then releases: its 4 prompt pages stay cached, 4 go free
    eng.submit(Request(uid=0, prompt=np.concatenate([prefix,
                                                     rand_tokens(rng, 8)]),
                       max_new_tokens=31))
    eng.run(idle_timeout_s=0.0)
    kv = eng.kv
    assert len(kv._cached) == 4 and len(kv._free) == 4
    # B shares the 3-page prefix and needs 5 fresh pages, one more than
    # the free list holds: a reclaim while the shared pages sit at ref 0
    b = RequestTicket(request=Request(
        uid=1, prompt=np.concatenate([prefix, rand_tokens(rng, 40)]),
        max_new_tokens=1))
    assert kv.begin(0, b)
    table = kv.tables[0, :int(kv.n_rows[0])].tolist()
    assert len(set(table)) == len(table)      # no physical page twice
    assert all(kv._ref[p] == 1 for p in table)
    assert kv.pages_reused == 3
    # rollback: free list exhausted and every reclaimable page pinned as
    # shared prefix: begin fails AND undoes its pins
    kv.release(0)
    kv._free.clear()
    c = RequestTicket(request=Request(
        uid=2, prompt=np.concatenate([prefix, rand_tokens(rng, 40)]),
        max_new_tokens=1))
    assert not kv.begin(0, c)
    assert len(kv._cached) == 3
    assert all(kv._ref[p] == 0 for p in kv._cached)


def pressure_requests():
    prefix = rand_tokens(np.random.default_rng(11), 24)
    r = np.random.default_rng(13)
    return [(0, np.concatenate([prefix, rand_tokens(r, 8)]), 31),
            (1, np.concatenate([prefix, rand_tokens(r, 40)]), 1),
            (2, np.concatenate([prefix, rand_tokens(r, 8)]), 4)]


@pytest.mark.parametrize("prefill_chunk", [0, 8])
def test_shared_prefix_under_pressure_tokens_match_dense(prefill_chunk):
    """Prefix sharing and pool pressure together keep dense's tokens, with
    and without chunks."""
    common = dict(batch_size=1, max_seq=64, tokens_per_launch=2,
                  prefill_chunk=prefill_chunk)
    (_, ref_dense), (_, d_toks) = run_both(pressure_requests(), **common)
    (ref, ref_toks), (eng, p_toks) = run_both(
        pressure_requests(), kv="paged", kv_page_tokens=8, kv_pages=8,
        **common)
    assert p_toks == d_toks == ref_toks == ref_dense
    assert eng.kv.prefix_hits == ref.kv.prefix_hits == 2
    assert all(t.status == "done" for t in eng.tickets)


def test_no_registration_in_clamped_decode_write_zone():
    """Pages overlapping [max_seq - T, max_seq) are never registered for
    sharing: a slot finishing at the KV cap scatter-writes its clamped
    decode rows there, and registered pages stay immutable once shared.
    The follower attaches after A's capped finish (its last decode launch
    writes rows 56-63), so a scatter one row off would change its tokens."""
    rng = np.random.default_rng(21)
    base = rand_tokens(rng, 60)
    ext = rand_tokens(rng, 4)
    reqs = [(0, base, 5), (1, np.concatenate([base, ext]), 1)]
    common = dict(batch_size=1, max_seq=64, tokens_per_launch=8)
    (_, ref_dense), (_, d_toks) = run_both(reqs, **common)
    (_, ref_toks), (eng, p_toks) = run_both(reqs, kv="paged",
                                            kv_page_tokens=4, **common)
    assert p_toks == d_toks == ref_toks == ref_dense
    # A's 60-token prompt fully covers 15 pages, but page 14 spans [56, 60)
    # inside the clamp zone [56, 64): only 14 get registered
    assert len(eng.kv._key_of) == 14
    assert eng.kv.prefix_hits == 1 and eng.kv.pages_reused == 14


@pytest.mark.parametrize("kw", [
    dict(prefill_chunk=8), dict(kv="paged", kv_page_tokens=4),
    dict(kv="paged", kv_page_tokens=4, prefill_chunk=8)],
    ids=["dense_chunk8", "paged_pt4", "paged_pt4_chunk8"])
def test_cache_rows_equal_dense_after_a_capped_finish(kw):
    """A 60-token prompt finishing at the KV cap (its one decode launch at
    length 60 writes rows 56-63, clamped): all 64 cache rows of the request
    (paged: its pages, through its block table) equal whole-prompt dense's,
    and the paged backend's 14 registered pages are its first 14.  Token
    streams alone cannot show a row written one off: the smoke model's
    greedy tokens barely depend on the cache."""
    prompt = rand_tokens(np.random.default_rng(21), 60)
    common = dict(batch_size=1, max_seq=64, tokens_per_launch=8)
    dense, eng = port_engine(**common), port_engine(**kw, **common)
    kv, tables = eng.kv, []
    if kv.name == "paged":             # the block table, as it is released
        release = kv.release

        def keep_table(slot):
            tables.append(torch.from_numpy(kv.tables[slot].copy()))
            release(slot)
        kv.release = keep_table
    for e in (dense, eng):
        t = e.submit(Request(uid=0, prompt=prompt, max_new_tokens=5))
        e.run(idle_timeout_s=0.0)
        assert t.status == "done" and t.cap == 5
    assert dense.tickets[0].tokens == eng.tickets[0].tokens
    for key in ("k", "v"):
        if kv.name == "paged":
            got = gather_block_table(getattr(kv, f"{key}_pool"), tables[0])
        else:
            got = kv.slots[key]
        np.testing.assert_allclose(got[:, 0].numpy(),
                                   dense.kv.slots[key][:, 0].numpy(),
                                   rtol=1e-5, atol=1e-5)
    if kv.name == "paged":
        assert sorted(kv._key_of) == sorted(tables[0][:14].tolist())


# -- chunked prefill pacing -------------------------------------------------

def test_chunked_prefill_bounds_launch_size_and_interleaves():
    sess = TraceSession(name="test_chunk")
    eng = port_engine(session=sess, batch_size=2, max_seq=64,
                      tokens_per_launch=4, prefill_chunk=4)
    rng = np.random.default_rng(1)
    tix = [eng.submit(Request(uid=i, prompt=rand_tokens(rng, 17),
                              max_new_tokens=8)) for i in range(3)]
    eng.run(idle_timeout_s=0.0)
    assert all(t.status == "done" and len(t.tokens) == 8 for t in tix)
    spans = [e for e in sess.timeline() if e.name == SPAN_EVENT]
    chunk_spans = [e for e in spans
                   if e.meta.get("span") == "serve.prefill_chunk"]
    assert chunk_spans and all(e.meta["size"] <= 4 for e in chunk_spans)
    # ceil(17 / 4) launches a prompt, accounted on its ticket
    assert all(t.n_prefill_launches == 5 for t in tix)
    assert any(e.meta.get("span") == "serve.decode_iter" for e in spans)
    assert sorted(eng.graphs()) == ["decode T=4", "extend C=1", "extend C=4"]


def test_chunked_prefill_keeps_decode_iters_flowing():
    """The reference's wall-clock pacing test as a count: while a pinned
    slot (short prompt, long budget) is decoding, chunked 32-token prompts
    stream through the other slot, and no two ``serve.prefill_chunk``
    launches fall between consecutive ``serve.decode_iter`` launches."""
    sess = TraceSession(name="test_gap")
    eng = port_engine(session=sess, batch_size=2, max_seq=64,
                      tokens_per_launch=4, prefill_chunk=4)
    rng = np.random.default_rng(2)
    pin = eng.submit(Request(uid=0, prompt=rand_tokens(rng, 4),
                             max_new_tokens=60))
    for i in range(2):
        eng.submit(Request(uid=1 + i, prompt=rand_tokens(rng, 32),
                           max_new_tokens=12))
    eng.run(idle_timeout_s=0.0)
    assert pin.status == "done"
    seq, pinned = [], False
    for e in sess.timeline():
        if e.kind == "progress" and e.meta.get("uid") == pin.uid:
            if e.name == "serve.admit":
                pinned = True
            elif e.name == "serve.finish":
                break
        elif pinned and e.name == SPAN_EVENT and e.meta.get("span") in (
                "serve.decode_iter", "serve.prefill_chunk"):
            seq.append(e.meta["span"])
    assert seq.count("serve.decode_iter") >= 8
    assert seq.count("serve.prefill_chunk") >= 8    # of 2 prompts' 16
    runs = "".join("c" if s == "serve.prefill_chunk" else "d" for s in seq)
    assert "cc" not in runs, runs


# -- bench_kv's spec: BENCH_10's kv rows --------------------------------------

@pytest.mark.parametrize("mode", list(KV_MODES))
def test_bench_kv_rows_equal_reference(mode):
    (ref, ref_tix, ref_m), (eng, tix, m) = both_spec(
        KV_SPEC, batch_size=4, max_seq=64, tokens_per_launch=4,
        **KV_MODES[mode])
    kv = m["kv"]
    row = (m["requests"], m["new_tokens"], m["doorbells"],
           kv["prefill_launches"], kv["prefill_payload_bytes"],
           kv.get("pages_allocated", 0), kv.get("pages_peak", 0),
           kv.get("pages_reused", 0), kv.get("prefix_hits", 0))
    assert row == BENCH_10[mode]
    assert tokens(tix) == tokens(ref_tix)
    assert kv == ref_m["kv"]
    assert payload_by_name(eng.session) == payload_by_name(ref.session)
    assert set(payload_by_name(eng.session)) == {"prefill_extend",
                                                 "decode_slots"}
    assert kv_events(eng.session) == kv_events(ref.session)
    assert request_attribution(SpanProfile.from_events(
        eng.session.timeline())) == request_attribution(
            RefSpanProfile.from_events(ref.session.timeline()))


def test_bench_kv_paged_tokens_equal_dense():
    (_, _, _), (_, dense, _) = both_spec(
        KV_SPEC, batch_size=4, max_seq=64, tokens_per_launch=4,
        **KV_MODES["dense_chunk8"])
    (_, _, _), (_, paged, _) = both_spec(
        KV_SPEC, batch_size=4, max_seq=64, tokens_per_launch=4,
        **KV_MODES["paged_pt8_chunk8"])
    assert tokens(paged) == tokens(dense)


def test_prompts_within_chunk_keep_the_whole_prompt_graph():
    """Under dense + chunk, prompts no longer than the chunk take the
    whole-prompt ``prefill`` doorbell (the flash kernel on the card), as in
    the reference; longer ones the ``prefill_extend`` chunks."""
    (ref, _, ref_m), (eng, _, m) = both_spec(SPEC, prefill_chunk=8,
                                             **ENGINE)
    by_name = payload_by_name(eng.session)
    assert {"prefill", "prefill_extend", "decode_slots"} == set(by_name)
    assert by_name == payload_by_name(ref.session)
    assert any(k.startswith("prefill S=") for k in eng.graphs())
    assert sorted(k for k in eng.graphs() if k.startswith("extend")) == \
        ["extend C=8"]


# -- the CLI ----------------------------------------------------------------

def test_serve_cli_continuous_paged_chunked_on_cpu(capsys):
    serve.main(["--smoke", "--continuous", "--device", "cpu", "--kv",
                "paged", "--kv-page-tokens", "8", "--prefill-chunk", "4",
                "--requests", "3", "--new-tokens", "4"])
    text = capsys.readouterr().out
    assert "'completed': 3" in text
    assert "'backend': 'paged'" in text and "'page_tokens': 8" in text
    assert "'chunked_prompts': 3" in text


# -- on the card ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(KV_MODES))
def test_bench_kv_on_card_equals_cpu_counts(mode):
    """On a card: bench_kv's spec at smoke size gives the CPU's counts,
    and the decode graph is the one captured when the engine was built."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = SMOKE_ARCHS["gemma-2b"]
    eng = ContinuousBatchingServer(cfg, batch_size=4, max_seq=64,
                                   tokens_per_launch=4, device="cuda",
                                   **KV_MODES[mode])
    graph = eng.graphs()["decode T=4"].graph
    _, m = replay(eng, generate(TrafficSpec(**KV_SPEC), cfg.vocab_size),
                  realtime=False)
    kv = m["kv"]
    assert (m["requests"], m["new_tokens"], m["doorbells"],
            kv["prefill_launches"], kv["prefill_payload_bytes"],
            kv.get("pages_allocated", 0), kv.get("pages_peak", 0),
            kv.get("pages_reused", 0), kv.get("prefix_hits", 0)) == \
        BENCH_10[mode]
    assert eng.graphs()["decode T=4"].graph is graph is not None
