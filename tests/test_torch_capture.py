"""The port's command-stream instruments against the JAX reference's.

``repro_torch.core`` captures a submission unit as a CUDA Graph: an op-level
stream recorded during the step's eager run, and on the card the graph
decoded node by node.  On the CPU the op-level stream's matmul FLOPs must
equal the reference's compute-engine FLOPs (decoded from its compiled HLO)
exactly, on the same seeded weights and inputs; the stream arithmetic, the
collective link bytes, the roofline and its table row must equal the
reference's on the same numbers; each kernel wrapper reports one entry with
its bound's FLOPs and bytes; and the session facade emits the reference's
``compile`` event.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as REF_SMOKE
from repro.core import CommandStreamCapture as RefCapture
from repro.core import TraceSession as RefSession
from repro.core import capture_fn as ref_capture_fn
from repro.core import hlo as ref_hlo
from repro.core import render_submission as ref_render
from repro.core import roofline as ref_roofline
from repro.core.report import render_roofline_row as ref_row
from repro.models import get_model as ref_get_model
from repro_torch import kernels
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.core import (CommandStreamCapture, ExecGraph, TraceSession,
                              capture_fn, graphs, record_ops,
                              render_submission, roofline, stream)
from repro_torch.core.graphs import graph_footprint
from repro_torch.core.report import render_roofline_row
from repro_torch.kernels.dma_copy.ops import dma_copy
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rms_norm.ops import rms_norm
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models import get_model
from repro_torch.runtime.server import Request, Server
from repro_torch.weights import params_from_jax

B, S, MAX_SEQ = 2, 16, 32
# the SSD dots of the reference's chunk scan (mamba2 prefill), which the
# port's ssd_scan kernel entry takes the place of
SSD_DOTS = ("bqn,bhpn,bqh->bqhp/", "bqn,bkn->bqk/", "bqkh,bkh,bkhp->bqhp/")
SSD_DOT_FLOPS = 557_056
# the reference's dense attention dots (gemma prefill), which the port's
# flash_attention kernel entry takes the place of
ATTENTION_DOTS = ("bqhd,bkhd->bhqk/", "bhqk,bkhd->bqhd/")
# (arch, entry, port impl, the reference's compute-engine FLOPs without the
# dots a port kernel takes the place of)
CASES = [
    ("gemma-2b", "decode", "cuda", 491_520),
    ("gemma-2b", "prefill", "cuda", 6_356_992 - 524_288),
    ("gemma-2b", "prefill", "ref", 6_356_992),
    ("qwen3-8b", "decode", "cuda", 524_288),
    ("qwen3-8b", "prefill", "ref", 6_881_280),
    ("mamba2-780m", "decode", "cuda", 304_128),
    ("mamba2-780m", "prefill", "cuda", 3_538_944),
]


@functools.lru_cache(maxsize=None)
def models(arch: str, impl: str):
    ref_cfg = dataclasses.replace(REF_SMOKE[arch], param_dtype="float32")
    cfg = dataclasses.replace(SMOKE_ARCHS[arch], param_dtype="float32")
    ref = ref_get_model(ref_cfg)
    ref_params = ref.init_params(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params),
                             cfg, "cpu")
    return ref, ref_params, get_model(cfg, impl=impl, device="cpu"), params


def prompt(vocab: int) -> np.ndarray:
    return np.random.default_rng(5).integers(0, vocab, size=(B, S)).astype(
        np.int32)


def captures(arch: str, entry: str, impl: str):
    """(the reference's CapturedStream, the port's) of one entry point."""
    ref, ref_params, model, params = models(arch, impl)
    toks = prompt(model.cfg.vocab_size)
    ref_prefill = lambda p, t: ref.prefill(p, t, MAX_SEQ)     # noqa: E731
    t = torch.from_numpy(toks)
    if entry == "prefill":
        want = ref_capture_fn(ref_prefill, ref_params, jnp.asarray(toks))
        got = capture_fn(lambda: model.prefill(params, t, MAX_SEQ),
                         name="prefill", device="cpu")
        return want, got
    ref_state, _ = jax.jit(ref_prefill)(ref_params, jnp.asarray(toks))
    state, _ = model.prefill(params, t, MAX_SEQ)
    nxt = toks[:, -1:]
    want = ref_capture_fn(ref.decode_step, ref_params, ref_state,
                          jnp.asarray(nxt))
    got = capture_fn(model.decode_step, params, state, torch.from_numpy(nxt))
    return want, got


def compute_flops(entries, skip=()):
    return sum(e.flops * e.multiplier for e in entries
               if e.engine == "compute" and not any(s in e.op_path
                                                    for s in skip))


@pytest.mark.parametrize("arch,entry,impl,want", CASES,
                         ids=[f"{a}-{e}-{i}" for a, e, i, _ in CASES])
def test_matmul_flops_equal_reference(arch, entry, impl, want):
    ref_cs, cs = captures(arch, entry, impl)
    kernel_entries = [e for e in cs.stream.entries if e.engine == "kernel"]
    skip = ()
    if any(e.name == "ssd_scan" for e in kernel_entries):
        skip = SSD_DOTS
        assert (compute_flops(ref_cs.stream.entries)
                - compute_flops(ref_cs.stream.entries, skip)) == SSD_DOT_FLOPS
    if any(e.name == "flash_attention" for e in kernel_entries):
        skip = ATTENTION_DOTS
    assert compute_flops(ref_cs.stream.entries, skip) == want
    assert compute_flops(cs.stream.entries) == want
    assert cs.graph_stream is None and cs.n_ops is None
    cfg = SMOKE_ARCHS[arch]
    # two norms a block (Mamba2: the block's and the gated one), the final
    # one, and q's and k's in each qk_norm block; the plain route's norms
    # are plain ops, and it records no kernel
    norms = 2 * cfg.n_layers + 1 + (2 * cfg.n_layers if cfg.qk_norm else 0)
    if impl == "ref":
        assert kernel_entries == []
    else:
        assert sum(e.name == "rms_norm" for e in kernel_entries) == norms
    for e in kernel_entries:
        if e.name == "flash_attention":
            hd, H = cfg.hd, cfg.n_heads
            assert e.flops == 4 * B * H * hd * S * (S + 1) // 2


# ---------------------------------------------------------------- stream sums
def hand_entries(mod):
    """The same hand-built commands in either package."""
    rows = [("dot.1", "dot", "compute", 2, 4096, 8192, 1_048_576, 1, 0, "a/dot"),
            ("fusion.2", "fusion", "fusion", 1, 512, 1024, 700, 1, 0, "a/f"),
            ("while.3", "while", "control", 1, 0, 64, 0, 1, 0, ""),
            ("ag", "all-gather-start", "collective", 3, 4096, 1024, 0, 4,
             2304, "b/ag"),
            ("ag.d", "all-gather-done", "collective", 3, 4096, 0, 0, 4, 0, ""),
            ("ar", "all-reduce", "collective", 1, 2048, 2048, 0, 8, 3584,
             "b/ar"),
            ("cp", "copy", "transfer", 2, 256, 256, 0, 1, 0, "c/copy"),
            ("k", "rms_norm", "kernel", 1, 100, 300, 0, 1, 0, "rms_norm")]
    return [mod.CommandEntry(index=i, name=n, opcode=op, computation="main",
                             multiplier=m, result_bytes=r, operand_bytes=o,
                             engine=eng, flops=f, group_size=g, link_bytes=lb,
                             op_path=path)
            for i, (n, op, eng, m, r, o, f, g, lb, path) in enumerate(rows)]


def test_stream_arithmetic_equals_reference():
    got = stream.CommandStream(hand_entries(stream), text_bytes=777, n_ops=8,
                               unknown_trip_counts=True)
    want = ref_hlo.CommandStream(hand_entries(ref_hlo), text_bytes=777,
                                 n_ops=8, unknown_trip_counts=True)
    assert got.summary() == want.summary()
    assert got.memory_bytes == want.memory_bytes
    assert got.counts_by_engine() == want.counts_by_engine()
    assert got.counts_by_opcode(top=3) == want.counts_by_opcode(top=3)
    assert [e.describe() for e in got.entries] == [
        e.describe() for e in want.entries]
    assert stream.dtype_bytes("bf16") == ref_hlo.dtype_bytes("bf16") == 2


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_link_bytes_equal_reference(n):
    assert stream.COLLECTIVE_OPS == ref_hlo.COLLECTIVE_OPS
    for op in stream.COLLECTIVE_OPS:
        for variant in (op, op + "-start"):
            for result_b, operand_b in ((4096, 1024), (1024, 1024), (96, 32)):
                assert stream._link_bytes(variant, result_b, operand_b, n) == \
                    ref_hlo._link_bytes(variant, result_b, operand_b, n)


@dataclasses.dataclass
class FakeCaptured:
    """What analyze and attribute read from a capture."""

    name: str
    flops: float
    memory_bytes: float
    collective_link_bytes: float
    xla_flops: float
    stream: object


@pytest.mark.parametrize("chips", [1, 4])
def test_roofline_equals_reference(chips):
    fields = dataclasses.asdict(roofline.H100_SXM)
    fields.pop("name")
    ours, theirs = roofline.HW("h100", **fields), ref_roofline.HW("h100", **fields)
    cap = FakeCaptured("step", 3.2e12, 5.1e9, 7.5e8, 3.1e12,
                       stream.CommandStream(hand_entries(stream), 0, 8))
    ref_cap = dataclasses.replace(
        cap, stream=ref_hlo.CommandStream(hand_entries(ref_hlo), 0, 8))
    mf = roofline.model_flops(2.5e9, 4, "inference")
    assert mf == ref_roofline.model_flops(2.5e9, 4, "inference")
    got = roofline.analyze(cap, chips, mf, hw=ours)
    want = ref_roofline.analyze(ref_cap, chips, mf, hw=theirs)

    def same(a, b):
        da, db = a.to_dict(), b.to_dict()
        da.pop("hw"), db.pop("hw")
        assert da == db
        assert render_roofline_row(a) == ref_row(b)

    same(got, want)
    credit = roofline.attribute(cap, "rms_norm", "a/")
    assert credit == ref_roofline.attribute(ref_cap, "rms_norm", "a/")
    same(roofline.adjusted(got, -credit["flops"], -credit["memory_bytes"],
                           name="credited"),
         ref_roofline.adjusted(want, -credit["flops"], -credit["memory_bytes"],
                               name="credited"))
    assert roofline.analyze(cap, chips).hw is roofline.H100_SXM


# ---------------------------------------------------------------- kernels
def kernel_cases():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 64, generator=g)
    q = torch.randn(2, 12, 4, 64, generator=g)
    k = torch.randn(2, 12, 2, 64, generator=g)
    v = torch.randn(2, 12, 2, 64, generator=g)
    xh = torch.randn(1, 32, 3, 8, generator=g)
    dt = torch.rand(1, 32, 3, generator=g)
    A = -torch.rand(3, generator=g)
    Bc = torch.randn(1, 32, 16, generator=g)
    Cc = torch.randn(1, 32, 16, generator=g)
    copy = torch.randn(8, 32, generator=g).to(torch.bfloat16)
    pairs, chunks = 16 * 17 // 2, 2
    return [
        ("rms_norm", lambda: rms_norm(x, x[0].contiguous()), 0,
         (6 * 64 + 64) * 4, 6 * 64 * 4),
        ("flash_attention", lambda: flash_attention(q, k, v),
         4 * 2 * 4 * 64 * (12 * 13 // 2), (2 * 12 * 4 * 64 + 2 * 2 * 12 * 2 * 64)
         * 4, 2 * 12 * 4 * 64 * 4),
        ("ssd_scan", lambda: ssd_scan(xh, dt, A, Bc, Cc, chunk=16),
         2 * 1 * (chunks * (pairs * 16 + 3 * pairs * 8)
                  + 2 * (chunks - 1) * 3 * 16 * 16 * 8),
         (32 * 3 * 8 + 32 * 3 + 3 + 2 * 32 * 16) * 4, 32 * 3 * 8 * 4),
        ("dma_copy_pipelined", lambda: dma_copy(copy, "pipelined", 4), 0,
         8 * 32 * 2, 8 * 32 * 2),
        ("dma_copy_explicit", lambda: dma_copy(copy, "explicit", 4), 0,
         8 * 32 * 2, 8 * 32 * 2),
    ]


@pytest.mark.parametrize("case", kernel_cases(), ids=lambda c: c[0])
def test_each_kernel_wrapper_reports_one_entry(case):
    name, call, flops, operand_b, result_b = case
    st = record_ops(call)
    assert [(e.name, e.engine, e.op_path) for e in st.entries] == [
        (name, "kernel", name)]
    e = st.entries[0]
    assert (e.flops, e.operand_bytes, e.result_bytes) == (flops, operand_b,
                                                          result_b)
    assert kernels.recorder is None
    # outside a recording the wrapper records nothing and still computes
    torch.testing.assert_close(call(), call())


def test_captured_step_records_what_record_ops_records():
    _, _, model, params = models("gemma-2b", "cuda")
    t = torch.from_numpy(prompt(model.cfg.vocab_size))
    step = graphs.CapturedStep(lambda: model.prefill(params, t, MAX_SEQ),
                               torch.device("cpu"))
    step()
    assert step.ops is None                  # recording is asked for
    with graphs.record_captures():
        first = step()
    assert step.ops is not None and step.record_s > 0
    ops = step.ops
    torch.testing.assert_close(step()[1], first[1])
    assert step.ops is ops                   # recorded once, at the first call
    again = record_ops(lambda: model.prefill(params, t, MAX_SEQ))
    key = lambda st: [(e.name, e.engine, e.flops, e.operand_bytes,  # noqa: E731
                       e.result_bytes, e.op_path) for e in st.entries]
    assert key(ops) == key(again)
    assert ops.n_ops == len(ops.entries) and ops.text_bytes > 0


# ---------------------------------------------------------------- facade
def test_lower_and_compile_emits_the_reference_compile_event():
    with RefSession("ref") as ref_sess:
        ref_sess.capture.lower_and_compile("f", lambda x: x @ x,
                                           args=(jnp.ones((4, 4)),))
    with TraceSession("port") as sess:
        cs = sess.capture.lower_and_compile("f", lambda x: x @ x,
                                            args=(torch.ones(4, 4),))
        assert sess.lower_and_compile("g", lambda x: x + 1,
                                      args=(torch.ones(4),)).name == "g"
    want, = ref_sess.timeline(kinds="compile")
    got = sess.timeline(kinds="compile")
    assert [e.name for e in got] == ["f", "g"]
    assert got[0].kind == want.kind == "compile"
    assert set(got[0].meta) == set(want.meta)
    assert got[0].meta["flops"] == cs.flops == 2 * 4 * 4 * 4
    assert cs.memory["argument_size_in_bytes"] == 64
    assert cs.memory["output_size_in_bytes"] == 64
    torch.testing.assert_close(cs.step(), torch.full((4, 4), 4.0))


def test_capture_standalone_records_identically():
    def run_one():
        cap = CommandStreamCapture()
        return cap.lower_and_compile("g", lambda x: x @ x,
                                     args=(torch.ones(4, 4),))

    bare = run_one()
    with TraceSession("wrapped") as sess:
        inside = run_one()
    assert bare.name == inside.name == "g"
    assert bare.n_ops == inside.n_ops
    assert bare.command_bytes == inside.command_bytes
    assert bare.stream.summary() == inside.stream.summary()
    assert [e.kind for e in sess.timeline()] == ["compile"]


def ref_sections(text):
    return [ln for ln in text.splitlines()
            if ln.startswith(("Submission captured", "====",
                              "Command-stream entries"))]


def test_render_submission_holds_the_reference_sections():
    want = ref_render(RefCapture().lower_and_compile(
        "mm", lambda x: jnp.tanh(x @ x).sum(), args=(jnp.ones((8, 8)),)),
        max_entries=3)
    got = render_submission(CommandStreamCapture().lower_and_compile(
        "mm", lambda x: torch.tanh(x @ x).sum(), args=(torch.ones(8, 8),)),
        max_entries=3)
    heads = [ln.split(":")[0] for ln in ref_sections(want)]
    assert [ln.split(":")[0] for ln in ref_sections(got)] == heads
    assert "nothing is captured on the CPU" in got
    assert "(op-level, no graph)" in got
    assert "mm" in got.splitlines()[-3]


def test_capture_compiled_reads_a_servers_steps():
    _, _, model, params = models("gemma-2b", "cuda")
    srv = Server(model.cfg, batch_size=2, max_seq=MAX_SEQ, tokens_per_launch=2,
                 device="cpu", params=params)
    prompts = np.random.default_rng(1).integers(0, 256, size=(2, 5))
    reqs = lambda: [Request(i, p.astype(np.int32), 4)       # noqa: E731
                    for i, p in enumerate(prompts)]
    cap = CommandStreamCapture(session=srv.session)
    srv.serve(reqs())
    with pytest.raises(RuntimeError, match="record_captures"):
        cap.capture_compiled("decode", srv.graphs()["decode T=2"])
    srv = Server(model.cfg, batch_size=2, max_seq=MAX_SEQ, tokens_per_launch=2,
                 device="cpu", params=params)
    cap = CommandStreamCapture(session=srv.session)
    with graphs.record_captures():
        srv.serve(reqs())
    decode = cap.capture_compiled("decode", srv.graphs()["decode T=2"])
    norms = 2 * (2 * model.cfg.n_layers + 1)        # two steps a replay
    assert sum(e.name == "rms_norm" for e in decode.stream.entries) == norms
    assert decode.graph_stream is None
    assert "record/capture" in render_submission(decode, srv.tracker)
    assert srv.session.timeline(kinds="compile")[-1].name == "decode"


# ---------------------------------------------------------------- graph nodes
def record(**kw):
    r = stream._NodeRecord()
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def test_graph_node_records_become_entries():
    mangled = b"_ZN12_GLOBAL__N_115rms_norm_kernelI13__nv_bfloat16Li8EEEvPKT_"
    k = stream._graph_entry(0, record(
        type=0, name=mangled,
        demangled=b"void (anonymous namespace)::rms_norm_kernel"
                  b"<__nv_bfloat16, 8>(__nv_bfloat16 const*)",
        grid=(255, 1, 1), block=(256, 1, 1),
        shared_bytes=0), 0x10, 0)
    assert (k.opcode, k.engine, k.label) == ("kernel", "compute",
                                             "rms_norm_kernel<bf16, 8>")
    assert stream.kernel_base(k.op_path) == \
        "(anonymous namespace)::rms_norm_kernel"
    assert "grid=(255, 1, 1) block=(256, 1, 1) smem=0B" in k.describe()
    unnamed = stream._graph_entry(1, record(type=0, status=500), 0x10, 0)
    assert unnamed.name == unnamed.label == "<unnamed>"
    cp = stream._graph_entry(2, record(type=1, bytes=4096, direction=3),
                             0x10, 1)
    assert (cp.engine, cp.result_bytes, cp.operand_bytes, cp.direction) == (
        "transfer", 4096, 4096, "device->device")
    ms = stream._graph_entry(3, record(type=2, bytes=4), 0x10, 0)
    assert (ms.engine, ms.result_bytes, ms.operand_bytes) == ("transfer", 4, 0)
    cond = stream._graph_entry(4, record(type=13), 0x10, 0)
    assert (cond.opcode, cond.engine) == ("conditional", "control")
    st = stream.CommandStream([k, unnamed, cp, ms, cond], 0, 5)
    assert st.counts_by_engine() == {"compute": 2, "transfer": 2,
                                     "control": 1}
    assert st.memory_bytes == 2 * 4096 + 4


@pytest.mark.parametrize("name,base", [
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>, std::array<char*, 1ul> >(int, at::native::"
     "FillFunctor<float>, std::array<char*, 1ul>)",
     "at::native::vectorized_elementwise_kernel"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_cublas",
     "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_cublas"),
    ("void (anonymous namespace)::flash_attention_mma_kernel<256>(float)",
     "(anonymous namespace)::flash_attention_mma_kernel"),
])
def test_kernel_base(name, base):
    assert stream.kernel_base(name) == base


# ---------------------------------------------------------------- on a card
@pytest.mark.cuda
def test_decode_graph_of_a_graphed_chain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = ExecGraph(chain_len=10, width=4096, device="cuda")
    g.upload("graphed")
    step = g._graphs["graphed"]
    st = stream.decode_graph(step.graph)
    assert [e.opcode for e in st.entries] == ["kernel"] * 10
    assert {stream.kernel_base(e.op_path) for e in st.entries} == {
        "(anonymous namespace)::exec_graph_node_kernel"}
    assert st.n_ops == graph_footprint([step.graph.raw_cuda_graph()])[1]
    ms = g.decode("multistep")
    assert [e.opcode for e in ms.entries] == ["memset", "conditional",
                                              "kernel", "kernel"]
    assert ms.unknown_trip_counts and ms.entries[2].depth == 1
    assert ms.n_ops == g.command_footprint("multistep")[1]
    with pytest.raises(RuntimeError, match="no body graph supplied"):
        stream.decode_graph(g._multistep_graphs()[0])
