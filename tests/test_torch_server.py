"""The port's one-shot ``Server.serve`` against the JAX reference's.

Both servers run gemma-smoke, and mamba2-smoke, on the same weights (the
reference's, carried over by ``params_from_jax``) with ragged, left-padded
prompts.  Tokens, the
metrics' counts and every dispatch's name and payload bytes must be equal.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as REF_SMOKE
from repro.core.session import JsonlSink as RefJsonlSink
from repro.runtime.server import Request as RefRequest
from repro.runtime.server import Server as RefServer
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.core import DoorbellTracker, TraceSession, payload_bytes
from repro_torch.runtime.server import Request, Server
from repro_torch.weights import params_from_jax

PROMPT_LENS = (3, 9, 6, 12)
MAX_NEW = (5, 7, 4, 7)
MAX_SEQ = 32
COUNTS = ("doorbells", "new_tokens", "tokens_per_doorbell", "trace_events")


def prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, size=n).astype(np.int32) for n in PROMPT_LENS]


def dispatches(session):
    return [(e.name, e.payload_bytes) for e in session.timeline(kinds="dispatch")]


@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-780m"])
@pytest.mark.parametrize("T", [1, 3, 4])
def test_serve_matches_reference(T, arch):
    ref = RefServer(REF_SMOKE[arch], batch_size=4, max_seq=MAX_SEQ,
                    tokens_per_launch=T, seed=0)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref.params),
                             SMOKE_ARCHS[arch], "cpu")
    srv = Server(SMOKE_ARCHS[arch], batch_size=4, max_seq=MAX_SEQ,
                 tokens_per_launch=T, device="cpu", params=params)
    ref_reqs = [RefRequest(i, p, m) for i, (p, m) in
                enumerate(zip(prompts(), MAX_NEW))]
    reqs = [Request(i, p, m) for i, (p, m) in enumerate(zip(prompts(), MAX_NEW))]
    want = ref.serve(ref_reqs)
    got = srv.serve(reqs)
    assert [r.tokens for r in reqs] == [r.tokens for r in ref_reqs]
    assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}
    assert got["doorbells"] == 1 + -(-(max(MAX_NEW) - 1) // T)
    assert dispatches(srv.session) == dispatches(ref.session)
    spans = [e.meta["span_path"] for e in srv.session.timeline(kinds="progress")]
    assert spans == [e.meta["span_path"]
                     for e in ref.session.timeline(kinds="progress")]


SECOND_LENS = (5, 2, 8, 4)
SECOND_NEW = (6, 3, 5, 6)


@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-780m"])
@pytest.mark.parametrize("T", [1, 3, 4])
def test_serve_twice_matches_reference(T, arch):
    """One Server serves two batches of other prompt lengths (a second
    prefill graph, the same decode graph and fixed state on the card);
    both serves equal the reference's.

    In fp32, where greedy tokens are a parity target: in bf16 the second
    batch's first mamba2 request meets a near-tie at its third token (the
    reference's top two logits one bf16 step apart, 0.0156 at 2.84), where
    the port's eager path picks the other token as well."""
    cfg = dataclasses.replace(SMOKE_ARCHS[arch], param_dtype="float32")
    ref = RefServer(dataclasses.replace(REF_SMOKE[arch],
                                        param_dtype="float32"),
                    batch_size=4, max_seq=MAX_SEQ, tokens_per_launch=T, seed=0)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref.params),
                             cfg, "cpu")
    srv = Server(cfg, batch_size=4, max_seq=MAX_SEQ, tokens_per_launch=T,
                 device="cpu", params=params)
    rng = np.random.default_rng(12)
    second = [rng.integers(0, 256, size=n).astype(np.int32)
              for n in SECOND_LENS]
    for batch, max_new in ((prompts(), MAX_NEW), (second, SECOND_NEW)):
        ref_reqs = [RefRequest(i, p, m)
                    for i, (p, m) in enumerate(zip(batch, max_new))]
        reqs = [Request(i, p, m) for i, (p, m) in enumerate(zip(batch, max_new))]
        want = ref.serve(ref_reqs)
        got = srv.serve(reqs)
        assert [r.tokens for r in reqs] == [r.tokens for r in ref_reqs]
        assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}
    assert dispatches(srv.session) == dispatches(ref.session)


def test_serve_refuses_another_param_tree():
    cfg = SMOKE_ARCHS["gemma-2b"]
    srv = Server(cfg, batch_size=1, max_seq=8, device="cpu")
    other = Server(cfg, batch_size=1, max_seq=8, device="cpu", seed=1).params
    with pytest.raises(ValueError, match="own params"):
        srv._prefill(other, srv._prompt[:, :2])
    with pytest.raises(ValueError, match="own params"):
        srv._decode(other, srv.state, srv._tok)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-780m"])
@pytest.mark.parametrize("T", [1, 4])
def test_replayed_tokens_equal_eager(T, arch):
    """On a card: the serve that captures and the one that replays give the
    tokens of an eager greedy loop over the same model and weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = SMOKE_ARCHS[arch]
    srv = Server(cfg, batch_size=4, max_seq=MAX_SEQ, tokens_per_launch=T,
                 device="cuda")
    runs = []
    for _ in range(2):
        reqs = [Request(i, p, 8) for i, p in enumerate(prompts())]
        srv.serve(reqs)
        runs.append([r.tokens for r in reqs])
    toks = np.zeros((4, max(PROMPT_LENS)), np.int32)
    for i, p in enumerate(prompts()):
        toks[i, toks.shape[1] - len(p):] = p
    state, logits = srv.model.prefill(srv.params, torch.from_numpy(toks).cuda(),
                                      MAX_SEQ)
    eager = []
    for _ in range(8):
        nxt = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
        eager.append(nxt[:, 0])
        state, logits = srv.model.decode_step(srv.params, state, nxt)
    assert runs[0] == runs[1] == torch.stack(eager, 1).tolist()


def test_serve_rejects_like_reference():
    srv = Server(SMOKE_ARCHS["gemma-2b"], batch_size=2, max_seq=8,
                 device="cpu")
    assert srv.serve([]) == {"wall_s": 0.0, "doorbells": 0, "new_tokens": 0,
                             "tokens_per_doorbell": 0.0, "trace_events": 0}
    with pytest.raises(ValueError):
        srv.serve([Request(i, np.zeros(2, np.int32)) for i in range(3)])
    with pytest.raises(ValueError):
        srv.serve([Request(0, np.zeros(9, np.int32))])


def test_payload_bytes_counts_tensors_modules_and_scalars():
    lin = torch.nn.Linear(4, 3)                       # 12 + 3 f32 params
    bn = torch.nn.BatchNorm1d(2)                      # 4 params, 2 + 2 + 1 buffers
    tree = ({"a": torch.zeros(2, 5, dtype=torch.bfloat16), "b": None},
            [np.zeros(3, np.int32), 7], lin, bn)
    want = 2 * 5 * 2 + 3 * 4 + 4 + 15 * 4 + (4 + 4) * 4 + 8
    assert payload_bytes(tree) == want


def test_doorbell_wrap_records_dispatch_events():
    sess = TraceSession("t")
    tracker = DoorbellTracker(session=sess)
    f = tracker.wrap(lambda x, n: x * n, "mul", block=True)
    f(torch.ones(4), 3)
    assert tracker.count == 1
    (ev,) = sess.timeline(kinds="dispatch")
    assert (ev.name, ev.payload_bytes) == ("mul", 4 * 4 + 4)
    assert tracker.summary()["by_name"]["mul"]["doorbells"] == 1


def test_jsonl_trace_reads_back_with_reference_loader(tmp_path):
    path = tmp_path / "trace.jsonl"
    with TraceSession("serve", jsonl_path=str(path), tags={"host": "h0"}) as sess:
        with sess.span("serve.oneshot", batch=1):
            sess.wrap(lambda t: t + 1, "step")(torch.zeros(2))
    events = RefJsonlSink.load(str(path))
    assert [(e.kind, e.name) for e in events] == [("dispatch", "step"),
                                                  ("progress", "obs.span")]
    assert events[0].meta["span_path"] == "serve.oneshot"
    assert events[0].meta["host"] == "h0"
    assert set(json.loads(path.read_text().splitlines()[0])) == {
        "seq", "kind", "name", "t", "dur_s", "complete_s", "payload_bytes",
        "meta"}
