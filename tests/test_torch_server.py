"""The port's one-shot ``Server.serve`` against the JAX reference's.

Both servers run gemma-smoke, and mamba2-smoke, on the same weights (the
reference's, carried over by ``params_from_jax``) with ragged, left-padded
prompts.  Tokens, the
metrics' counts and every dispatch's name and payload bytes must be equal.
"""
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
