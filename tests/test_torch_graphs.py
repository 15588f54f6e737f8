"""The port's launch modes (``repro_torch.core.graphs``) against the JAX
reference's ``repro.core.graphs``.

On the CPU both chains run the same float32 products in the same order, so
results agree to 1e-5 (the reference's own tolerance against its oracle);
doorbells, ``graph_launch`` event names and meta keys must be equal.  Tests
marked ``cuda`` run the hand-written node kernel and the graphs on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ExecGraph as RefExecGraph
from repro.core import MultiStepLauncher as RefLauncher
from repro.core.session import TraceSession as RefSession
from repro_torch.core import TraceSession
from repro_torch.core.graphs import (LAUNCH_MODES, CapturedStep, ExecGraph,
                                     MultiStepLauncher)
from repro_torch.kernels import launches, reset_launches


def graph_events(session):
    return [(e.name, sorted(k for k in e.meta if not k.startswith("span")))
            for e in session.timeline(kinds="graph_launch")]


@pytest.mark.parametrize("mode", LAUNCH_MODES)
def test_launch_modes_match_reference(mode):
    ref_sess, sess = RefSession("ref"), TraceSession("port")
    want, ref_st = RefExecGraph(chain_len=12, width=64).launch(
        mode, session=ref_sess)
    g = ExecGraph(chain_len=12, width=64, device="cpu")
    got, st = g.launch(mode, session=sess)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), g.reference().numpy(), rtol=1e-5)
    assert st.doorbells == ref_st.doorbells == (12 if mode == "per_op" else 1)
    assert graph_events(sess) == graph_events(ref_sess)
    assert ([e.name for e in sess.timeline(kinds="dispatch")]
            == [e.name for e in ref_sess.timeline(kinds="dispatch")])
    assert st.command_bytes is None and st.n_ops is None
    with pytest.raises(RuntimeError):
        g.command_footprint(mode)


def test_relaunch_starts_from_ones():
    g = ExecGraph(chain_len=5, width=8, device="cpu")
    first, _ = g.launch("graphed")
    second, _ = g.launch("graphed")
    torch.testing.assert_close(first, second, rtol=0, atol=0)


def step(carry, b):
    """One step for both frameworks' launchers."""
    return carry + b, carry.sum()


def test_multistep_launcher_matches_reference():
    batches = np.random.default_rng(0).standard_normal((5, 4)).astype(
        np.float32)
    ref = RefLauncher(step, k=5)
    want_carry, want_aux = ref(jnp.zeros((4,)), jnp.asarray(batches))
    sess = TraceSession("port")
    launcher = MultiStepLauncher(step, k=5, session=sess, device="cpu")
    carry, aux = launcher(torch.zeros(4), torch.from_numpy(batches))
    np.testing.assert_allclose(carry.numpy(), np.asarray(want_carry),
                               rtol=1e-6)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), rtol=1e-6,
                               atol=1e-6)
    assert aux.shape == (5,)
    assert launcher.tracker.count == 1  # ONE doorbell for 5 steps
    (ev,) = sess.timeline(kinds="graph_launch")
    assert ev.name == "multistep_launch" and ev.meta["chain_len"] == 5


def test_multistep_launcher_takes_trees_and_new_inputs():
    def step(carry, b):
        return {"s": carry["s"] + b["x"]}, (carry["s"].sum(), b["x"])

    launcher = MultiStepLauncher(step, k=3, device="cpu")
    for seed in (1, 2):
        xs = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (3, 2)).astype(np.float32))
        carry, (sums, seen) = launcher({"s": torch.ones(2)}, {"x": xs})
        torch.testing.assert_close(carry["s"], 1 + xs.sum(0))
        torch.testing.assert_close(seen, xs)
        assert sums.shape == (3,)
    assert launcher.tracker.count == 2


def test_captured_step_on_cpu_runs_the_step():
    calls = []
    step = CapturedStep(lambda: calls.append(1) or len(calls),
                        torch.device("cpu"))
    step.capture()
    assert (step(), step(), calls) == (1, 2, [1, 1])
    with pytest.raises(RuntimeError):
        step.footprint()


# ---------------------------------------------------------------- on a card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", LAUNCH_MODES)
def test_launch_modes_on_card(mode):
    dev = _card()
    g = ExecGraph(chain_len=12, width=4096, device=dev)
    g.command_footprint(mode)       # builds the graphs: a warm-up launches
    reset_launches()
    y, st = g.launch(mode)
    torch.testing.assert_close(y, g.reference(), rtol=1e-5, atol=0)
    assert st.doorbells == (12 if mode == "per_op" else 1)
    assert launches["exec_graph"] == 12
    assert st.command_bytes > 0 and st.n_ops > 0


@pytest.mark.cuda
def test_footprint_law_on_card():
    """per_op: bytes ∝ K; graphed: grows with K; multistep: O(1)."""
    dev = _card()
    sizes = {}
    for K in (8, 32):
        g = ExecGraph(chain_len=K, width=64, device=dev)
        for mode in LAUNCH_MODES:
            sizes[(mode, K)] = g.command_footprint(mode)[0]
    assert sizes[("per_op", 32)] == 4 * sizes[("per_op", 8)]
    assert sizes[("graphed", 32)] > sizes[("graphed", 8)]
    assert sizes[("multistep", 32)] / sizes[("multistep", 8)] < 1.1


@pytest.mark.cuda
def test_multistep_launcher_on_card():
    dev = _card()
    launcher = MultiStepLauncher(step, k=5, device=dev)
    batches = torch.ones(5, 4, device=dev)
    carry, aux = launcher(torch.zeros(4, device=dev), batches)
    torch.testing.assert_close(carry.cpu(), 5 * torch.ones(4))
    torch.testing.assert_close(aux.cpu(), torch.tensor([0., 4, 8, 12, 16]))
    assert launcher.tracker.count == 1
