"""The chunked SSD scan's steps, as the CUDA kernels take them, against the
JAX reference; and the split of the pipelined DMA copy's tiles.

``ssd_chunk_states``, ``ssd_state_passing`` and ``ssd_chunk_outputs``
(``repro_torch.kernels.ssd_scan.ref``) are the kernels' decomposition in
plain PyTorch.  They are held to ``repro.models.mamba.ssd_chunked``: y, the
final state through one more passing step, and the state after each chunk.
With ``operand=round_tf32`` they round where the bf16 kernels round (every
fp32 operand of a tensor-core product in TF32, y once in bf16), which shows
on the CPU that the kernels' choice of precision keeps the bf16 tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.dma_copy.ops import SLICE_BYTES, pipelined_split
from repro_torch.kernels.ssd_scan.ops import TILE, workspace_shapes
from repro_torch.kernels.ssd_scan.ref import (round_tf32, ssd_chunk_outputs,
                                              ssd_chunk_states, ssd_chunked,
                                              ssd_state_passing)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# fp32: the steps sum in another order than the reference; bf16 as in
# tests/test_kernels.py
STEP_TOL = {"float32": 1e-5, "bfloat16": 6e-2}
SSD_TOL_BF16 = 6e-2


def ssd_inputs(B, S, H, P, N, dtype, seed=0):
    """(torch, jax) inputs as the reference's sweep draws them: x, B, C ~
    N(0, 1) in ``dtype``; dt = |N(0, 1)| and A = -|N(0, 1)| in fp32."""
    r = np.random.default_rng(seed)
    arrays = (r.normal(size=(B, S, H, P)), np.abs(r.normal(size=(B, S, H))),
              -np.abs(r.normal(size=(H,))), r.normal(size=(B, S, N)),
              r.normal(size=(B, S, N)))
    kinds = (dtype, "float32", "float32", dtype, dtype)
    ours = tuple(torch.from_numpy(a.astype(np.float32)).to(DTYPES[k][0])
                 for a, k in zip(arrays, kinds))
    theirs = tuple(jnp.asarray(a.astype(np.float32), DTYPES[k][1])
                   for a, k in zip(arrays, kinds))
    return ours, theirs


def close(t: torch.Tensor, j, tol: float) -> None:
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


def steps(x, dt, A, Bc, Cc, chunk, operand=None):
    """y and the states [B, n+1, H, P, N] by the kernels' three steps."""
    states = ssd_chunk_states(x, dt, A, Bc, chunk, operand)
    h = ssd_state_passing(states, dt, A, chunk)
    return ssd_chunk_outputs(x, dt, A, Bc, Cc, h, chunk, operand), h


@pytest.mark.parametrize("n_chunks", [1, 4, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_steps_compose_to_reference(n_chunks, dtype):
    """y from the three steps, and the final state after one more passing
    step, equal the reference's chunked scan."""
    chunk = 16
    ours, theirs = ssd_inputs(2, n_chunks * chunk, 3, 16, 8, dtype)
    y, h = steps(*ours, chunk)
    assert y.dtype == ours[0].dtype and h.shape == (2, n_chunks + 1, 3, 16, 8)
    y_ref, h_ref = jax_ssd_chunked(*theirs, chunk=chunk)
    close(y, y_ref, STEP_TOL[dtype])
    close(h[:, -1], h_ref, STEP_TOL[dtype])


@pytest.mark.parametrize("n_chunks", [4, 16])
def test_ssd_state_passing_equals_reference_prefix_states(n_chunks):
    """The state passed to chunk c equals the reference's final state over
    the first c chunks."""
    chunk = 8
    ours, theirs = ssd_inputs(1, n_chunks * chunk, 2, 8, 4, "float32", seed=1)
    x, dt, A, Bc, _ = ours
    h = ssd_state_passing(ssd_chunk_states(x, dt, A, Bc, chunk), dt, A, chunk)
    assert torch.equal(h[:, 0], torch.zeros_like(h[:, 0]))
    for c in range(1, n_chunks + 1):
        S = c * chunk
        prefix = [t[:, :S] if t.ndim > 1 else t for t in theirs]
        _, h_ref = jax_ssd_chunked(*prefix, chunk=chunk)
        close(h[:, c], h_ref, STEP_TOL["float32"])


def test_ssd_bf16_kernel_rounding_within_tolerance():
    """The bf16 kernels' rounding points at the serving path's head width
    (P=64, N=128, chunk 256, four chunks): C B^T exact; M, the weighted x of
    the state product and the carried state in TF32; y once in bf16.  Held
    to the JAX oracle and to the plain version within the bf16 tolerance."""
    chunk = 256
    ours, theirs = ssd_inputs(1, 4 * chunk, 4, 64, 128, "bfloat16", seed=2)
    y, _ = steps(*ours, chunk, operand=round_tf32)
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()
    y_ref, _ = jax_ssd_chunked(*theirs, chunk=chunk)
    close(y, y_ref, SSD_TOL_BF16)
    close(y, ssd_chunked(*ours, chunk)[0].float().numpy(), SSD_TOL_BF16)


def test_round_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one, one + 2**-12, one + 2**-11, -(one + 2**-11),
                      one + 3 * 2**-11, 3.0e-39, 0.0, float("inf")])
    want = torch.tensor([one, one, one + 2**-10, -(one + 2**-10),
                         one + 2**-9, round_tf32(torch.tensor([3.0e-39]))[0],
                         0.0, float("inf")])
    assert torch.equal(round_tf32(x), want)
    r = torch.from_numpy(np.random.default_rng(3).normal(size=1000)
                         .astype(np.float32))
    t = round_tf32(r)
    assert torch.equal(t.view(torch.int32) & 0x1FFF,
                       torch.zeros(1000, dtype=torch.int32))
    assert ((t - r).abs() <= r.abs() * 2**-11).all()


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (4, 1024, 48, 64, 128, 256), (1, 4096, 48, 64, 128, 256),
    (2, 512, 48, 64, 128, 64), (1, 255, 3, 64, 128, 255),
    (2, 96, 5, 16, 8, 32)])
def test_ssd_workspace_shapes(B, S, H, P, N, chunk):
    """One state per chunk boundary (none for one chunk), and C B^T on tiles
    of whole TILE rows."""
    shapes = workspace_shapes(B, S, H, P, N, chunk)
    n = S // chunk
    Qp = shapes["cb"][-1]
    assert list(shapes) == ["cum", "dt", "cb", "states"]
    assert shapes["cum"] == shapes["dt"] == (B, H, S)
    assert Qp % TILE == 0 and chunk <= Qp < chunk + TILE
    assert shapes["cb"] == (B, n, Qp, Qp)
    assert shapes["states"] == (B, H, n - 1, P, N)


# tiles of the D2 and on-card cases: 111 and 56 bytes (offsets not multiples
# of 16), one and four slices exactly and one byte past them, 240006 bytes,
# and the path's block_rows 8 / 256 tiles of 4096 bf16 columns
@pytest.mark.parametrize("tile_bytes", [1, 15, 56, 111, 1056, 41040,
                                        SLICE_BYTES, SLICE_BYTES + 1,
                                        4 * SLICE_BYTES, 4 * SLICE_BYTES + 1,
                                        240006, 8 * 4096 * 2, 256 * 4096 * 2])
def test_pipelined_split_covers_each_tile_once(tile_bytes):
    slices = pipelined_split(tile_bytes)
    assert SLICE_BYTES % 16 == 0
    assert len(slices) == -(-tile_bytes // SLICE_BYTES)
    assert slices[0][0] == 0 and slices[-1][1] == tile_bytes
    for (b0, e0), (b1, _) in zip(slices, slices[1:]):
        assert e0 == b1 and b1 % 16 == 0
    assert all(0 < e - b <= SLICE_BYTES for b, e in slices)
    assert sum(e - b for b, e in slices) == tile_bytes
