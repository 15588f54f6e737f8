"""The port's kernels against the JAX reference's kernels and oracles.

On the CPU each wrapper takes its kernel's plain PyTorch version; the tests
marked ``cuda`` launch the CUDA kernels and run only on a machine with a card
(``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_*.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.kernels.rms_norm.ops import rms_norm_fused
from repro.kernels.rms_norm.ref import rms_norm_ref as jax_rms_ref
from repro.models.attention import dense_causal_attention as jax_dense
from repro_torch.kernels import launches, reset_launches
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.rms_norm.ops import rms_norm
from repro_torch.kernels.rms_norm.ref import rms_norm_ref

rng = np.random.default_rng(7)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
RMS_TOL = {"float32": 2e-5, "bfloat16": 2e-2}       # tests/test_kernels.py
FLASH_TOL = {"float32": 3e-5, "bfloat16": 3e-2}


def both(a: np.ndarray, dtype: str):
    """The same numpy values as a torch tensor and a jax array of ``dtype``."""
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


def close(t: torch.Tensor, j, tol: float) -> None:
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")


# ---------------------------------------------------------------- rms_norm
@pytest.mark.parametrize("shape", [(4, 64, 256), (2, 100, 128), (1, 7, 512),
                                   (8, 128), (3, 2048)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_pallas_and_oracle(shape, dtype):
    x_np = rng.normal(size=shape).astype(np.float32)
    s_np = (rng.normal(size=shape[-1:]) * 0.1).astype(np.float32)
    x, xj = both(x_np, dtype)
    s, sj = both(s_np, dtype)
    out = rms_norm(x, s)
    assert out.dtype == x.dtype and out.shape == x.shape
    close(out, rms_norm_fused(xj, sj), RMS_TOL[dtype])     # interpret mode
    close(out, jax_rms_ref(xj, sj), RMS_TOL[dtype])


# ---------------------------------------------------------------- flash
@pytest.mark.parametrize("B,S,H,Hkv,hd", [
    (1, 7, 2, 2, 32), (2, 100, 4, 1, 64), (1, 128, 4, 2, 64),
    (2, 61, 8, 1, 256), (1, 33, 2, 1, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_reference(B, S, H, Hkv, hd, causal, dtype):
    """Ragged S, GQA/MQA (Hkv < H) and both causal modes."""
    q_np = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k_np = rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)
    v_np = rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)
    q, qj = both(q_np, dtype)
    k, _ = both(k_np, dtype)
    v, _ = both(v_np, dtype)
    # the reference kernels take K/V already expanded to H heads
    _, kj = both(np.repeat(k_np, H // Hkv, axis=2), dtype)
    _, vj = both(np.repeat(v_np, H // Hkv, axis=2), dtype)
    out = flash_attention(q, k, v, causal=causal)
    assert out.dtype == q.dtype and out.shape == q.shape
    close(out, jax_flash_ref(qj, kj, vj, causal=causal), FLASH_TOL[dtype])
    close(out, jax_dense(qj, kj, vj, causal=causal), FLASH_TOL[dtype])


# ---------------------------------------------------------------- wrappers
def test_cpu_tensors_take_plain_version_and_count_nothing():
    reset_launches()
    x = torch.from_numpy(rng.normal(size=(5, 64)).astype(np.float32))
    s = torch.zeros(64)
    assert torch.equal(rms_norm(x, s), rms_norm_ref(x, s))
    q = torch.from_numpy(rng.normal(size=(1, 9, 4, 64)).astype(np.float32))
    kv = torch.from_numpy(rng.normal(size=(1, 9, 2, 64)).astype(np.float32))
    assert torch.equal(flash_attention(q, kv, kv),
                       flash_attention_ref(q, kv, kv))
    assert launches["rms_norm"] == 0 and launches["flash_attention"] == 0


@pytest.mark.parametrize("case", ["scale_shape", "int_dtype", "mixed_dtype",
                                  "non_contiguous"])
def test_rms_norm_wrapper_rejects(case):
    x = torch.ones(4, 64)
    s = torch.zeros(64)
    if case == "scale_shape":
        s = torch.zeros(32)
    elif case == "int_dtype":
        x, s = x.int(), s.int()
    elif case == "mixed_dtype":
        s = s.bfloat16()
    else:
        x = torch.ones(64, 4).T
    with pytest.raises((ValueError, TypeError)):
        rms_norm(x, s)


@pytest.mark.parametrize("case", ["heads", "seq", "dtype", "non_contiguous",
                                  "empty"])
def test_flash_wrapper_rejects(case):
    q = torch.ones(1, 8, 4, 64)
    k = v = torch.ones(1, 8, 2, 64)
    if case == "heads":
        k = v = torch.ones(1, 8, 3, 64)
    elif case == "seq":
        k = v = torch.ones(1, 9, 2, 64)
    elif case == "dtype":
        k = v = torch.ones(1, 8, 2, 64, dtype=torch.bfloat16)
    elif case == "non_contiguous":
        q = torch.ones(1, 4, 8, 64).transpose(1, 2)
    else:
        q, k, v = torch.ones(1, 0, 4, 64), torch.ones(1, 0, 2, 64), torch.ones(1, 0, 2, 64)
    with pytest.raises((ValueError, TypeError)):
        flash_attention(q, k, v)


# ---------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_kernel_on_card(dtype):
    _need_card()
    x = torch.from_numpy(rng.normal(size=(1020, 2048)).astype(np.float32))
    s = torch.from_numpy((rng.normal(size=(2048,)) * 0.1).astype(np.float32))
    x, s = (t.to("cuda", DTYPES[dtype][0]) for t in (x, s))
    before = launches["rms_norm"]
    out = rms_norm(x, s)
    torch.cuda.synchronize()
    assert launches["rms_norm"] == before + 1
    close(out.cpu(), rms_norm_ref(x, s).cpu().numpy(), RMS_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("S,Hkv,hd", [(255, 1, 256), (130, 2, 128), (64, 8, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_on_card(S, Hkv, hd, causal, dtype):
    _need_card()
    q, k, v = (torch.from_numpy(rng.normal(size=(2, S, h, hd)).astype(np.float32))
               .to("cuda", DTYPES[dtype][0]) for h in (8, Hkv, Hkv))
    before = launches["flash_attention"]
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert launches["flash_attention"] == before + 1
    ref = flash_attention_ref(q, k, v, causal=causal)
    close(out.cpu(), ref.float().cpu().numpy(), FLASH_TOL[dtype])
