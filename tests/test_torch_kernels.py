"""The port's kernels against the JAX reference's kernels and oracles.

On the CPU each wrapper takes its kernel's plain PyTorch version; the tests
marked ``cuda`` launch the CUDA kernels and run only on a machine with a card
(``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_*.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dma_copy.ops import dma_copy as jax_dma_copy
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.kernels.rms_norm.ops import rms_norm_fused
from repro.kernels.rms_norm.ref import rms_norm_ref as jax_rms_ref
from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_pallas
from repro.models.attention import dense_causal_attention as jax_dense
from repro.models.mamba import ssd_chunked as jax_ssd_chunked
from repro_torch.core.dma import inline_put
from repro_torch.kernels import launches, reset_launches
from repro_torch.kernels.dma_copy.ops import dma_copy
from repro_torch.kernels.dma_copy.ref import dma_copy_ref, dma_copy_tiled
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_cost)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.rms_norm.ops import rms_norm
from repro_torch.kernels.rms_norm.ref import rms_norm_ref
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

rng = np.random.default_rng(7)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
RMS_TOL = {"float32": 2e-5, "bfloat16": 2e-2}       # tests/test_kernels.py
FLASH_TOL = {"float32": 3e-5, "bfloat16": 3e-2}
FLASH_BF16_REL_L2, FLASH_BF16_REL_MAX = 1e-2, 3e-2
SSD_TOL = {"float32": 1e-3, "bfloat16": 6e-2}


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


# (Sq, Skv): whisper's cross-attention shape cut down (17 decoder tokens
# against 100 frames), its transpose, one query, one key
CROSS_LENGTHS = [(1, 37), (17, 100), (100, 17), (9, 1)]


@pytest.mark.parametrize("Sq,Skv", CROSS_LENGTHS)
@pytest.mark.parametrize("Hkv,hd", [(4, 64), (2, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_cross_lengths_match_reference(Sq, Skv, Hkv, hd, dtype):
    """Non-causal K/V of another length than Q (cross-attention), at the
    flash tolerances, against the reference's oracle and dense attention,
    which take Sk != Sq."""
    B, H = 2, 4
    q_np = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k_np = rng.normal(size=(B, Skv, Hkv, hd)).astype(np.float32)
    v_np = rng.normal(size=(B, Skv, Hkv, hd)).astype(np.float32)
    q, qj = both(q_np, dtype)
    k, _ = both(k_np, dtype)
    v, _ = both(v_np, dtype)
    _, kj = both(np.repeat(k_np, H // Hkv, axis=2), dtype)
    _, vj = both(np.repeat(v_np, H // Hkv, axis=2), dtype)
    out = flash_attention(q, k, v, causal=False)
    assert out.dtype == q.dtype and out.shape == q.shape
    close(out, jax_flash_ref(qj, kj, vj, causal=False), FLASH_TOL[dtype])
    close(out, jax_dense(qj, kj, vj, causal=False), FLASH_TOL[dtype])


@pytest.mark.parametrize("Sq,Skv", CROSS_LENGTHS)
def test_flash_wrapper_rejects_causal_cross_lengths(Sq, Skv):
    q = torch.ones(1, Sq, 4, 64)
    k = v = torch.ones(1, Skv, 2, 64)
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, k, v, causal=True)


@pytest.mark.parametrize("Sq,Skv,causal", [(375, 1500, False), (1500, 1500, False),
                                           (375, 375, True), (7, 7, False)])
def test_flash_cost_counts_pairs_and_bytes(Sq, Skv, causal):
    """Sq * Skv query-key pairs without the mask, S(S+1)/2 with it; q, k
    and v read once at their own lengths, the output written once."""
    B, H, Hkv, hd = 4, 16, 8, 64
    q = torch.empty(B, Sq, H, hd, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, Skv, Hkv, hd, dtype=torch.bfloat16, device="meta")
    cost = flash_attention_cost(q, k, k, causal=causal)
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Skv
    assert cost.flops == 4 * B * H * hd * pairs
    assert cost.operand_bytes == 2 * (B * Sq * H * hd + 2 * B * Skv * Hkv * hd)
    assert cost.result_bytes == 2 * B * Sq * H * hd


def flash_bf16_emulated(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, block_k: int = 64) -> torch.Tensor:
    """The bf16 CUDA kernel's rounding points, in torch on the CPU: bf16
    inputs, fp32 scores, an online softmax over 64-key tiles in the log2
    domain, P rounded to bf16 before P V, fp32 accumulation, a bf16 output."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    scale_log2 = hd ** -0.5 * math.log2(math.e)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf)
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    m = torch.full((B, H, S), float("-inf"))
    l = torch.zeros(B, H, S)
    acc = torch.zeros(B, H, S, hd)
    for k0 in range(0, S, block_k):
        s = scores[..., k0:k0 + block_k]
        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
        m_use = torch.where(m_new == float("-inf"), torch.zeros(()), m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(s * scale_log2 - m_use[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.bfloat16().float(), vf[:, k0:k0 + block_k])
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("S", [61, 255])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_probabilities_within_tolerance(S, causal):
    """Rounding P to bf16 before P V (the tensor-core kernel's design) stays
    within the bf16 tolerance of the JAX oracle and of the plain version, at
    the serving path's hd=256 and Hkv=1 and a ragged S."""
    B, H, Hkv, hd = 2, 8, 1, 256
    q_np = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k_np = rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)
    v_np = rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)
    q, qj = both(q_np, "bfloat16")
    k, _ = both(k_np, "bfloat16")
    v, _ = both(v_np, "bfloat16")
    _, kj = both(np.repeat(k_np, H // Hkv, axis=2), "bfloat16")
    _, vj = both(np.repeat(v_np, H // Hkv, axis=2), "bfloat16")
    out = flash_bf16_emulated(q, k, v, causal)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert torch.isfinite(out.float()).all()
    close(out, jax_flash_ref(qj, kj, vj, causal=causal), FLASH_TOL["bfloat16"])
    close(out, flash_attention_ref(q, k, v, causal).float().numpy(),
          FLASH_TOL["bfloat16"])


# ---------------------------------------------------------------- ssd
def ssd_inputs(B, S, H, P, N, seed=0):
    """numpy inputs as the reference's sweep draws them: dt > 0, A < 0."""
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, S, H, P)).astype(np.float32),
            np.abs(r.normal(size=(B, S, H))).astype(np.float32),
            -np.abs(r.normal(size=(H,))).astype(np.float32),
            r.normal(size=(B, S, N)).astype(np.float32),
            r.normal(size=(B, S, N)).astype(np.float32))


def ssd_both(arrays, dtype):
    """(torch, jax) inputs: x, B, C in ``dtype``; dt and A stay float32."""
    x, dt, A, Bc, Cc = arrays
    (xt, xj), (bt, bj), (ct, cj) = (both(a, dtype) for a in (x, Bc, Cc))
    (dtt, dtj), (at, aj) = (both(a, "float32") for a in (dt, A))
    return (xt, dtt, at, bt, ct), (xj, dtj, aj, bj, cj)


# tests/test_kernels.py's sweep, plus its bf16 case
@pytest.mark.parametrize("B,S,H,P,N,chunk,dtype", [
    (1, 64, 2, 16, 8, 16, "float32"), (2, 128, 4, 32, 16, 32, "float32"),
    (1, 256, 8, 64, 128, 64, "float32"), (1, 128, 3, 16, 8, 128, "float32"),
    (1, 64, 2, 16, 8, 16, "bfloat16")])
def test_ssd_plain_matches_reference_and_pallas(B, S, H, P, N, chunk, dtype):
    """y and the final state against ``ssd_chunked``; y against the Pallas
    kernel in interpret mode; the wrapper on the CPU gives the plain y."""
    ours, theirs = ssd_both(ssd_inputs(B, S, H, P, N), dtype)
    y, h = ssd_chunked(*ours, chunk=chunk)
    assert y.dtype == ours[0].dtype and h.dtype == torch.float32
    y_ref, h_ref = jax_ssd_chunked(*theirs, chunk=chunk)
    close(y, y_ref, SSD_TOL[dtype])
    close(h, h_ref, SSD_TOL[dtype])
    y_pallas, none = jax_ssd_pallas(*theirs, chunk=chunk)
    close(y, y_pallas, SSD_TOL[dtype])
    y_wrap, none_wrap = ssd_scan(*ours, chunk=chunk)
    assert none is None and none_wrap is None
    assert torch.equal(y_wrap, y)


# ---------------------------------------------------------------- dma_copy
DMA_DTYPES = {"float32": (torch.float32, jnp.float32),
              "bfloat16": (torch.bfloat16, jnp.bfloat16),
              "int8": (torch.int8, jnp.int8)}


def dma_both(R, C, dtype, seed=0):
    """The same integer values (exact in every type) as torch and jax."""
    a = np.random.default_rng(seed).integers(-100, 100, size=(R, C))
    tdt, jdt = DMA_DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


# tests/test_kernels.py's shapes, in every type it covers
@pytest.mark.parametrize("mode", ["pipelined", "explicit"])
@pytest.mark.parametrize("R,C,blk", [(256, 64, 64), (1024, 128, 256),
                                     (128, 32, 128)])
@pytest.mark.parametrize("dtype", sorted(DMA_DTYPES))
def test_dma_copy_matches_pallas_exactly(mode, R, C, blk, dtype):
    x, xj = dma_both(R, C, dtype)
    out = dma_copy(x, mode=mode, block_rows=blk)
    ref = jax_dma_copy(xj, mode=mode, block_rows=blk)    # interpret mode
    assert out.dtype == x.dtype and out.shape == x.shape
    assert out.data_ptr() != x.data_ptr()
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    assert torch.equal(out, dma_copy_ref(x))


@pytest.mark.parametrize("R,C,blk", [(96, 33, 32), (99, 37, 3), (8, 5, 256)])
def test_dma_copy_tiled_ragged_tiles(R, C, blk):
    """Tiles whose byte offsets are not multiples of 16; block_rows above R
    is cut to R."""
    x, _ = dma_both(R, C, "int8", seed=1)
    for mode in ("pipelined", "explicit"):
        assert torch.equal(dma_copy(x, mode, blk), x)
    assert torch.equal(dma_copy_tiled(x, min(blk, R)), x)


@pytest.mark.parametrize("case", ["ragged_rows", "rank1", "rank3",
                                  "non_contiguous", "mode", "empty"])
def test_dma_copy_wrapper_rejects(case):
    x, blk, mode = torch.ones(64, 8), 16, "pipelined"
    if case == "ragged_rows":
        x = torch.ones(60, 8)          # 60 % 16 != 0: the reference asserts
    elif case == "rank1":
        x = torch.ones(64)
    elif case == "rank3":
        x = torch.ones(4, 16, 8)
    elif case == "non_contiguous":
        x = torch.ones(8, 64).T
    elif case == "mode":
        mode = "automatic"
    else:
        x = torch.ones(0, 8)
    with pytest.raises(ValueError):
        dma_copy(x, mode, blk)


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
    ssd_args = ssd_both(ssd_inputs(1, 16, 2, 8, 4), "float32")[0]
    assert torch.equal(ssd_scan(*ssd_args, chunk=8)[0],
                       ssd_chunked(*ssd_args, chunk=8)[0])
    assert (launches["rms_norm"] == 0 and launches["flash_attention"] == 0
            and launches["ssd_scan"] == 0)


def test_cpu_dma_copies_count_nothing():
    reset_launches()
    x = torch.arange(96, dtype=torch.int8).reshape(12, 8)
    for mode in ("pipelined", "explicit"):
        assert torch.equal(dma_copy(x, mode, 4), x)
    assert not any(launches.values())


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


@pytest.mark.parametrize("case", ["x_rank", "dt_shape", "A_shape", "C_shape",
                                  "x_dtype", "mixed_dtype", "dt_dtype",
                                  "chunk", "non_contiguous"])
def test_ssd_wrapper_rejects(case):
    x, dt, A, Bc, Cc = ssd_both(ssd_inputs(1, 32, 2, 8, 4), "float32")[0]
    chunk = 16
    if case == "x_rank":
        x = x[0]
    elif case == "dt_shape":
        dt = dt[:, :, :1].contiguous()
    elif case == "A_shape":
        A = torch.ones(3)
    elif case == "C_shape":
        Cc = Cc[:, :, :2].contiguous()
    elif case == "x_dtype":
        x, Bc, Cc = x.double(), Bc.double(), Cc.double()
    elif case == "mixed_dtype":
        Bc = Bc.bfloat16()
    elif case == "dt_dtype":
        dt = dt.bfloat16()
    elif case == "chunk":
        chunk = 12            # 32 % 12 != 0: the reference asserts
    else:
        x = x.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((ValueError, TypeError)):
        ssd_scan(x, dt, A, Bc, Cc, chunk=chunk)


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
@pytest.mark.parametrize("S,Hkv,hd", [(255, 1, 256), (130, 2, 128), (64, 8, 64)] + [
    (S, Hkv, hd) for S in (1, 17, 100, 1000) for hd in (64, 128, 256)
    for Hkv in (1, 2, 8)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Skv", CROSS_LENGTHS + [(375, 1500), (1, 1500),
                                                   (375, 1)])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_cross_lengths_on_card(Sq, Skv, hd, dtype):
    _need_card()
    q, k, v = (torch.from_numpy(rng.normal(size=(2, n, h, hd)).astype(
        np.float32)).to("cuda", DTYPES[dtype][0])
        for n, h in ((Sq, 8), (Skv, 2), (Skv, 2)))
    before = launches["flash_attention"]
    out = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert launches["flash_attention"] == before + 1
    ref = flash_attention_ref(q, k, v, causal=False).float().cpu()
    close(out.cpu(), ref.numpy(), FLASH_TOL[dtype])
    if dtype == "bfloat16":
        # a softmax over 1500 keys leaves outputs of RMS ~0.04, so bf16 is
        # also held relative to the reference's scale (rounding alone gives
        # a relative L2 of ~2.5e-3; dropping a 28-key tail tile ~0.14)
        err = out.float().cpu() - ref
        assert (err.norm() / ref.norm()).item() <= FLASH_BF16_REL_L2
        assert err.abs().max().item() <= FLASH_BF16_REL_MAX * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 512, 4, 64, 128, 256), (1, 255, 3, 64, 128, 256),
    (2, 64, 2, 16, 8, 16), (1, 128, 3, 32, 16, 128),
    (1, 4096, 48, 64, 128, 256), (2, 512, 48, 64, 128, 64),
    (3, 1280, 11, 64, 128, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_kernel_on_card(B, S, H, P, N, chunk, dtype):
    """Ragged chunks (Q = S = 255), small chunks, H = 3, P < 64, N < 128;
    16 chunks (the state passed 15 times), chunks of 64, and 165 (batch,
    chunk, head) items, not a multiple of the H100's 132 SMs."""
    _need_card()
    args = [t.to("cuda") for t in
            ssd_both(ssd_inputs(B, S, H, P, N, seed=9), dtype)[0]]
    before = launches["ssd_scan"]
    y, none = ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert none is None and launches["ssd_scan"] == before + 1
    ref, _ = ssd_chunked(*args, chunk=min(chunk, S))
    close(y.cpu(), ref.float().cpu().numpy(), SSD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["pipelined", "explicit"])
@pytest.mark.parametrize("R,C,blk,dtype", [
    (1024, 128, 256, "float32"), (256, 64, 64, "bfloat16"),
    (128, 32, 128, "int8"), (96, 33, 32, "int8"), (99, 37, 3, "int8"),
    (4096, 4096, 256, "bfloat16"), (40, 4104, 5, "bfloat16"),
    (60, 40001, 6, "int8"), (8, 16384, 1, "int8"), (3, 16385, 1, "int8"),
    (8, 32768, 2, "int8"), (3, 65537, 1, "int8")])
def test_dma_copy_kernel_on_card(mode, R, C, blk, dtype):
    """Byte-exact, with tiles of one TMA piece, of two (fewer than the
    explicit kernel's ring of four), of many (the ring wraps), tiles at
    offsets that are not multiples of 16 bytes, and tiles of exactly one and
    four pipelined slices (16 KiB each) and of one byte more."""
    _need_card()
    x = dma_both(R, C, dtype, seed=3)[0].to("cuda")
    before = launches[f"dma_copy_{mode}"]
    out = dma_copy(x, mode, blk)
    torch.cuda.synchronize()
    assert launches[f"dma_copy_{mode}"] == before + 1
    assert torch.equal(out.view(torch.uint8), x.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 17, 256, 4000, 24 * 1024 - 1, 100_000])
def test_inline_put_kernel_on_card(n):
    """The payload rides in kernel parameters: one graph replay a put, split
    across launches above one parameter block."""
    _need_card()
    x = np.random.default_rng(n).integers(0, 256, size=n, dtype=np.uint8)
    before = launches["inline_put"]
    y, rec = inline_put(x, device="cuda", _cache=False)
    assert rec.mode == "inline" and rec.nbytes == n
    assert launches["inline_put"] == before + 1
    assert np.array_equal(y.cpu().numpy(), x)
