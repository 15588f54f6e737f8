"""Plain PyTorch version of the SSD-scan kernel (the CPU path and the oracle).

``ssd_chunked`` is a port of ``repro.models.mamba.ssd_chunked``, the one
copy of the chunked scan in the port: ``models/mamba.py`` imports it from
here.  ``ssd_chunk_states``, ``ssd_state_passing`` and ``ssd_chunk_outputs``
are the steps the CUDA kernels take (``csrc/ssd_scan.cu``), in plain PyTorch
for the tests: each chunk's own state, the states carried across chunks,
then y.  Their ``operand`` argument rounds each fp32 operand of a product
as the bf16 kernel's tensor cores do (``round_tf32``).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

__all__ = ["ssd_chunked", "ssd_chunk_states", "ssd_state_passing",
           "ssd_chunk_outputs", "round_tf32"]

Operand = Optional[Callable[[torch.Tensor], torch.Tensor]]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _chunks(dt: torch.Tensor, A: torch.Tensor, chunk: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt and cum = cumsum(dt * A) inside each chunk, [B, n, Q, H] fp32."""
    B, S, H = dt.shape
    if chunk < 1 or S % chunk:
        raise ValueError(f"sequence length {S} must be divisible by the ssm "
                         f"chunk {chunk}")
    dtc = dt.float().reshape(B, S // chunk, chunk, H)
    return dtc, torch.cumsum(dtc * A.float(), dim=2)


def ssd_chunk_states(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     Bc: torch.Tensor, chunk: int, operand: Operand = None
                     ) -> torch.Tensor:
    """Each chunk's own state, [B, n, H, P, N] fp32: S_c = sum_k dt_k
    exp(tot - cum_k) x_k (x) B_k, as if the chunk started from zero."""
    B, S, H, P = xh.shape
    dtc, cum = _chunks(dt, A, chunk)
    n = S // chunk
    w = dtc * torch.exp(cum[:, :, -1:, :] - cum)             # [B,n,Q,H]
    xw = xh.float().reshape(B, n, chunk, H, P) * w[..., None]
    if operand is not None:
        xw = operand(xw)
    return torch.einsum("bcqhp,bcqn->bchpn", xw,
                        Bc.float().reshape(B, n, chunk, -1))


def ssd_state_passing(states: torch.Tensor, dt: torch.Tensor,
                      A: torch.Tensor, chunk: int) -> torch.Tensor:
    """The state at the start of each chunk and after the last one, [B, n+1,
    H, P, N] fp32: h_0 = 0, h_{c+1} = exp(tot_c) h_c + S_c."""
    _, cum = _chunks(dt, A, chunk)
    decay = torch.exp(cum[:, :, -1, :])[..., None, None]     # [B,n,H,1,1]
    h = [torch.zeros_like(states[:, 0])]
    for c in range(states.shape[1]):
        h.append(decay[:, c] * h[-1] + states[:, c])
    return torch.stack(h, dim=1)


def ssd_chunk_outputs(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      Bc: torch.Tensor, Cc: torch.Tensor, h: torch.Tensor,
                      chunk: int, operand: Operand = None) -> torch.Tensor:
    """y [B, S, H, P] in xh's type from the states ``h`` [B, >=n, H, P, N] at
    the chunks' starts: (C B^T exp(cum_q - cum_k) dt_k, 0 above the
    diagonal) x, plus exp(cum_q) C h^T."""
    B, S, H, P = xh.shape
    dtc, cum = _chunks(dt, A, chunk)
    n = S // chunk
    xc = xh.float().reshape(B, n, chunk, H, P)
    Bcc = Bc.float().reshape(B, n, chunk, -1)
    Ccc = Cc.float().reshape(B, n, chunk, -1)
    operand = operand or (lambda t: t)
    above = ~torch.ones(chunk, chunk, dtype=torch.bool,
                        device=xh.device).tril()[:, :, None]
    # -inf above the diagonal before the exp, so nothing there can overflow
    diff = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).masked_fill(
        above, float("-inf"))                               # [B,n,Q,Q,H]
    CB = torch.einsum("bcqn,bckn->bcqk", Ccc, Bcc)
    M = CB[..., None] * torch.exp(diff) * dtc[:, :, None, :, :]
    y = torch.einsum("bcqkh,bckhp->bcqhp", operand(M), xc)
    y = y + (torch.einsum("bcqn,bchpn->bcqhp", Ccc, operand(h[:, :n]))
             * torch.exp(cum)[..., None])
    return y.reshape(B, S, H, P).to(xh.dtype)


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bc: torch.Tensor, Cc: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    xh: [B, S, H, P] head inputs; dt: [B, S, H] (post-softplus);
    A: [H] (negative); Bc/Cc: [B, S, N] (single group).
    Returns (y [B,S,H,P] in xh's type, final state [B,H,P,N] fp32).
    The state starts at zero; all arithmetic is fp32.  S must be a multiple
    of ``chunk``.
    """
    B, S, H, P = xh.shape
    N = Bc.shape[-1]
    dtc, cum = _chunks(dt, A, chunk)                        # [B,n,Q,H] (<=0)
    n = S // chunk
    xc = xh.float().reshape(B, n, chunk, H, P)
    Bcc = Bc.float().reshape(B, n, chunk, N)
    Ccc = Cc.float().reshape(B, n, chunk, N)

    mask = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=xh.device).tril()[None, :, :, None]
    h = torch.zeros(B, H, P, N, dtype=torch.float32, device=xh.device)
    ys = []
    for i in range(n):
        x_i, dt_i, B_i, C_i = xc[:, i], dtc[:, i], Bcc[:, i], Ccc[:, i]
        cum_i = cum[:, i]                                   # [B,Q,H]
        tot_i = cum_i[:, -1, :]                             # [B,H]
        # ---- intra-chunk (quadratic, attention-like) ----
        # L[q,k] = exp(cum[q]-cum[k]) for q>=k; above the diagonal the
        # exponent is -inf, never an overflowing exp that a select would
        # drop: the backward then multiplies by 0, not by inf (a NaN)
        diff = cum_i[:, :, None, :] - cum_i[:, None, :, :]  # [B,Q,Q,H]
        L = torch.exp(diff.masked_fill(~mask, float("-inf")))
        CB = torch.einsum("bqn,bkn->bqk", C_i, B_i)
        G = CB[..., None] * L                               # [B,Q,Q,H]
        y_intra = torch.einsum("bqkh,bkhp->bqhp", G * dt_i[:, None, :, :],
                               x_i)
        # ---- inter-chunk (read carried state) ----
        y_inter = (torch.einsum("bqn,bhpn->bqhp", C_i, h)
                   * torch.exp(cum_i)[..., None])
        # ---- state update ----
        decay_suf = torch.exp(tot_i[:, None, :] - cum_i)    # [B,Q,H]
        dB = torch.einsum("bqh,bqn->bqhn", dt_i * decay_suf, B_i)
        h = (h * torch.exp(tot_i)[:, :, None, None]
             + torch.einsum("bqhn,bqhp->bhpn", dB, x_i))
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B, S, H, P)
    return y.to(xh.dtype), h
