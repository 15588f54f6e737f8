"""Plain PyTorch version of the SSD-scan kernel (the CPU path and the oracle).

A port of ``repro.models.mamba.ssd_chunked``, the one copy of the chunked
scan in the port: ``models/mamba.py`` imports it from here.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["ssd_chunked"]


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
    if chunk < 1 or S % chunk:
        raise ValueError(f"sequence length {S} must be divisible by the ssm "
                         f"chunk {chunk}")
    n = S // chunk
    xc = xh.float().reshape(B, n, chunk, H, P)
    dtc = dt.float().reshape(B, n, chunk, H)
    Bcc = Bc.float().reshape(B, n, chunk, N)
    Ccc = Cc.float().reshape(B, n, chunk, N)

    cum = torch.cumsum(dtc * A.float(), dim=2)              # [B,n,Q,H] (<=0)
    mask = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=xh.device).tril()[None, :, :, None]
    h = torch.zeros(B, H, P, N, dtype=torch.float32, device=xh.device)
    ys = []
    for i in range(n):
        x_i, dt_i, B_i, C_i = xc[:, i], dtc[:, i], Bcc[:, i], Ccc[:, i]
        cum_i = cum[:, i]                                   # [B,Q,H]
        tot_i = cum_i[:, -1, :]                             # [B,H]
        # ---- intra-chunk (quadratic, attention-like) ----
        # L[q,k] = exp(cum[q]-cum[k]) for q>=k; selected, never multiplied,
        # so exp overflowing above the diagonal cannot leak a NaN
        diff = cum_i[:, :, None, :] - cum_i[:, None, :, :]  # [B,Q,Q,H]
        L = torch.where(mask, torch.exp(diff), 0.0)
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
