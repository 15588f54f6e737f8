"""Mamba2 (SSD, state-space duality) block: chunked scan for the prompt,
one recurrent step per decoded token.

A port of ``repro.models.mamba``.  Projections are separate (z/x/B/C/dt), as
in the reference.  The prompt's scan goes through the SSD kernel's wrapper
(``impl="cuda"``) or the plain chunked scan (``impl="ref"``); decode has no
kernel in the reference and stays torch ops.  Decode carries the state
[B, H, P, N] in fp32 and the causal-conv windows in the model's type.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.ssd_scan.ops import ssd_scan
from ..kernels.ssd_scan.ref import ssd_chunked
from .layers import Norm, Params, Spec, rms_norm, silu, softplus

__all__ = ["mamba_specs", "mamba_block", "mamba_decode_step",
           "init_ssm_state"]


def mamba_specs(cfg: ModelConfig, n_layers: int) -> Params:
    """``repro.models.mamba.init_mamba`` as a spec tree, stacked over
    ``n_layers``.  ``A_log``, ``D`` and ``dt_bias`` are fp32 whatever the
    model's type; ``D`` starts at ones."""
    L, d, di, ns, nh, K = (n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_state,
                           cfg.ssm_heads, cfg.ssm_conv)
    s = d ** -0.5
    f32 = torch.float32
    return {
        "z_proj": Spec((L, d, di), s), "x_proj": Spec((L, d, di), s),
        "B_proj": Spec((L, d, ns), s), "C_proj": Spec((L, d, ns), s),
        "dt_proj": Spec((L, d, nh), s),
        "conv_x_w": Spec((L, K, di), 0.1), "conv_x_b": Spec((L, di), 0.0),
        "conv_B_w": Spec((L, K, ns), 0.1), "conv_B_b": Spec((L, ns), 0.0),
        "conv_C_w": Spec((L, K, ns), 0.1), "conv_C_b": Spec((L, ns), 0.0),
        "A_log": Spec((L, nh), 0.0, dtype=f32),          # A = -exp(A_log)
        "D": Spec((L, nh), 0.0, fill=1.0, dtype=f32),
        "dt_bias": Spec((L, nh), 0.0, dtype=f32),
        "norm": {"scale": Spec((L, di), 0.0)},
        "out_proj": Spec((L, di, d), di ** -0.5),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv via shifted adds. x: [B,S,C]; w: [K,C]."""
    K = w.shape[0]
    out = x * w[K - 1]
    for i in range(1, K):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[K - 1 - i]
    return silu(out + b)


def mamba_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
                impl: str = "cuda", norm: Norm = rms_norm) -> torch.Tensor:
    """Full-sequence Mamba2 block. x: [B, S, D] -> [B, S, D]; ``norm`` is
    the gated output norm's function."""
    B, S, _ = x.shape
    di, nh, hd = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    z = x @ p["z_proj"]
    xs = _causal_conv(x @ p["x_proj"], p["conv_x_w"], p["conv_x_b"])
    Bc = _causal_conv(x @ p["B_proj"], p["conv_B_w"], p["conv_B_b"])
    Cc = _causal_conv(x @ p["C_proj"], p["conv_C_w"], p["conv_C_b"])
    dt = softplus((x @ p["dt_proj"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B, S, nh, hd)
    chunk = min(cfg.ssm_chunk, S)
    if impl == "cuda":
        y, _ = ssd_scan(xh, dt, A, Bc, Cc, chunk=chunk)
    else:
        y, _ = ssd_chunked(xh, dt, A, Bc, Cc, chunk)
    y = y + xh * p["D"][None, None, :, None].to(xh.dtype)
    y = y.reshape(B, S, di).to(x.dtype)
    y = norm(p["norm"], y * silu(z))
    return y @ p["out_proj"]


# --------------------------------------------------------------------------
# decode path
# --------------------------------------------------------------------------
def init_ssm_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device: Union[str, torch.device],
                   n_layers: Optional[int] = None) -> Dict[str, torch.Tensor]:
    L = n_layers if n_layers is not None else cfg.n_layers
    nh, hd, ns, K = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv
    return {
        "h": torch.zeros(L, batch, nh, hd, ns, dtype=torch.float32,
                         device=device),
        "conv_x": torch.zeros(L, batch, K - 1, cfg.d_inner, dtype=dtype,
                              device=device),
        "conv_B": torch.zeros(L, batch, K - 1, ns, dtype=dtype, device=device),
        "conv_C": torch.zeros(L, batch, K - 1, ns, dtype=dtype, device=device),
    }


def _conv_step(window_prev: torch.Tensor, new: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One causal-conv step. window_prev: [B,K-1,C]; new: [B,C]."""
    window = torch.cat([window_prev, new[:, None, :]], dim=1)   # [B,K,C]
    out = torch.einsum("bkc,kc->bc", window, w) + b
    return silu(out), window[:, 1:]


def mamba_decode_step(p: Params, cfg: ModelConfig, x: torch.Tensor,
                      state: Dict[str, torch.Tensor], norm: Norm = rms_norm
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token Mamba2 step.

    x: [B, 1, D]; state: {h [B,H,P,N], conv_x [B,K-1,di], conv_B, conv_C}.
    Returns (y [B,1,D], new_state); ``state`` is not modified.  ``norm`` is
    the gated output norm's function.
    """
    B = x.shape[0]
    di, nh, hd = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    xt = x[:, 0]                                            # [B, D]
    z = xt @ p["z_proj"]
    xs, conv_x = _conv_step(state["conv_x"], xt @ p["x_proj"],
                            p["conv_x_w"], p["conv_x_b"])
    Bc, conv_B = _conv_step(state["conv_B"], xt @ p["B_proj"],
                            p["conv_B_w"], p["conv_B_b"])
    Cc, conv_C = _conv_step(state["conv_C"], xt @ p["C_proj"],
                            p["conv_C_w"], p["conv_C_b"])
    dt = softplus((xt @ p["dt_proj"]).float() + p["dt_bias"])   # [B,H]
    A = -torch.exp(p["A_log"])                              # [H]
    xh = xs.reshape(B, nh, hd).float()
    dA = torch.exp(dt * A[None, :])                         # [B,H]
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt, Bc.float(), xh)
    h_new = state["h"] * dA[..., None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", Cc.float(), h_new)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(B, di).to(x.dtype)
    y = norm(p["norm"], y * silu(z))
    new_state = {"h": h_new, "conv_x": conv_x, "conv_B": conv_B,
                 "conv_C": conv_C}
    return (y @ p["out_proj"])[:, None, :], new_state
