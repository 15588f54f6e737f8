"""Plain reference of a dense decoder-only LM (llama architecture: RMSNorm,
RoPE, causal multi-head attention, SwiGLU), in plain PyTorch, written from
the published description (deepseek-llm-7b-base's config.json and arXiv
2401.02954) and a configuration file's ``departures``.

It reads the benchmark's weight tree (``bench/weights.py``) and works in
float32, one layer at a time: a layer's weights are upcast, every sequence
passes through it, and they are freed, so the reference fits beside the
served weights.  ``precision="fp8"`` is the control: every operand of every
product (weights and activations) rounded to float8 e4m3 with a per-tensor
scale, the products and the rest in float32.

Nothing here imports the program or reads what it made.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["logits", "Precision", "ffn_dense"]

Tree = Dict[str, Any]
FP8_MAX = 448.0


class Precision:
    """Where products round: ``fp32`` (nowhere) or ``fp8`` (both operands
    to e4m3, a per-tensor scale; experts' and heads' matrices each their
    own tensor)."""

    def __init__(self, name: str) -> None:
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, t: torch.Tensor, dims: Optional[Tuple[int, ...]] = None
          ) -> torch.Tensor:
        """``t`` (float32) as the products see it."""
        if self.name == "fp32":
            return t
        amax = (t.abs().amax() if dims is None
                else t.abs().amax(dim=dims, keepdim=True))
        scale = amax.clamp(min=1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """RMSNorm with the gain stored as ``1 + scale``."""
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1 + scale)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, rotate-half convention, positions 0..N-1.
    x: [N, heads, hd]."""
    N, _, hd = x.shape
    half = hd // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(N, dtype=torch.float32, device=x.device)[:, None] * freqs
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: Tree, x: torch.Tensor, cfg: Dict[str, Any],
              prec: Precision) -> torch.Tensor:
    """Causal multi-head (grouped-query) attention of one sequence [N, d]."""
    N, d = x.shape
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = p["wq"].shape[-1]
    q = prec.mm(x, p["wq"].reshape(d, H * hd)).reshape(N, H, hd)
    k = prec.mm(x, p["wk"].reshape(d, Hkv * hd)).reshape(N, Hkv, hd)
    v = prec.mm(x, p["wv"].reshape(d, Hkv * hd)).reshape(N, Hkv, hd)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    rep = H // Hkv                  # query head g * rep + r reads KV head g
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("qhd,khd->hqk", prec.q(q), prec.q(k)) * hd ** -0.5
    mask = torch.ones(N, N, dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
    del s
    out = torch.einsum("hqk,khd->qhd", prec.q(probs), prec.q(v))
    return prec.mm(out.reshape(N, H * hd), p["wo"].reshape(H * hd, d))


def ffn_dense(p: Tree, h: torch.Tensor, cfg: Dict[str, Any],
              prec: Precision, prompt_lens: Sequence[int],
              lengths: Sequence[int]) -> torch.Tensor:
    """SwiGLU on the normed rows of every sequence, concatenated."""
    m = p["mlp"]
    g = prec.mm(h, m["w_gate"])
    return prec.mm(torch.nn.functional.silu(g) * prec.mm(h, m["w_up"]),
                   m["w_down"])


def _upcast(tree: Tree, i: int, prec: Precision, experts: bool = False
            ) -> Tree:
    """Layer ``i`` of the stacked weights in float32, as the products see
    them: a scale a matrix (an expert's matrices each their own), none for
    a norm's gain."""
    out: Tree = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _upcast(v, i, prec, experts or k == "moe")
            continue
        t = v[i].float()
        if t.dim() < 2:
            out[k] = t
        elif experts and t.dim() == 3:
            out[k] = prec.q(t, dims=(1, 2))
        else:
            out[k] = prec.q(t)
    return out


def logits(weights: Tree, cfg: Dict[str, Any],
           seqs: Sequence[Tuple[np.ndarray, int]],
           precision: str = "fp32",
           ffn: Callable[..., torch.Tensor] = ffn_dense
           ) -> List[torch.Tensor]:
    """Float32 logits [N - prompt_len + 1, V] of each sequence (its tokens,
    its prompt length) at positions ``prompt_len - 1 .. N - 1``: the
    positions whose next token was served."""
    prec = Precision(precision)
    dev = weights["emb"]["embed"].device
    eps = cfg["rms_norm_eps"]
    emb = weights["emb"]["embed"]
    toks = [torch.as_tensor(np.asarray(t, np.int64), device=dev)
            for t, _ in seqs]
    xs = [prec.q(emb[t].float(), dims=(-1,)) for t in toks]
    lengths = [len(t) for t in toks]
    prompt_lens = [int(s) for _, s in seqs]
    bounds = np.cumsum([0] + lengths)
    layers = weights["layers"]
    for i in range(cfg["num_hidden_layers"]):
        p = _upcast(layers, i, prec)
        xs = [x + attention(p["attn"], rms_norm(x, p["ln1"]["scale"], eps),
                            cfg, prec) for x in xs]
        h = torch.cat([rms_norm(x, p["ln2"]["scale"], eps) for x in xs])
        y = ffn(p, h, cfg, prec, prompt_lens, lengths)
        xs = [x + y[a:b] for x, a, b in zip(xs, bounds[:-1], bounds[1:])]
        del p, h, y
    fin = weights["final_norm"]["scale"].float()
    unemb = prec.q(weights["emb"]["unembed"].float())
    return [prec.mm(rms_norm(x[s - 1:], fin, eps), unemb)
            for x, s in zip(xs, prompt_lens)]
