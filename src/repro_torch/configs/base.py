"""Model configuration: a copy of ``repro.configs.base.ModelConfig``.

Every architecture gets one file in this package with its exact published
configuration (``CONFIG``) and a reduced smoke variant (``SMOKE``) derived
from the same dataclass.  The fields are the reference's, so a config can be
handed to either package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 → d_model // n_heads

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_every: int = 1           # MoE replaces the MLP every k-th layer
    capacity_factor: float = 1.25
    moe_impl: str = "sorted"     # sorted | dense (reference)

    # --- activation / norm ---------------------------------------------------
    act: str = "silu"            # silu (SwiGLU) | gelu (GeGLU)
    qk_norm: bool = False
    tie_embeddings: bool = False
    embed_scale: bool = False    # gemma-style sqrt(d_model) embed scaling

    # --- SSM (mamba2 / hybrid) ----------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256

    # --- hybrid (jamba) -------------------------------------------------------
    attn_every: int = 0          # attention layer every k-th (0 = all attn)
    attn_offset: int = 4         # position of the attn layer within the period

    # --- encoder-decoder (whisper) ---------------------------------------------
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_seq_ratio: int = 1       # encoder frames per decoder token (shape calc)

    # --- vlm (llava) -----------------------------------------------------------
    n_patches: int = 0           # stub frontend: injected patch embeddings

    # --- positional ------------------------------------------------------------
    pos_embed: str = "rope"      # rope | learned | sinusoidal
    rope_theta: float = 10000.0
    max_position: int = 1 << 20

    # --- numerics / execution ---------------------------------------------------
    param_dtype: str = "bfloat16"
    remat: bool = True           # activation checkpointing for train
    attn_chunk: int = 1024       # KV block size for the chunked causal path
    attn_tri: bool = False       # triangle-folded chunk iteration (~2x less
                                 # attention compute+traffic; see §Perf)
    loss_chunk: int = 512        # sequence chunk for CE loss
    scan_layers: bool = True

    # --- sharding hints -----------------------------------------------------------
    fsdp: bool = False           # shard weights over the data axis too
    seq_shard: bool = False      # sequence-parallel residual stream (SP)
    microbatch: int = 1          # gradient-accumulation microbatches
    pad_heads_to: int = 0        # pad n_heads for TP divisibility (0 = none)
    pad_vocab_to: int = 0        # padded vocab (0 = none)

    # -------------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_heads_padded(self) -> int:
        return self.pad_heads_to or self.n_heads

    @property
    def vocab_padded(self) -> int:
        return self.pad_vocab_to or self.vocab_size

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0:
            return False
        if self.moe_every <= 1:
            return True
        return (i % self.moe_every) == 1

    def is_attn_layer(self, i: int) -> bool:
        """hybrid only: which layers are attention (rest are SSM)."""
        if self.family != "hybrid":
            return True
        if self.attn_every <= 0:
            return True
        return (i % self.attn_every) == self.attn_offset

    # --- parameter counts (for MODEL_FLOPS) -------------------------------------
    def _attn_params(self) -> int:
        h, hk, hd, d = self.n_heads_padded, self.n_kv_heads, self.hd, self.d_model
        return d * h * hd + 2 * d * hk * hd + h * hd * d

    def _mlp_params(self, ff: Optional[int] = None) -> int:
        ff = ff or self.d_ff
        return 3 * self.d_model * ff  # gate, up, down

    def _ssm_params(self) -> int:
        d, di, st = self.d_model, self.d_inner, self.ssm_state
        nh = self.ssm_heads
        # in_proj (z, x, B, C, dt), conv, A/D, out_proj, norm
        in_p = d * (2 * di + 2 * st + nh)
        conv = (di + 2 * st) * self.ssm_conv
        out_p = di * d
        return in_p + conv + out_p + 2 * nh + di

    def param_counts(self) -> Tuple[int, int]:
        """(total_params, active_params) excluding embeddings.

        active = params touched per token (MoE: top_k + shared experts).
        """
        total = 0
        active = 0
        layers = range(self.n_layers)
        for i in layers:
            if self.family in ("hybrid",) and not self.is_attn_layer(i):
                total += self._ssm_params()
                active += self._ssm_params()
            elif self.family == "ssm":
                total += self._ssm_params()
                active += self._ssm_params()
            else:
                total += self._attn_params()
                active += self._attn_params()
            if self.family == "ssm":
                continue  # mamba2: no MLP
            if self.is_moe_layer(i):
                total += self.n_experts * self._mlp_params()
                active += self.top_k * self._mlp_params()
                if self.n_shared_experts:
                    total += self.n_shared_experts * self._mlp_params()
                    active += self.n_shared_experts * self._mlp_params()
                total += self.d_model * self.n_experts  # router
                active += self.d_model * self.n_experts
            else:
                total += self._mlp_params()
                active += self._mlp_params()
        if self.is_encoder_decoder:
            # encoder self-attn + mlp, decoder cross-attn
            enc = self.n_enc_layers * (self._attn_params() + self._mlp_params())
            cross = self.n_layers * self._attn_params()
            total += enc + cross
            active += enc + cross
        emb = self.vocab_padded * self.d_model
        total += emb if self.tie_embeddings else 2 * emb
        active += emb if self.tie_embeddings else 2 * emb
        return total, active
