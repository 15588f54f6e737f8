"""Mamba2 780M — attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified] 48L, d_model 1536, vocab 50280,
ssm_state 128, expand 2, head_dim 64, conv width 4.  No MLP (d_ff=0).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    pos_embed="none", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=256,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_conv=4, ssm_chunk=16,
    pos_embed="none", tie_embeddings=True,
    remat=False, attn_chunk=0, loss_chunk=64,
)
