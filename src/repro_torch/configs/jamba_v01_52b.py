"""Jamba v0.1 52B — hybrid Mamba+attention 1:7, MoE 16e top-2.

[arXiv:2403.19887; hf] 32L, d_model 4096, 32H (GQA kv=8), d_ff 14336,
vocab 65536.  Period-8 blocks: attention at in-block index 4, Mamba
elsewhere; MoE replaces the MLP on every 2nd layer.  No explicit positional
encoding (the Mamba layers carry position).  SSM uses the SSD (mamba2)
formulation for the TPU-chunked kernel — adaptation noted in DESIGN.md;
Jamba's published d_state=16 is kept.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=65536,
    n_experts=16, top_k=2, moe_every=2,
    attn_every=8, attn_offset=4,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    pos_embed="none", act="silu",
    fsdp=True,
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256,
    n_experts=4, top_k=2, moe_every=2,
    attn_every=8, attn_offset=4,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_conv=4, ssm_chunk=16,
    pos_embed="none", act="silu",
    remat=False, attn_chunk=0, loss_chunk=64,
)
