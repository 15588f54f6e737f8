"""Grok-1 314B — MoE 8 experts top-2.

[hf:xai-org/grok-1; unverified] 64L, d_model 6144, 48H (GQA kv=8),
d_ff 32768 (expert FFN), vocab 131072.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=32768,
    vocab_size=131072,
    n_experts=8, top_k=2, act="gelu",
    fsdp=True,
)

SMOKE = ModelConfig(
    name="grok-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256,
    n_experts=4, top_k=2, act="gelu",
    remat=False, attn_chunk=0, loss_chunk=64,
)
