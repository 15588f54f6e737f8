"""Llama 3 405B — dense, GQA kv=8, 128k vocab.

[arXiv:2407.21783; unverified] 126L, d_model 16384, 128H (kv=8),
d_ff 53248, vocab 128256, rope theta 500000.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_ff=53248,
    vocab_size=128256, act="silu", rope_theta=500000.0,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="llama3-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128,
    vocab_size=256, act="silu", rope_theta=500000.0,
    remat=False, attn_chunk=0, loss_chunk=64,
)
