"""Qwen3 8B — dense, qk_norm, GQA kv=8.

[hf:Qwen/Qwen3-8B; hf] 36L, d_model 4096, 32H (kv=8), d_ff 12288,
vocab 151936, head_dim 128.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12288,
    vocab_size=151936, head_dim=128, qk_norm=True, act="silu",
    rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=32, qk_norm=True, act="silu",
    remat=False, attn_chunk=0, loss_chunk=64,
)
