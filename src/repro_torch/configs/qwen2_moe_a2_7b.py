"""Qwen1.5-MoE-A2.7B — 60 routed experts top-4 + 4 shared.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf] 24L, d_model 2048, 16H (kv=16),
expert d_ff 1408 (shared-expert capacity 4x1408 = 5632), vocab 151936.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=151936,
    n_experts=60, top_k=4, n_shared_experts=4, act="silu",
)

SMOKE = ModelConfig(
    name="qwen2-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
    vocab_size=256,
    n_experts=8, top_k=4, n_shared_experts=2, act="silu",
    remat=False, attn_chunk=0, loss_chunk=64,
)
