"""DeepSeek LLM 7B — dense llama-arch.

[arXiv:2401.02954; hf] 30L, d_model 4096, 32H (kv=32), d_ff 11008,
vocab 102400.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=11008,
    vocab_size=102400, act="silu",
)

SMOKE = ModelConfig(
    name="deepseek-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, act="silu",
    remat=False, attn_chunk=0, loss_chunk=64,
)
