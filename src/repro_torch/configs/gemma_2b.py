"""Gemma 2B — dense, GeGLU, MQA (kv=1), head_dim 256.

[arXiv:2403.08295; hf] 18L, d_model 2048, 8H, d_ff 16384, vocab 256000.
Tied embeddings with sqrt(d_model) input scaling.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab_size=256000, head_dim=256,
    act="gelu", tie_embeddings=True, embed_scale=True,
)

SMOKE = ModelConfig(
    name="gemma-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab_size=256, head_dim=32,
    act="gelu", tie_embeddings=True, embed_scale=True,
    remat=False, attn_chunk=0, loss_chunk=64,
)
