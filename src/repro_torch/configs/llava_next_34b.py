"""LLaVA-NeXT 34B — VLM; vision tower STUBBED (anyres patch embeddings).

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] Backbone (Yi-34B-ish):
60L, d_model 7168, 56H (kv=8), d_ff 20480, vocab 64000.  ``input_specs``
supplies 576 precomputed patch embeddings.  56 heads are padded to 64 for
the 16-way tensor-parallel axis (adaptation in DESIGN.md).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab_size=64000, head_dim=128, act="silu", rope_theta=5000000.0,
    n_patches=576,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="llava-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16, act="silu",
    n_patches=8,
    remat=False, attn_chunk=0, loss_chunk=64,
)
