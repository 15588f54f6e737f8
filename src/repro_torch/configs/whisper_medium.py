"""Whisper medium — encoder-decoder; conv frontend STUBBED.

[arXiv:2212.04356; unverified] 24L enc + 24L dec, d_model 1024, 16H
(kv=16), d_ff 4096, vocab 51865.  ``input_specs`` supplies precomputed
frame embeddings (post-conv).  Decoder uses learned positions extended to
max_position=32768 for the assigned decode shape (adaptation in DESIGN.md);
cross-attention KV is Whisper's fixed 1500-frame encoder output.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab_size=51865,
    is_encoder_decoder=True, n_enc_layers=24, enc_seq_ratio=4,
    pos_embed="learned", max_position=32768, act="gelu",
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256,
    is_encoder_decoder=True, n_enc_layers=2, enc_seq_ratio=4,
    pos_embed="learned", max_position=512, act="gelu",
    remat=False, attn_chunk=0, loss_chunk=64,
)
