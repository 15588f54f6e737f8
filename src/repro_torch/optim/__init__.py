"""Optimizer, schedule and gradient compression: the port's copy of
``repro.optim``, written for CUDA Graph capture (in-place updates, no host
read)."""
from .adamw import (AdamWState, adamw_init, adamw_update, adamw_update_,
                    clip_by_global_norm, global_norm)
from .compression import (ErrorFeedbackState, compress_int8, decompress_int8,
                          ef_compress_update, ef_compress_update_, ef_init)
from .schedule import cosine_schedule, linear_warmup

__all__ = [
    "AdamWState", "adamw_init", "adamw_update", "adamw_update_",
    "clip_by_global_norm", "global_norm",
    "cosine_schedule", "linear_warmup",
    "compress_int8", "decompress_int8",
    "ErrorFeedbackState", "ef_init", "ef_compress_update",
    "ef_compress_update_",
]
