"""Operations and bytes of the port's kernels at a call's shape: frozen
copies of ``flash_attention_cost`` (``kernels/flash_attention/ops.py``) and
``rms_norm_cost`` (``kernels/rms_norm/ops.py``), on shapes instead of
tensors, so that a change to the program cannot move the yardstick."""
from __future__ import annotations

from typing import Tuple

__all__ = ["flash_attention_cost", "rms_norm_cost", "bound_s"]


def flash_attention_cost(B: int, Sq: int, Skv: int, H: int, Hkv: int,
                         hd: int, item: int, causal: bool = True
                         ) -> Tuple[int, int]:
    """(operations, bytes): q, k and v read, the output written; two
    products of 2 * hd operations over the query-key pairs of every head:
    S(S+1)/2 causal, Sq * Skv otherwise."""
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Skv
    q = B * Sq * H * hd
    kv = B * Skv * Hkv * hd
    return 4 * B * H * hd * pairs, (q + 2 * kv) * item + q * item


def rms_norm_cost(rows: int, D: int, item: int) -> Tuple[int, int]:
    """(operations, bytes): x and scale read, the output written; no
    operation is counted (the bound is the bytes)."""
    nbytes = rows * D * item
    return 0, nbytes + D * item + nbytes


def bound_s(ops: float, nbytes: float, peak_flops: float,
            peak_bytes: float) -> float:
    """The least time the chip could take: the larger of the two terms."""
    return max(ops / peak_flops, nbytes / peak_bytes)
