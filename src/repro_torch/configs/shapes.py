"""Assigned input shapes (LM-family: seq_len × global_batch) and serving
geometry: the port's copy of ``repro.configs.shapes``."""
from __future__ import annotations

import dataclasses
from typing import Dict

from .base import ModelConfig

__all__ = ["ShapeConfig", "SHAPES", "ServeShape", "SERVE_SHAPES",
           "kv_geometry", "applicable", "skip_reason"]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ServeShape:
    """Serving-engine geometry: KV slots × sequence budget × page layout.

    ``kv_page_tokens`` is the paged-backend page size (tokens per page);
    ``prefill_chunk`` bounds a single prefill launch (0 = whole-prompt).
    These are the serving analogue of :class:`ShapeConfig` — the loadtest
    CLI and the tuner resolve their defaults from here.
    """

    name: str
    slots: int
    max_seq: int
    kv_page_tokens: int
    prefill_chunk: int = 0

    def geometry(self) -> "tuple[int, int]":
        return kv_geometry(self.max_seq, self.kv_page_tokens, self.slots)


SERVE_SHAPES: Dict[str, ServeShape] = {
    "chat_smoke": ServeShape("chat_smoke", 4, 64, 16, 8),
    "chat_4k": ServeShape("chat_4k", 64, 4096, 64, 512),
    "longform_32k": ServeShape("longform_32k", 16, 32768, 128, 1024),
}


def kv_geometry(max_seq: int, page_tokens: int, slots: int
                ) -> "tuple[int, int]":
    """(blocks per slot, default pool pages) for a paged KV layout.

    The default pool holds every slot fully grown (plus the reserved
    scratch page slot 0 adds on top), so page exhaustion cannot occur
    unless the pool is explicitly shrunk — which keeps the paged backend
    token-identical to dense under any workload at default settings.
    """
    if page_tokens <= 0:
        raise ValueError(f"kv_page_tokens must be positive, got {page_tokens}")
    if max_seq % page_tokens:
        raise ValueError(
            f"max_seq={max_seq} is not a multiple of kv_page_tokens="
            f"{page_tokens}; the block table would need a ragged last page")
    n_blocks = max_seq // page_tokens
    return n_blocks, slots * n_blocks


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str:
    """Empty string if the (arch, shape) cell runs; else why it is skipped."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return ("long_500k requires sub-quadratic attention; "
                f"{cfg.name} is a pure full-attention arch (skip per spec)")
    return ""


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    return not skip_reason(cfg, shape)
