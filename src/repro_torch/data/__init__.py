"""Deterministic synthetic data, the port's copy of ``repro.data``."""
from .pipeline import Prefetcher, SyntheticTokens, make_pipeline

__all__ = ["SyntheticTokens", "Prefetcher", "make_pipeline"]
