"""Model operations and bytes from a configuration file's shapes: what a
decode step needs to read, and the model FLOPs of prefill and decode
tokens.  Written from the shapes alone; nothing is read from the program."""
from __future__ import annotations

from typing import Any, Dict

from ..weights import sizes

__all__ = ["Shapes"]


class Shapes:
    def __init__(self, cfg: Dict[str, Any]) -> None:
        s = sizes(cfg)
        self.s = s
        self.item = 2 if cfg["torch_dtype"] in ("bfloat16", "float16") else 4
        L, d, H, Hkv, hd, V, ff = (s[k] for k in ("L", "d", "H", "Hkv", "hd",
                                                   "V", "ff"))
        attn = d * H * hd + 2 * d * Hkv * hd + H * hd * d
        if cfg["family"] == "moe":
            E, k, Es = s["E"], s["k"], s["Es"]
            ffn_all = (E + Es) * 3 * d * ff + d * E
            ffn_active = (k + Es) * 3 * d * ff + d * E
        else:
            ffn_all = ffn_active = 3 * d * ff
        #: parameters a token's products use (the unembedding included,
        #: the embedding lookup not)
        self.active = L * (attn + ffn_active) + d * V
        #: bytes of every weight a decode step reads
        self.weight_bytes = self.item * (L * (attn + ffn_all + 2 * d)
                                         + d * V + d)
        #: K and V bytes of one cached position, all layers
        self.kv_row_bytes = 2 * L * Hkv * hd * self.item

    def decode_step_bytes(self, length: int) -> int:
        """K/V a decode token reads at cache ``length`` (its own row
        included), and writes."""
        return self.kv_row_bytes * (length + 1) + self.kv_row_bytes

    def attn_flops(self, positions: int) -> int:
        """QK and PV products of one query over ``positions`` keys."""
        s = self.s
        return 4 * s["L"] * s["H"] * s["hd"] * positions

    def decode_token_flops(self, length: int) -> int:
        return 2 * self.active + self.attn_flops(length + 1)

    def prefill_flops(self, S: int) -> int:
        """A whole-prompt prefill: every position through the layers,
        causal attention, the unembedding at the last position only."""
        s = self.s
        body = 2 * (self.active - s["d"] * s["V"]) * S
        attn = 4 * s["L"] * s["H"] * s["hd"] * (S * (S + 1) // 2)
        return body + attn + 2 * s["d"] * s["V"]
