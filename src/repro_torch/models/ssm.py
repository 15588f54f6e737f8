"""Mamba2 language model (attention-free): a loop over SSD blocks.

A port of ``repro.models.ssm.MambaLM``.  Parameters have the reference's
structure, per-layer tensors stacked on a leading L axis; the reference's
scan over layers becomes a loop over that axis.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .attention import IMPLS
from .layers import (Params, Spec, dtype_of, embed, embedding_specs,
                     init_from_specs, layer_params, rms_norm, unembed)
from .mamba import (init_ssm_state, mamba_block, mamba_decode_step,
                    mamba_specs)

__all__ = ["MambaLM", "param_specs"]


def param_specs(cfg: ModelConfig) -> Any:
    """The param tree for ``cfg``, one :class:`Spec` a leaf."""
    L, d = cfg.n_layers, cfg.d_model
    return {
        "emb": embedding_specs(cfg),
        "layers": {"ln": {"scale": Spec((L, d), 0.0)},
                   "mamba": mamba_specs(cfg, L)},
        "final_norm": {"scale": Spec((d,), 0.0)},
    }


class MambaLM:
    """Mamba2 LM on one device.

    ``impl`` selects the prompt's scan (``"cuda"``: the SSD kernel;
    ``"ref"``: the plain chunked scan).  ``device`` defaults to ``cuda`` and
    raises without CUDA unless ``"cpu"`` is passed.
    """

    def __init__(self, cfg: ModelConfig, impl: str = "cuda",
                 device: Optional[Union[str, torch.device]] = None) -> None:
        if cfg.family != "ssm":
            raise NotImplementedError(f"{cfg.name}: MambaLM serves the ssm "
                                      f"family, not {cfg.family!r}")
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
        self.cfg = cfg
        self.impl = impl
        self.device = resolve_device(device)

    def init_params(self, seed: int = 0) -> Params:
        """Seeded random weights, drawn on the model's device."""
        return init_from_specs(param_specs(self.cfg), dtype_of(self.cfg),
                               self.device, seed)

    def _layers(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        S = x.shape[1]
        chunk = min(self.cfg.ssm_chunk, S)
        if S % chunk:
            # the reference asserts (models/mamba.py); the port neither pads
            # nor falls back
            raise ValueError(f"{self.cfg.name}: prompt length {S} is not a "
                             f"multiple of the ssm chunk {chunk}")
        for i in range(self.cfg.n_layers):
            lp = layer_params(params["layers"], i)
            x = x + mamba_block(lp["mamba"], self.cfg, rms_norm(lp["ln"], x),
                                self.impl)
        return rms_norm(params["final_norm"], x)

    def hidden_states(self, params: Params, tokens: torch.Tensor
                      ) -> torch.Tensor:
        """Final-normed hidden states [B, S, D] of the whole sequence."""
        return self._layers(params, embed(params["emb"], tokens,
                                          self.cfg.embed_scale))

    # ---- serving ---------------------------------------------------------
    def init_decode_state(self, batch: int, max_seq: int
                          ) -> Dict[str, torch.Tensor]:
        # SSM state is O(1) in sequence length: max_seq is irrelevant
        del max_seq
        return init_ssm_state(self.cfg, batch, dtype_of(self.cfg), self.device)

    def prefill(self, params: Params, tokens: torch.Tensor, max_seq: int,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Run the prompt; returns (state, last logits).

        As in the reference (``repro.models.ssm.MambaLM.prefill``), the
        decode state is zero: decode does not start from the prompt's final
        SSM state or conv windows.  A given ``state`` (from
        :meth:`init_decode_state`) is zeroed in place and returned, so its
        addresses stay fixed; without it a fresh one is allocated.
        """
        x = self.hidden_states(params, tokens)
        logits = unembed(params["emb"], x[:, -1:, :])
        if state is None:
            return self.init_decode_state(tokens.shape[0], max_seq), logits
        for v in state.values():
            v.zero_()
        return state, logits

    def decode_step(self, params: Params, state: Dict[str, torch.Tensor],
                    tokens: torch.Tensor
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One token for every sequence. tokens: [B, 1].

        The stacked state tensors are updated in place, layer by layer, and
        returned.
        """
        cfg = self.cfg
        x = embed(params["emb"], tokens, cfg.embed_scale)
        for i in range(cfg.n_layers):
            lp = layer_params(params["layers"], i)
            st = {k: v[i] for k, v in state.items()}
            dx, new = mamba_decode_step(lp["mamba"], cfg,
                                        rms_norm(lp["ln"], x), st)
            x = x + dx
            for k, v in new.items():
                state[k][i].copy_(v)
        x = rms_norm(params["final_norm"], x)
        return state, unembed(params["emb"], x)
