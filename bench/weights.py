"""The weights a cell serves, made by the benchmark from ``--seed``.

Every leaf of the serving tree (the layout the port's transformer reads: per
layer tensors stacked on a leading L axis) is a view into one flat buffer of
its type.  The buffer is drawn from a ``torch.Generator`` on the device in a
few large ``normal_`` calls; each leaf is then scaled by 1/sqrt(fan_in), and
norm gains (stored as ``scale`` with gain ``1 + scale``) are zero.  The same
tree goes to the program and to the plain reference.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

Tree = Dict[str, Any]
#: a leaf: (shape, std, type); std 0 is a zero leaf
Leaf = Tuple[Tuple[int, ...], float, torch.dtype]

_ALIGN = 64          # elements between leaves: 128-byte aligned in bf16
_CHUNK = 1 << 30     # elements per draw


def sizes(cfg: Dict[str, Any]) -> Dict[str, int]:
    """The configuration file's sizes under short names."""
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    out = {"L": cfg["num_hidden_layers"], "d": d, "H": h,
           "Hkv": cfg["num_key_value_heads"],
           "hd": cfg.get("head_dim") or d // h, "V": cfg["vocab_size"]}
    if cfg["family"] == "moe":
        ff = cfg["moe_intermediate_size"]
        out.update(ff=ff, E=cfg["num_experts"], k=cfg["num_experts_per_tok"],
                   Es=cfg["shared_expert_intermediate_size"] // ff)
    else:
        out["ff"] = cfg["intermediate_size"]
    return out


def layout(cfg: Dict[str, Any]) -> Tree:
    """The tree of leaves for a configuration file."""
    s = sizes(cfg)
    L, d, H, Hkv, hd, V, ff = (s[k] for k in ("L", "d", "H", "Hkv", "hd",
                                               "V", "ff"))
    f32 = torch.float32
    dt = getattr(torch, cfg["torch_dtype"])
    layers: Tree = {
        "ln1": {"scale": ((L, d), 0.0, dt)},
        "attn": {"wq": ((L, d, H, hd), d ** -0.5, dt),
                 "wk": ((L, d, Hkv, hd), d ** -0.5, dt),
                 "wv": ((L, d, Hkv, hd), d ** -0.5, dt),
                 "wo": ((L, H, hd, d), (H * hd) ** -0.5, dt)},
        "ln2": {"scale": ((L, d), 0.0, dt)},
    }
    if cfg["family"] == "moe":
        E, Es = s["E"], s["Es"]
        layers["moe"] = {
            "router": ((L, d, E), d ** -0.5, f32),
            "w_gate": ((L, E, d, ff), d ** -0.5, dt),
            "w_up": ((L, E, d, ff), d ** -0.5, dt),
            "w_down": ((L, E, ff, d), ff ** -0.5, dt),
            "shared": {"w_gate": ((L, Es, d, ff), d ** -0.5, dt),
                       "w_up": ((L, Es, d, ff), d ** -0.5, dt),
                       "w_down": ((L, Es, ff, d), ff ** -0.5, dt)}}
    else:
        layers["mlp"] = {"w_gate": ((L, d, ff), d ** -0.5, dt),
                         "w_up": ((L, d, ff), d ** -0.5, dt),
                         "w_down": ((L, ff, d), ff ** -0.5, dt)}
    return {"emb": {"embed": ((V, d), d ** -0.5, dt),
                    "unembed": ((d, V), d ** -0.5, dt)},
            "layers": layers,
            "final_norm": {"scale": ((d,), 0.0, dt)}}


def _leaves(tree: Tree, path: Tuple[str, ...] = ()
            ) -> List[Tuple[Tuple[str, ...], Leaf]]:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend(_leaves(v, path + (k,)))
        else:
            out.append((path + (k,), v))
    return out


def _numel(shape: Tuple[int, ...]) -> int:
    n = 1
    for x in shape:
        n *= x
    return n


def param_bytes(cfg: Dict[str, Any]) -> int:
    """Bytes of every leaf of the configuration's tree."""
    return sum(_numel(shape) * torch.empty((), dtype=dt).element_size()
               for _, (shape, _, dt) in _leaves(layout(cfg)))


class Weights:
    """The flat buffers of a configuration's weights on ``device`` and the
    tree of views into them.  :meth:`draw` fills them from a seed in
    place, so the views (and graphs captured over them) stay valid."""

    def __init__(self, cfg: Dict[str, Any], device: torch.device) -> None:
        self.device = device
        offsets: Dict[torch.dtype, int] = {}
        placed = []
        for path, (shape, std, dt) in _leaves(layout(cfg)):
            at = offsets.get(dt, 0)
            placed.append((path, shape, std, dt, at))
            offsets[dt] = -(-(at + _numel(shape)) // _ALIGN) * _ALIGN
        self.flats = {dt: torch.empty(n, dtype=dt, device=device)
                      for dt, n in offsets.items()}
        self.tree: Tree = {}
        self._scaled = []
        for path, shape, std, dt, at in placed:
            view = self.flats[dt][at:at + _numel(shape)].view(shape)
            self._scaled.append((view, std))
            node = self.tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = view

    def draw(self, seed: int) -> "Weights":
        gen = torch.Generator(device=self.device).manual_seed(seed % (1 << 63))
        for flat in self.flats.values():
            for a in range(0, flat.numel(), _CHUNK):
                flat[a:a + _CHUNK].normal_(generator=gen)
        for view, std in self._scaled:
            if std == 0.0:
                view.zero_()
            else:
                view.mul_(std)
        return self


def make(cfg: Dict[str, Any], seed: int, device: torch.device) -> Tree:
    """The configuration's weights from ``seed`` on ``device``."""
    return Weights(cfg, device).draw(seed).tree
