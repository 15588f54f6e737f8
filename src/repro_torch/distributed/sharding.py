"""Sharding rule engine: TP / FSDP / ZeRO-1 / sequence-parallel KV.

The port of ``repro.distributed.sharding``, with the same rule table.
Rules are keyed on parameter-tree path suffixes and resolved against the
actual leaf shapes: an axis is only assigned when the dimension divides the
mesh axis size, otherwise it is dropped (replicated) and recorded, so every
(arch x shape x mesh) cell resolves and never errors on divisibility.

The rules run over the port's trees: nested dicts (and tuples) whose leaves
have a ``shape`` (tensors, or ``models.layers.Spec``).  Path strings are
the reference's (``layers/attn/wq``; a tuple's entries by index), and dicts
are walked in sorted key order, as JAX flattens them, so ``dropped`` lists
the same entries in the same order.  The mesh is a ``DeviceMesh`` or a
:class:`~repro_torch.launch.mesh.MeshLayout` (names and sizes, no process
group: the production layouts).  :meth:`ShardingRules.to_placements` turns
a spec into DTensor placements, one per mesh dim.

Axis convention (see launch/mesh.py):
  pod    -- data-parallel across pods (multi-pod only)
  data   -- data-parallel within a pod; also FSDP/ZeRO-1 weight sharding
  model  -- tensor parallel (heads / d_ff / vocab / ssm-heads)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Sequence, Tuple, Union

from ..configs.base import ModelConfig
from .context import P, PartitionSpec, mesh_shape

__all__ = ["ShardingRules", "dp_axes", "mesh_axis_size", "to_placements"]

Axis = Union[str, Tuple[str, ...], None]


def dp_axes(mesh: Any) -> Tuple[str, ...]:
    """The data-parallel axes: ('pod', 'data') on multi-pod meshes."""
    names = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def mesh_axis_size(mesh: Any, axis: Axis) -> int:
    if axis is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(axis, str):
        return shape.get(axis, 1)
    n = 1
    for a in axis:
        n *= mesh_axis_size(mesh, a)
    return n


def _with_paths(fn: Callable[[str, Any], Any], tree: Any,
                path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over a tree, in JAX's flattening order: dict keys
    sorted, tuple entries by index.  A leaf has a ``shape`` or is not a
    container."""
    if hasattr(tree, "shape") or not isinstance(tree, (dict, tuple, list)):
        return fn("/".join(path), tree)
    if isinstance(tree, dict):
        out = {k: _with_paths(fn, tree[k], path + (str(k),))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    vals = [_with_paths(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)


# Parameter rules: (suffix regex-free match, dims spec template).
# Template entries: axis name, None, or "fsdp" (replaced by the dp axes when
# cfg.fsdp, else dropped).  Leading scan/stack dims are auto-padded with None.
_PARAM_RULES: List[Tuple[str, Tuple[Any, ...]]] = [
    # embeddings
    ("emb/embed", ("model", "fsdp")),
    ("emb/unembed", ("fsdp", "model")),
    ("pos_dec", (None, None)),
    # attention
    ("attn/wq", ("fsdp", "model", None)),
    ("attn/wk", ("fsdp", "kv_model", None)),
    ("attn/wv", ("fsdp", "kv_model", None)),
    ("attn/wo", ("model", None, "fsdp")),
    ("xattn/wq", ("fsdp", "model", None)),
    ("xattn/wk", ("fsdp", "kv_model", None)),
    ("xattn/wv", ("fsdp", "kv_model", None)),
    ("xattn/wo", ("model", None, "fsdp")),
    # dense mlp
    ("mlp/w_gate", ("fsdp", "model")),
    ("mlp/w_up", ("fsdp", "model")),
    ("mlp/w_down", ("model", "fsdp")),
    # moe (expert-internal TP baseline)
    ("moe/router", (None, None)),
    ("moe/w_gate", ("expert", "fsdp", "model")),
    ("moe/w_up", ("expert", "fsdp", "model")),
    ("moe/w_down", ("expert", "model", "fsdp")),
    ("shared/w_gate", (None, "fsdp", "model")),
    ("shared/w_up", (None, "fsdp", "model")),
    ("shared/w_down", (None, "model", "fsdp")),
    # mamba (x-path TP over d_inner / heads; B/C paths replicated)
    ("mamba/z_proj", ("fsdp", "model")),
    ("mamba/x_proj", ("fsdp", "model")),
    ("mamba/B_proj", ("fsdp", None)),
    ("mamba/C_proj", ("fsdp", None)),
    ("mamba/dt_proj", ("fsdp", "model")),
    ("mamba/conv_x_w", (None, "model")),
    ("mamba/conv_x_b", ("model",)),
    ("mamba/conv_B_w", (None, None)),
    ("mamba/conv_B_b", (None,)),
    ("mamba/conv_C_w", (None, None)),
    ("mamba/conv_C_b", (None,)),
    ("mamba/A_log", ("model",)),
    ("mamba/D", ("model",)),
    ("mamba/dt_bias", ("model",)),
    ("mamba/norm/scale", ("model",)),
    ("mamba/out_proj", ("model", "fsdp")),
    # norms & everything else: replicated
]


@dataclasses.dataclass
class ShardingRules:
    mesh: Any                     # DeviceMesh or MeshLayout
    cfg: ModelConfig
    zero1: bool = True            # shard optimizer state over dp axes
    dropped: List[str] = dataclasses.field(default_factory=list)

    # ---- helpers ------------------------------------------------------------
    def _dp(self) -> Tuple[str, ...]:
        return dp_axes(self.mesh)

    def _resolve_axis(self, token: Any) -> Axis:
        """Map a rule token to a concrete mesh axis (or None)."""
        if token is None:
            return None
        if token == "fsdp":
            if not self.cfg.fsdp:
                return None
            axes = self._dp()
            return axes if axes else None
        if token == "kv_model":
            return "model"
        if token == "expert":
            return None  # baseline: experts replicated (TP inside experts)
        return token

    def _fit(self, axis: Axis, size: int, where: str) -> Axis:
        n = mesh_axis_size(self.mesh, axis)
        if n <= 1:
            return None
        if size % n == 0:
            return axis
        self.dropped.append(f"{where}: dim {size} % axis {axis}({n}) != 0")
        # try a partial fit for tuple axes (e.g. ('pod','data') -> 'data')
        if isinstance(axis, tuple) and len(axis) > 1:
            return self._fit(axis[-1], size, where)
        return None

    def _dp_axis(self) -> Axis:
        dp = self._dp()
        return dp if len(dp) > 1 else (dp[0] if dp else None)

    # ---- parameters -----------------------------------------------------------
    def param_spec(self, path: str, shape: Sequence[int]) -> PartitionSpec:
        for suffix, dims in _PARAM_RULES:
            if path.endswith(suffix):
                nd = len(shape)
                tmpl = list(dims)
                # leading stacked dims (layers, groups) are unsharded
                pad = nd - len(tmpl)
                if pad < 0:
                    tmpl = tmpl[-nd:] if nd else []
                    pad = 0
                axes: List[Axis] = [None] * pad + [
                    self._resolve_axis(t) for t in tmpl]
                used: set = set()
                out: List[Axis] = []
                for d, ax in zip(shape, axes):
                    ax = self._fit(ax, d, path)
                    # one mesh axis may appear at most once per spec
                    key = tuple(ax) if isinstance(ax, tuple) else ax
                    if ax is not None and key in used:
                        ax = None
                    if ax is not None:
                        used.add(key)
                    out.append(ax)
                return P(*out)
        return P()  # replicate (norm scales, biases, scalars)

    def param_specs(self, params: Any) -> Any:
        return _with_paths(lambda p, leaf: self.param_spec(p, leaf.shape),
                           params)

    # ---- optimizer state (ZeRO-1) ----------------------------------------------
    def opt_spec(self, path: str, shape: Sequence[int]) -> PartitionSpec:
        """Optimizer-state leaf: param spec + dp sharding on the first
        free divisible dim (ZeRO-1).  With fsdp the param spec already
        shards over dp; nothing more to do."""
        base = self.param_spec(path, shape)
        if not self.zero1 or self.cfg.fsdp:
            return base
        dp = self._dp()
        if not dp:
            return base
        dpn = mesh_axis_size(self.mesh, dp)
        spec = list(base) + [None] * (len(shape) - len(base))
        flat_used = set()
        for ax in spec:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a:
                    flat_used.add(a)
        if any(a in flat_used for a in dp):
            return base
        for i, (d, ax) in enumerate(zip(shape, spec)):
            if ax is None and d % dpn == 0 and d >= dpn:
                spec[i] = dp if len(dp) > 1 else dp[0]
                return P(*spec)
        return base

    def opt_specs(self, params: Any) -> Any:
        return _with_paths(lambda p, leaf: self.opt_spec(p, leaf.shape),
                           params)

    # ---- activations / batches ----------------------------------------------------
    def batch_spec(self, batch_size: int) -> Axis:
        dp = self._dp()
        if not dp:
            return None
        return self._fit(dp if len(dp) > 1 else dp[0], batch_size, "batch")

    def data_specs(self, batch: Any) -> Any:
        """Input batch: shard dim0 (global batch) over dp axes."""
        def spec(_: str, leaf: Any) -> PartitionSpec:
            if not hasattr(leaf, "shape") or len(leaf.shape) == 0:
                return P()
            ax = self.batch_spec(leaf.shape[0])
            return P(*([ax] + [None] * (len(leaf.shape) - 1)))
        return _with_paths(spec, batch)

    # ---- decode state -----------------------------------------------------------------
    def state_spec(self, path: str, shape: Sequence[int]) -> PartitionSpec:
        """KV caches [.., B, S, Hkv, hd] / SSM states [.., B, H, P, N].

        Batch shards over dp when divisible.  KV heads shard over model when
        divisible; otherwise, for large caches, the *sequence* dim shards
        over model (flash-decoding layout) or data (batch=1 long-context).
        """
        name = path.split("/")[-1]
        nd = len(shape)
        spec: List[Axis] = [None] * nd
        if name in ("k", "v", "xk", "xv"):
            # [..., B, S, Hkv, hd]
            b_i, s_i, h_i = nd - 4, nd - 3, nd - 2
            dp = self._dp()
            batch_ax = self._fit(self._dp_axis(), shape[b_i], path)
            spec[b_i] = batch_ax
            if shape[h_i] % mesh_axis_size(self.mesh, "model") == 0:
                spec[h_i] = "model"
            else:
                spec[s_i] = "model" if shape[s_i] % mesh_axis_size(
                    self.mesh, "model") == 0 else None
            if batch_ax is None and dp:
                # batch=1 long-context: shard sequence over data too
                data_fit = self._fit("data", shape[s_i], path)
                if spec[s_i] == "model" and data_fit:
                    spec[s_i] = ("data", "model")
                elif data_fit and spec[s_i] is None:
                    spec[s_i] = "data"
            return P(*spec)
        if name == "h":
            # [..., B, H, P, N]
            b_i, h_i = nd - 4, nd - 3
            spec[b_i] = self._fit(self._dp_axis(), shape[b_i], path)
            spec[h_i] = self._fit("model", shape[h_i], path)
            return P(*spec)
        if name in ("conv_x",):
            b_i, c_i = nd - 3, nd - 1
            spec[b_i] = self._fit(self._dp_axis(), shape[b_i], path)
            spec[c_i] = self._fit("model", shape[c_i], path)
            return P(*spec)
        if name in ("conv_B", "conv_C"):
            b_i = nd - 3
            spec[b_i] = self._fit(self._dp_axis(), shape[b_i], path)
            return P(*spec)
        return P()  # length scalar etc.

    def state_specs(self, state: Any) -> Any:
        return _with_paths(lambda p, leaf: self.state_spec(p, leaf.shape),
                           state)


def to_placements(spec: Sequence[Axis], mesh: Any) -> List[Any]:
    """One DTensor placement per mesh dim: ``Shard(d)`` where tensor dim
    ``d`` of ``spec`` names that mesh axis, else ``Replicate()``.  A tuple
    axis shards one tensor dim over several mesh dims, the first major, as
    JAX does; DTensor orders such shards by mesh dim, so the tuple must
    name them in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_shape(mesh))
    out: List[Any] = [Replicate() for _ in names]
    for d, axis in enumerate(spec):
        axes = (axis,) if isinstance(axis, str) else tuple(axis or ())
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"{spec}: axes {axes} are not in the mesh's "
                             f"order {tuple(names)}")
        for i in order:
            out[i] = Shard(d)
    return out
