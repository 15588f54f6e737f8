"""Ambient mesh context, the per-rank ``shard_map`` and its collectives, and
process identity for trace shards.

The port of ``repro.distributed.context``.  Model code (the ``shard_map``
MoE) needs the active mesh and its data-parallel axis names; launchers set
them here (:func:`set_mesh`), and models stay runnable without a mesh.

:func:`shard_map` is a per-rank SPMD runner over a
:class:`~torch.distributed.device_mesh.DeviceMesh`: every rank of the mesh
calls it with the same global inputs; it cuts this rank's block of each by
its :class:`PartitionSpec`, runs ``f`` on the blocks, and assembles each
output by its out-spec (an ``all_gather`` over the named axes; a ``P()``
output is returned as ``f`` gave it).  Inside ``f`` the collectives
:func:`psum`, :func:`pmax`, :func:`all_gather`, :func:`ppermute` and
:func:`axis_index` take a mesh-axis name, as JAX's do, and run over
``mesh.get_group(axis)``.  A collective calls the backend at any group
size, so a one-rank mesh on the card runs the same NCCL calls as a larger
one.  The one exception is a :func:`ppermute` pair whose source and
destination are this rank: it is a local copy, since gloo cannot send to
its own rank.

The process-identity helpers (:func:`process_info`, :func:`process_tags`,
:func:`shard_path`) tag each process's
:class:`~repro_torch.core.session.TraceSession` so that JSONL shards
identify themselves to :mod:`repro_torch.obs.aggregate`.  Identity comes
from ``torch.distributed`` when a process group is initialised, else this
is process 0 of 1.  ``REPRO_PROCESS_ID`` / ``REPRO_PROCESS_COUNT`` override
both, as in the reference, so that processes launched side by side on one
host can name their shards without a process group.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import socket
from typing import Any, Callable, Dict, Iterator, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["PartitionSpec", "P", "set_mesh", "get_mesh", "dp_axes_active",
           "shard_map", "psum", "pmax", "all_gather", "ppermute",
           "axis_index", "axis_env", "local_shard", "map_specs", "mesh_shape",
           "process_info",
           "process_tags", "shard_path"]

Axis = Union[str, Tuple[str, ...], None]

_MESH = None
_DP_AXES: Tuple[str, ...] = ()
# the mesh of the shard_map body that runs now: the collectives' axis names
# are looked up in it
_AXIS_ENV: contextvars.ContextVar = contextvars.ContextVar("axis_env",
                                                           default=None)


class PartitionSpec(tuple):
    """One mesh axis (a name, a tuple of names, or None) per tensor dim,
    leading dims first; dims past its length are replicated.  A tuple, so
    a spec compares equal to the reference's ``jax.sharding.PartitionSpec``
    of the same entries; as there, a tuple of one name is that name and an
    empty tuple is None."""

    def __new__(cls, *axes: Axis) -> "PartitionSpec":
        return super().__new__(cls, (
            (a[0] if len(a) == 1 else (a or None))
            if isinstance(a, tuple) else a for a in axes))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(a) for a in self) + ")"


P = PartitionSpec


def set_mesh(mesh: Any, dp_axes: Tuple[str, ...]) -> None:
    global _MESH, _DP_AXES
    _MESH = mesh
    _DP_AXES = tuple(dp_axes)


def get_mesh() -> Any:
    return _MESH


def dp_axes_active() -> Tuple[str, ...]:
    return _DP_AXES


# --------------------------------------------------------------------------
# mesh geometry
# --------------------------------------------------------------------------
def mesh_shape(mesh: Any) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` (its ``mesh_dim_names``) or of
    anything with ``axis_names`` and a ``shape`` mapping (``MeshLayout``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _axes(axis: Axis) -> Tuple[str, ...]:
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _coord(mesh: Any, axis: Axis) -> Tuple[int, int]:
    """(this rank's block index, number of blocks) along ``axis``: a tuple
    of axes is one axis of their sizes' product, the first major, as JAX
    lays a tuple axis out."""
    idx, n = 0, 1
    for a in _axes(axis):
        size = mesh.size(mesh.mesh_dim_names.index(a))
        idx = idx * size + mesh.get_local_rank(a)
        n *= size
    return idx, n


def local_shard(t: torch.Tensor, spec: Sequence[Axis], mesh: Any
                ) -> torch.Tensor:
    """This rank's block of the global tensor ``t`` under ``spec`` on the
    ``DeviceMesh`` ``mesh``: a view where the block is contiguous (the
    whole tensor on a one-rank mesh, or a block of the leading dim), else
    a contiguous copy, so that a product on the block copies nothing at
    every call."""
    for d, axis in enumerate(spec):
        idx, n = _coord(mesh, axis)
        if n == 1:
            continue
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not divide "
                             f"into {n} blocks over {axis}")
        blk = t.shape[d] // n
        t = t.narrow(d, idx * blk, blk)
    return t.contiguous()


# --------------------------------------------------------------------------
# collectives, inside a shard_map body
# --------------------------------------------------------------------------
def _env() -> Any:
    mesh = _AXIS_ENV.get()
    if mesh is None:
        raise RuntimeError("a collective of repro_torch.distributed runs "
                           "inside a shard_map body only")
    return mesh


def axis_index(axis: Axis) -> int:
    """This rank's index along ``axis`` (a Python int: every rank runs its
    own code)."""
    return _coord(_env(), axis)[0]


def _reduce(x: torch.Tensor, axis: Axis, op: Any) -> torch.Tensor:
    mesh = _env()
    x = x.contiguous()
    for a in _axes(axis):
        dist.all_reduce(x, op=op, group=mesh.get_group(a))
    return x


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` summed over ``axis``.  An all-reduce works in place: pass a
    tensor the caller no longer needs (a product's result)."""
    return _reduce(x, axis, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``axis``, in place as
    :func:`psum`."""
    return _reduce(x, axis, dist.ReduceOp.MAX)


def _gather_dim0(x: torch.Tensor, group: Any, n: int) -> torch.Tensor:
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    # torch 2.11 has only all_gather_into_tensor; later releases deprecate
    # it for all_gather_single.
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, x.contiguous(), group=group)
    return out


def all_gather(x: torch.Tensor, axis: Axis, dim: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """The blocks of ``x`` over ``axis``, in axis order: concatenated along
    ``dim`` when ``tiled``, else stacked on a new ``dim``.  A tuple of axes
    gathers the last (minor) axis first."""
    mesh = _env()
    out = x.unsqueeze(dim) if not tiled else x
    out = out.movedim(dim, 0)
    for a in reversed(_axes(axis)):
        n = mesh.size(mesh.mesh_dim_names.index(a))
        out = _gather_dim0(out, mesh.get_group(a), n)
    return out.movedim(0, dim)


def ppermute(x: torch.Tensor, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``x`` sent from index ``i`` to index ``j`` of ``axis`` for every pair
    ``(i, j)`` of ``perm``; an index no pair sends to gets zeros, as in
    JAX.  All sends and receives of a rank go in one
    ``batch_isend_irecv`` (separate blocking sends deadlock a ring); peers
    are global ranks.  A pair ``(i, i)`` is a local copy."""
    mesh = _env()
    group = mesh.get_group(axis)
    me = mesh.get_local_rank(axis)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


# --------------------------------------------------------------------------
# shard_map
# --------------------------------------------------------------------------
def map_specs(fn: Callable[[Any, Any], Any], specs: Any, tree: Any) -> Any:
    """``fn(spec, leaf)`` over ``tree``, whose dicts and tuples the spec
    tree mirrors; a leaf may be any object (``None``, a tensor)."""
    if isinstance(specs, PartitionSpec):
        return fn(specs, tree)
    if isinstance(specs, dict):
        return {k: map_specs(fn, specs[k], tree[k]) for k in tree}
    if isinstance(specs, (tuple, list)):
        return type(tree)(map_specs(fn, s, t) for s, t in zip(specs, tree))
    raise TypeError(f"not a partition spec: {specs!r}")


def _assemble(spec: Sequence[Axis], t: Any) -> Any:
    if not isinstance(t, torch.Tensor):
        return t
    for d, axis in enumerate(spec):
        if axis is not None:
            t = all_gather(t, axis, dim=d, tiled=True)
    return t


@contextlib.contextmanager
def axis_env(mesh: Any) -> Iterator[None]:
    """Run the block with ``mesh`` as the collectives' mesh, as inside a
    :func:`shard_map` body (a caller that holds its local blocks itself)."""
    token = _AXIS_ENV.set(mesh)
    try:
        yield
    finally:
        _AXIS_ENV.reset(token)


def shard_map(f: Callable[..., Any], mesh: Any, in_specs: Any,
              out_specs: Any) -> Callable[..., Any]:
    """``f`` run per rank on this rank's blocks of global inputs, its
    outputs assembled by ``out_specs`` (see the module's docstring).
    ``in_specs`` has one entry per positional argument."""

    def run(*args: Any) -> Any:
        local = map_specs(lambda s, t: local_shard(t, s, mesh)
                           if isinstance(t, torch.Tensor) else t,
                           tuple(in_specs), tuple(args))
        with axis_env(mesh):
            out = f(*local)
            return map_specs(_assemble, out_specs, out)

    return run


# --------------------------------------------------------------------------
# process identity
# --------------------------------------------------------------------------
def process_info() -> Dict[str, Any]:
    """This process's place in the fleet (no process group -> 0 of 1)."""
    env_idx = os.environ.get("REPRO_PROCESS_ID")
    if env_idx is not None:
        idx = int(env_idx)
        count = int(os.environ.get("REPRO_PROCESS_COUNT", idx + 1))
    elif dist.is_available() and dist.is_initialized():
        idx, count = dist.get_rank(), dist.get_world_size()
    else:
        idx, count = 0, 1
    return {"host": socket.gethostname(), "process": int(idx),
            "process_count": int(count)}


def process_tags() -> Dict[str, Any]:
    """Session tags for this process: ``TraceSession(tags=process_tags())``.

    Every event the session emits then carries ``host``/``process`` in its
    ``meta``, the shard identity :mod:`repro_torch.obs.aggregate` merges by.
    """
    info = process_info()
    return {"host": info["host"], "process": info["process"]}


def shard_path(base: str) -> str:
    """Per-process JSONL shard path: ``trace.jsonl`` -> ``trace.p3.jsonl``.

    The identity for a single-process fleet, so single-host CLIs can use it
    unconditionally.
    """
    info = process_info()
    if info["process_count"] <= 1:
        return base
    root, ext = os.path.splitext(base)
    return f"{root}.p{info['process']}{ext or '.jsonl'}"
