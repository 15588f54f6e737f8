"""Multi-pod dry-run: record every (arch x shape x mesh) cell's rank-0
program on a fake 256- or 512-rank mesh.

The port of ``repro.launch.dryrun``.  The reference lowers each cell with
``jax.jit(...).lower().compile()`` on 512 placeholder host devices and
reads the per-device HLO.  The port's counterpart of GSPMD is DTensor: for
each cell this

  1. builds the published config (``--arch``) resolved to the model axis,
     and the assigned input shape (``--shape``),
  2. resolves the sharding rules (TP/FSDP/ZeRO-1/SP, ``ShardingRules``)
     against the production layout and makes the params, the ZeRO-1
     moments, the decode state and the batch DTensors over a fake process
     group (``torch.testing._internal.distributed.fake_pg``) of world 256
     (512) at rank 0, their local shards by ``to_placements``,
  3. records one run of the step through ``CommandStreamCapture``: the op
     recorder (``core/stream.py``) charges what rank 0 runs, at its local
     shards' shapes, with DTensor's collectives under the reference's
     opcodes and link bytes at their group's size; on ``meta`` each layer
     stack as the reference's scan body, a weighted layer standing for the
     layers that run its program (:func:`dry_cell`),
  4. derives the three-term roofline on the H100 (``core/roofline.py``),
  5. appends a JSON record to the results file (resumable; reruns skip
     completed cells).

The model is the plain route (``get_model(cfg, impl="ref")``, the
reference dry-run's default: plain attention, scan and norms): the kernel
wrappers need a data pointer, which a DTensor does not have.  DTensor
shards the ops; the few it cannot are handled below, and an op that
neither shards fails the cell, named in the error.  The record counts the
ops that ran on gathered operands (``replicated_ops``).  On ``meta`` (the default) nothing is
allocated, as the reference's placeholders allocate nothing: ``memory``
holds the local shards' argument and output bytes and no temp bytes.
With ``--device cuda`` the rank-0 program of a cell runs on the card: the
local shards are real tensors with random values (nothing is compared by
value), the step is captured as one CUDA Graph, and the record carries the
decoded graph (``graph_stream``) and the graph pool's bytes as temp bytes.
The fake group's collectives move nothing.  Should a capture fail, the
cell runs eagerly, and ``graph_stream`` is null beside the reason.

The numbers are the per-device roofline of the rank-0 program, not a
multi-card time.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--mesh both] [--device cuda]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..configs import ARCHS, SHAPES, resolve, skip_reason
from ..configs.base import ModelConfig
from ..configs.shapes import ShapeConfig
from ..core import (CommandStreamCapture, TraceSession, analyze, attribute,
                    model_flops)
from ..core.stream import hide_frames, mark, weighted_stacks
from ..distributed.context import P
from ..distributed.sharding import ShardingRules, dp_axes, to_placements
from ..models import get_model, param_specs
from ..models.layers import dtype_of, map_params
from ..optim.adamw import AdamWState
from ..runtime.steps import (make_decode_step, make_input_specs,
                             make_prefill_step, make_train_step)
from .mesh import MeshLayout

__all__ = ["RESULTS_DEFAULT", "ATTRIBUTION_TAGS", "fake_mesh",
           "release_fake_mesh", "cell_skip", "dry_cell", "dry_pp_cell",
           "run_cell", "run_pp_cell", "main"]

RESULTS_DEFAULT = "results/dryrun_torch.jsonl"

#: the fake group's backend on every device a local shard may live on
_FAKE_BACKEND = "cpu:fake,cuda:fake,meta:fake"

#: attribution tags: the plain functions whose frames an entry's
#: ``op_path`` holds (the reference tags einsum specs of JAX op names)
ATTRIBUTION_TAGS: Dict[str, Tuple[str, ...]] = {
    "attention_interior": ("dense_causal_attention",
                           "chunked_causal_attention",
                           "triangle_chunked_attention", "cached_attention"),
    "ssd_interior": ("ssd_chunk_states", "ssd_state_passing",
                     "ssd_chunk_outputs"),
    "moe": ("moe_sorted", "moe_dense"),
    "loss": ("cross_entropy_loss",),
}

_FAKE: Dict[str, Any] = {}

hide_frames(__file__)       # the DTensor handlers below


def fake_mesh(multi_pod: bool = False,
              sizes: Optional[Sequence[int]] = None) -> Any:
    """A ``DeviceMesh`` of the production layout (or of ``sizes``) over a
    fake process group at rank 0, which this process starts or reuses.
    A group of another kind running already raises; a fake group of
    another size is replaced."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    layout = (MeshLayout.of(*_data_model(sizes)) if sizes is not None
              else MeshLayout.production(multi_pod))
    # a cuda mesh on every device: the program recorded is the card's (on
    # a cpu mesh DTensor would gather where the card runs an all-to-all)
    key = layout.sizes
    if _FAKE.get("key") == key and dist.is_initialized():
        return _FAKE["mesh"]
    if dist.is_initialized():
        if not _FAKE:
            raise RuntimeError("fake_mesh: a process group of backend "
                               f"{dist.get_backend()} is running")
        dist.destroy_process_group()
    _FAKE.clear()
    dist.init_process_group(_FAKE_BACKEND, rank=0, world_size=layout.size,
                            store=FakeStore())
    mesh = init_device_mesh("cuda", layout.sizes,
                            mesh_dim_names=layout.axis_names)
    _FAKE.update(key=key, mesh=mesh)
    return mesh


def _data_model(sizes: Sequence[int]) -> Tuple[int, int, int]:
    """(data, model, pod) of a mesh's sizes, for ``MeshLayout.of``."""
    if len(sizes) == 3:
        return sizes[1], sizes[2], sizes[0]
    return sizes[0], sizes[1], 1


def release_fake_mesh() -> None:
    """Destroy the fake group this module started, if any."""
    if _FAKE and dist.is_initialized():
        dist.destroy_process_group()
    _FAKE.clear()


# ---------------------------------------------------------------- sharding
def _local(shape: Sequence[int], dtype: torch.dtype, spec: Any, mesh: Any,
           dev: torch.device, fill: str) -> Any:
    """A DTensor of global ``shape`` sharded by ``spec``: its local shard
    empty on ``meta``, else filled (``fill``: ``randn``, ``zeros`` or
    ``tokens:<vocab>``)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    placements = to_placements(spec, mesh)
    local_shape, _ = compute_local_shape_and_global_offset(
        tuple(shape), mesh, placements)
    if dev.type == "meta":
        t = torch.empty(local_shape, dtype=dtype, device=dev)
    elif fill == "zeros":
        t = torch.zeros(local_shape, dtype=dtype, device=dev)
    elif fill.startswith("tokens:"):
        t = torch.randint(0, int(fill[7:]), local_shape, dtype=dtype,
                          device=dev)
    else:
        t = (torch.randn(local_shape, device=dev) * 0.02).to(dtype)
    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _distribute(tree: Any, specs: Any, mesh: Any, dev: torch.device,
                fill: Any) -> Any:
    """The leaves of ``tree`` (``meta`` tensors: shapes and types) as
    DTensors by ``specs``, a tree of ``PartitionSpec`` like it;
    ``fill(path, leaf)`` names each local shard's fill."""
    def walk(t: Any, s: Any, path: str) -> Any:
        if isinstance(t, dict):
            return {k: walk(t[k], s[k], f"{path}/{k}") for k in t}
        return _local(t.shape, t.dtype, s, mesh, dev, fill(path, t))
    return walk(tree, specs, "")


def _float_fill(path: str, leaf: Any) -> str:
    return "randn" if leaf.dtype.is_floating_point else "zeros"


def _param_tree(cfg: ModelConfig) -> Any:
    """The params' shapes and types as ``meta`` tensors: nothing drawn."""
    dtype = dtype_of(cfg)
    return map_params(lambda s: torch.empty(s.shape, dtype=s.dtype or dtype,
                                            device="meta"), param_specs(cfg))


# ---------------------------------------------------------------- DTensor
# The port's models are written for one device.  DTensor shards most of
# their ops itself; for the few it cannot, the dry-run installs handlers
# (DTensor's own ``_custom_op_handlers``) while a cell runs:
#
# * ``index_put_`` (the decode's cache write at each sequence's row) writes
#   this rank's block: the index entries follow the values' rows, which
#   take self's sharding of dim 0 (entry i writes row i, as the decode's
#   ``arange(B)`` rows do), and an index into another sharded dim is
#   shifted to the local block, a write outside it keeping the row's value;
# * ``gather`` along a sharded dim (the loss's gold logit over the
#   vocab-sharded logits, the MoE's sort) gathers locally where the index
#   falls in this rank's block, zero elsewhere, and sums the blocks, one
#   all-reduce (DTensor's own masked partial fails on a 3-d index); a
#   pending sum in the gathered tensor is scattered first;
# * ``index`` into a table split by rows (the embedding lookup, which
#   DTensor refuses on the card's torch where the ids are split over two
#   mesh dims) looks up locally and sums the blocks, as ``gather`` does;
# * ``constant_pad_nd`` (the causal conv's shift) pads each block, a split
#   padded dim gathered first, which the card's torch fails to plan;
# * ``index_put`` out of place with ``accumulate`` (the embedding lookup's
#   backward) adds each rank's values into its block, a pending sum, as
#   GSPMD's local scatter-add (the card's torch has no sharding for it);
# * ``flip`` (a cumulative sum's backward) flips each block, a split
#   flipped dim gathered first (the card's torch has no sharding for it);
# * ``view`` / ``_unsafe_view`` that DTensor refuses (an uneven unflatten;
#   on the card's torch a flatten of two split dims) take their input
#   gathered over a mesh dim that splits it, as GSPMD reshards a reshape
#   it cannot split;
# * ``scatter_`` / ``scatter`` (the MoE's slot tables, made whole on one
#   device) run on replicated operands, after all-gathers, as GSPMD gathers
#   what it cannot shard; an in-place op then keeps its own block of the
#   result.
#
# The record counts the ops that ran on gathered operands
# (``replicated_ops``, by op).
#
# Every other op goes to DTensor's own sharding; an op it cannot shard
# fails the cell, the op named in the error (:func:`_failed_op`).


def _dtensor() -> Any:
    from torch.distributed.tensor import DTensor
    return DTensor


def _replicate(x: Any) -> Any:
    from torch.distributed.tensor import Replicate
    if isinstance(x, _dtensor()):
        return x.redistribute(x.device_mesh,
                              [Replicate()] * x.device_mesh.ndim
                              ).to_local().contiguous()
    return x


def _block(t: Any, placements: Sequence[Any], mesh: Any
           ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(local shape, global offset) of ``t``'s block under ``placements``:
    host arithmetic, kept out of a recording."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        shape, off = compute_local_shape_and_global_offset(
            tuple(t.shape), mesh, list(placements))
    return tuple(shape), tuple(off)


def _on_replicas(op: Any, args: tuple, kwargs: dict) -> Any:
    """``op`` on replicated copies of its DTensor operands; an in-place op
    keeps its own block of the result, an out-of-place one returns it
    replicated.  Counted in ``_GATHERED``."""
    from torch.distributed.tensor import Replicate
    from torch.utils._pytree import tree_map
    DT = _dtensor()
    mesh = next(a.device_mesh for a in args if isinstance(a, DT))
    with _gathering(op):
        largs = tree_map(_replicate, args)
        out = op(*largs, **tree_map(_replicate, kwargs))
    if op._schema.is_mutable:
        me = args[0]
        if not isinstance(me, DT):       # a plain self took the op whole
            return me
        shape, off = _block(me, me.placements, mesh)
        whole = largs[0]
        for d, (n, o) in enumerate(zip(shape, off)):
            whole = whole.narrow(d, o, n)
        me.to_local().copy_(whole)
        return me
    rep = [Replicate()] * mesh.ndim
    return tree_map(lambda t: DT.from_local(t, mesh, rep, run_check=False)
                    if isinstance(t, torch.Tensor) else t, out)


def _index_put_(op: Any, args: tuple, kwargs: dict) -> Any:
    from torch.distributed.tensor import Replicate, Shard
    me, indices, values = args[:3]
    accumulate = args[3] if len(args) > 3 else kwargs.get("accumulate",
                                                          False)
    mesh = me.device_mesh
    k = len(indices)
    want = []
    for p in me.placements:
        if p.is_shard() and p.dim >= k:
            want.append(Shard(p.dim - k + 1))      # a dim the values carry
        elif p.is_shard() and p.dim == 0:
            want.append(Shard(0))                  # the entries follow
        else:
            want.append(Replicate())
    if not isinstance(values, _dtensor()):
        values = _dtensor().from_local(values, mesh,
                                       [Replicate()] * mesh.ndim,
                                       run_check=False)
    values = values.redistribute(mesh, want)
    vloc = values.to_local()
    _, voff = _block(values, want, mesh)
    shape, off = _block(me, me.placements, mesh)
    local = me.to_local()
    sharded = {p.dim for p in me.placements if p.is_shard()}
    split = any(isinstance(p, Shard) and p.dim == 0 for p in want)
    lidx, ok = [], None
    for d, ix in enumerate(indices):
        ix = _replicate(ix).expand(values.shape[:1])
        if split:
            ix = ix.narrow(0, voff[0], vloc.shape[0])
        if d in sharded:
            ix = ix - off[d]
            if d:
                inside = (ix >= 0) & (ix < shape[d])
                ok = inside if ok is None else ok & inside
                ix = ix.clamp(0, shape[d] - 1)
        lidx.append(ix)
    if ok is not None:
        keep = (torch.zeros((), dtype=vloc.dtype, device=vloc.device)
                if accumulate else local[tuple(lidx)])
        vloc = torch.where(ok.reshape(ok.shape + (1,) * (vloc.dim() - 1)),
                           vloc, keep)
    local.index_put_(tuple(lidx), vloc, accumulate)
    return me


def _gather(op: Any, args: tuple, kwargs: dict) -> Any:
    from torch.distributed.tensor import Partial, Replicate, Shard
    me, dim, index = args[:3]
    dim %= me.dim()
    mesh = me.device_mesh
    if any(p.is_partial() for p in me.placements):
        # a pending sum is scattered first: over the index's own dim where
        # the index is split on that mesh dim, else over the gathered dim
        ip = (index.placements if isinstance(index, _dtensor())
              else [Replicate()] * mesh.ndim)
        me = me.redistribute(mesh, [
            (Shard(ip[m].dim) if ip[m].is_shard() and ip[m].dim != dim
             else Shard(dim)) if p.is_partial() else p
            for m, p in enumerate(me.placements)])
        args = (me,) + tuple(args[1:])
    over = [m for m, p in enumerate(me.placements)
            if p.is_shard() and p.dim == dim]
    if not over:
        return _default(op, args, kwargs)
    want = [Replicate() if m in over else p
            for m, p in enumerate(me.placements)]
    if not isinstance(index, _dtensor()):
        index = _dtensor().from_local(index, mesh, [Replicate()] * mesh.ndim,
                                      run_check=False)
    index = index.redistribute(mesh, want)
    shape, off = _block(me, me.placements, mesh)
    ix = index.to_local() - off[dim]
    inside = (ix >= 0) & (ix < shape[dim])
    got = me.to_local().gather(dim, ix.clamp(0, shape[dim] - 1))
    got = torch.where(inside, got, torch.zeros((), dtype=got.dtype,
                                               device=got.device))
    out = [Partial() if m in over else p for m, p in enumerate(want)]
    # the partial sum reduced at once: DTensor's integer arithmetic on a
    # pending sum can change its type
    return _dtensor().from_local(got, mesh, out, run_check=False,
                                 shape=index.shape, stride=index.stride()
                                 ).redistribute(mesh, want)


_HANDLERS: Dict[Any, Any] = {}

#: the ops that ran on gathered operands in the cell running: each
#: handler's call as (op, the recorder's position before and after it)
_GATHERED: List[Tuple[str, Optional[int], Optional[int]]] = []


@contextlib.contextmanager
def _gathering(op: Any) -> Iterator[None]:
    """A handler's gather and its op, kept in ``_GATHERED`` with the
    entries they record (``replicated_ops``)."""
    at = mark()
    yield
    _GATHERED.append((str(op), at, mark()))


def replicated_ops(entries: Sequence[Any]) -> Dict[str, int]:
    """The record's ``replicated_ops``: the recorded calls of ``_GATHERED``
    by op, each counted at its first entry's multiplier (a weighted body's
    call stands for the layers the body does)."""
    out: Dict[str, int] = {}
    for op, at, end in _GATHERED:
        if at is not None and end is not None and end > at:
            out[op] = out.get(op, 0) + entries[at].multiplier
    return out

#: the views DTensor refused in the cell running, by (op, shape,
#: placements, size): the mesh dims whose gather let each through
_VIEW_GATHER: Dict[Any, List[int]] = {}


def _default(op: Any, args: tuple, kwargs: dict) -> Any:
    """``op`` through DTensor's own sharding, the handler set aside."""
    table = _dtensor()._op_dispatcher._custom_op_handlers
    mine = table.pop(op)
    try:
        return op(*args, **kwargs)
    finally:
        table[op] = mine


def _index(op: Any, args: tuple, kwargs: dict) -> Any:
    """An embedding lookup (``table[ids]``) into a table split by rows:
    each rank looks up the ids that fall in its rows, zero elsewhere, and
    the blocks are summed, one all-reduce; the table is gathered on a mesh
    dim that also splits the ids.  Any other ``index`` is DTensor's."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    DT = _dtensor()
    me, indices = args[0], args[1]
    if not (isinstance(me, DT) and len(indices) == 1
            and indices[0] is not None
            and any(p.is_shard() and p.dim == 0 for p in me.placements)):
        return _default(op, args, kwargs)
    mesh = me.device_mesh
    ids = indices[0]
    if not isinstance(ids, DT):
        ids = DT.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                            run_check=False)
    me = me.redistribute(mesh, [Replicate() if q.is_shard() else p
                                for p, q in zip(me.placements,
                                                ids.placements)])
    over = [m for m, p in enumerate(me.placements)
            if p.is_shard() and p.dim == 0]
    if not over:
        return _default(op, (me, [ids]) + tuple(args[2:]), kwargs)
    shape, off = _block(me, me.placements, mesh)
    ix = ids.to_local() - off[0]
    inside = (ix >= 0) & (ix < shape[0])
    got = me.to_local()[ix.clamp(0, shape[0] - 1)]
    got = torch.where(inside.reshape(inside.shape + (1,) * (got.dim()
                                                             - ix.dim())),
                      got, torch.zeros((), dtype=got.dtype,
                                       device=got.device))
    placed = []
    for m, (p, q) in enumerate(zip(me.placements, ids.placements)):
        if m in over:
            placed.append(Partial())
        elif q.is_shard():
            placed.append(Shard(q.dim))
        elif p.is_shard():
            placed.append(Shard(p.dim - 1 + ids.dim()))
        else:
            placed.append(Replicate())
    shape_out = tuple(ids.shape) + tuple(me.shape[1:])
    stride = torch.empty(shape_out, device="meta").stride()
    return DT.from_local(got, mesh, placed, run_check=False,
                         shape=torch.Size(shape_out), stride=stride
                         ).redistribute(mesh, [Replicate() if m in over
                                               else p for m, p in
                                               enumerate(placed)])


def _pad(op: Any, args: tuple, kwargs: dict) -> Any:
    """``constant_pad_nd`` (the causal conv's shift along the sequence):
    each rank pads its block, the placements kept.  A pending sum is
    reduced first, and a padded dim that a mesh dim splits is gathered
    over it first (GSPMD would trade the halo's rows; counted in
    ``_GATHERED``)."""
    from torch.distributed.tensor import Replicate
    me, pad = args[0], list(args[1])
    value = args[2] if len(args) > 2 else kwargs.get("value", 0)
    DT = _dtensor()
    if not isinstance(me, DT):
        return _default(op, args, kwargs)
    padded = {me.dim() - 1 - i // 2 for i, n in enumerate(pad) if n}
    split = [p.is_shard() and p.dim in padded for p in me.placements]
    want = [Replicate() if s or p.is_partial() else p
            for p, s in zip(me.placements, split)]
    with _gathering(op) if any(split) else contextlib.nullcontext():
        if want != list(me.placements):
            me = me.redistribute(me.device_mesh, want)
    shape = list(me.shape)
    for i in range(0, len(pad), 2):
        shape[me.dim() - 1 - i // 2] += pad[i] + pad[i + 1]
    local = torch.constant_pad_nd(me.to_local(), pad, value)
    return DT.from_local(local, me.device_mesh, me.placements,
                         run_check=False, shape=torch.Size(shape),
                         stride=torch.empty(shape, device="meta").stride())


def _flip(op: Any, args: tuple, kwargs: dict) -> Any:
    """``flip`` (a cumulative sum's backward): each rank flips its block, a
    flipped dim that a mesh dim splits gathered over it first (DTensor
    2.13's own rule, which the card's torch lacks; counted in
    ``_GATHERED``)."""
    from torch.distributed.tensor import Replicate
    me, dims = args[0], args[1]
    DT = _dtensor()
    if not isinstance(me, DT):
        return _default(op, args, kwargs)
    dims = [d % me.dim() for d in dims]
    split = [p.is_shard() and p.dim in dims for p in me.placements]
    if any(split):
        with _gathering(op):
            me = me.redistribute(me.device_mesh,
                                 [Replicate() if s else p
                                  for p, s in zip(me.placements, split)])
    return DT.from_local(torch.flip(me.to_local(), dims), me.device_mesh,
                         me.placements, run_check=False, shape=me.shape,
                         stride=torch.empty(me.shape, device="meta").stride())


def _index_put(op: Any, args: tuple, kwargs: dict) -> Any:
    """Out-of-place ``index_put`` with ``accumulate`` into a replicated
    tensor (the embedding lookup's backward): each rank adds its own
    values at their rows, a pending sum over the mesh dims that split the
    index entries, which rank 0's block of self starts (GSPMD's local
    scatter-add, its all-reduce left to the consumer); a dim of the values
    that no index covers keeps its split.  Any other ``index_put`` is
    DTensor's."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    DT = _dtensor()
    me, indices, values = args[:3]
    accumulate = args[3] if len(args) > 3 else kwargs.get("accumulate",
                                                          False)
    if not (accumulate and isinstance(me, DT) and isinstance(values, DT)
            and all(p.is_replicate() for p in me.placements)
            and all(ix is not None for ix in indices)):
        return _default(op, args, kwargs)
    mesh = me.device_mesh
    k = len(indices)
    nb = max(ix.dim() for ix in indices)
    out, idx_pl = [], []
    for q in values.placements:
        if q.is_shard() and q.dim < nb:
            out.append(Partial())
            idx_pl.append(Shard(q.dim))
        elif q.is_shard():
            out.append(Shard(q.dim - nb + k))
            idx_pl.append(Replicate())
        else:
            out.append(Partial() if q.is_partial() else Replicate())
            idx_pl.append(Replicate())
    lidx = []
    for ix in indices:
        if not isinstance(ix, DT):
            ix = DT.from_local(ix, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
        pl = [p if ix.dim() == nb else Replicate() for p in idx_pl]
        lidx.append(ix.redistribute(mesh, pl).to_local())
    shape, off = _block(me, out, mesh)
    block = me.to_local()
    for d, (n, o) in enumerate(zip(shape, off)):
        block = block.narrow(d, o, n)
    local = block.clone().index_put_(tuple(lidx), values.to_local(), True)
    return DT.from_local(local, mesh, out, run_check=False, shape=me.shape,
                         stride=torch.empty(me.shape, device="meta").stride())


def _view(op: Any, args: tuple, kwargs: dict) -> Any:
    """A view through DTensor's own sharding.  A local block not laid out
    for it takes a contiguous copy first, as ``reshape`` does on one
    device (DTensor's ``contiguous`` reads the global strides).  A view
    DTensor refuses (a split dim unflattened unevenly: the decode's 16
    heads over 16 ranks into 2 KV heads of 8; on the card's torch also a
    dim flattened from two split dims, which 2.13 shards strided) takes its
    input gathered over one mesh dim that splits it, each in turn, then
    over all, as GSPMD reshards a reshape it cannot split (counted in
    ``_GATHERED``).  The gather that served is kept for the same view's
    next call (``_VIEW_GATHER``): DTensor plans each refusal once."""
    me = args[0]
    key = (op, tuple(me.shape), tuple(me.placements), tuple(args[1]))
    plan = _VIEW_GATHER.get(key)
    if plan is not None:
        with _gathering(op):
            return _default(op, (_gathered(me, plan),) + tuple(args[1:]),
                            kwargs)
    try:
        return _default(op, args, kwargs)
    except RuntimeError as e:       # DTensor's refusal, else raised again
        if _NOT_VIEWABLE in str(e):
            me = _dtensor().from_local(
                me.to_local().contiguous(), me.device_mesh, me.placements,
                run_check=False, shape=me.shape, stride=me.stride())
            return _view(op, (me,) + tuple(args[1:]), kwargs)
        if _PROPAGATION_FAILED not in str(e):
            raise
    split = [m for m, p in enumerate(me.placements) if not p.is_replicate()]
    plan = next((p for p in [[m] for m in split]
                 if _view_takes(op, me, p, args, kwargs)), split)
    _VIEW_GATHER[key] = plan
    return _view(op, args, kwargs)


def _gathered(me: Any, mesh_dims: Sequence[int]) -> Any:
    """``me`` replicated over ``mesh_dims``, its other placements kept."""
    return me.redistribute(me.device_mesh, _placed(me, mesh_dims))


def _placed(me: Any, mesh_dims: Sequence[int]) -> List[Any]:
    from torch.distributed.tensor import Replicate
    return [Replicate() if m in mesh_dims else p
            for m, p in enumerate(me.placements)]


def _view_takes(op: Any, me: Any, mesh_dims: Sequence[int], args: tuple,
                kwargs: dict) -> bool:
    """Whether DTensor shards the view of ``me`` gathered over
    ``mesh_dims``: tried on an empty stand-in on ``meta``, outside any
    recording, so that a refused try leaves no op in the stream."""
    from torch.utils._python_dispatch import _disable_current_modes
    placements = _placed(me, mesh_dims)
    shape, _ = _block(me, placements, me.device_mesh)
    with _disable_current_modes():
        stand_in = _dtensor().from_local(
            torch.empty(shape, dtype=me.dtype, device="meta"),
            me.device_mesh, placements, run_check=False, shape=me.shape,
            stride=me.stride())
        try:
            _default(op, (stand_in,) + tuple(args[1:]), kwargs)
        except RuntimeError as e:
            if _PROPAGATION_FAILED not in str(e):
                raise
            return False
    return True


#: what DTensor's dispatcher adds to an error of its sharding propagation
_PROPAGATION_FAILED = "Sharding propagation failed"
#: what a view of a block not laid out for it raises
_NOT_VIEWABLE = "view size is not compatible"


def _handler_table() -> Dict[Any, Any]:
    if not _HANDLERS:
        aten = torch.ops.aten
        _HANDLERS.update({
            aten.index_put_.default: _index_put_,
            aten.index.Tensor: _index,
            aten.constant_pad_nd.default: _pad,
            aten.view.default: _view,
            aten.flip.default: _flip,
            aten.index_put.default: _index_put,
            aten._unsafe_view.default: _view,
            aten.gather.default: _gather,
            aten.scatter_.src: _on_replicas,
            aten.scatter_.value: _on_replicas,
            aten.scatter.src: _on_replicas,
            aten.scatter.value: _on_replicas,
        })
    return _HANDLERS


def _failed_op(e: BaseException) -> Optional[str]:
    """The op DTensor was dispatching where ``e`` was raised (the innermost
    ``op_call`` of its dispatcher's frames), or None."""
    where = os.path.join("distributed", "tensor")
    tb, op = e.__traceback__, None
    while tb is not None:
        frame = tb.tb_frame
        if where in frame.f_code.co_filename and "op_call" in frame.f_locals:
            op = frame.f_locals["op_call"]
        tb = tb.tb_next
    return None if op is None else str(op)


@contextlib.contextmanager
def _sharded_run() -> Iterator[None]:
    """The dry-run's DTensor handlers installed, and plain tensors the
    model makes (positions, masks, scalars) meeting the DTensors as
    replicated, as GSPMD replicates a constant.  An op DTensor fails on is
    named in the error raised."""
    from torch.distributed.tensor.experimental import implicit_replication
    table = _dtensor()._op_dispatcher._custom_op_handlers
    mine = _handler_table()
    saved = {op: table[op] for op in mine if op in table}
    table.update(mine)
    _GATHERED.clear()
    _VIEW_GATHER.clear()
    try:
        with implicit_replication():
            yield
    except Exception as e:          # named, and raised again
        op = _failed_op(e)
        if op is None:
            raise
        raise RuntimeError(f"DTensor failed on {op}: {type(e).__name__}: "
                           f"{e}") from e
    finally:
        for op in mine:
            table.pop(op, None)
        table.update(saved)


# ---------------------------------------------------------------- cells
def _record(rec: Dict[str, Any], cs: Any, sess: TraceSession, wall: float,
            n_chips: int, mf: float, dropped: Sequence[str],
            n_total: int, n_active: int, capture_error: Optional[str],
            replicated: Dict[str, int]) -> Dict[str, Any]:
    rep = analyze(cs, chips=n_chips, model_flops_total=mf)
    rec.update({
        "status": "ok",
        "wall_s": round(wall, 2),
        "roofline": rep.to_dict(),
        "stream": cs.stream.summary(),
        "memory": dict(cs.memory),
        "cost_flops": cs.xla_flops,
        "cost_bytes": cs.xla_bytes,
        "dropped_shardings": list(dropped[:20]),
        "attribution": {k: attribute(cs, *v)
                        for k, v in ATTRIBUTION_TAGS.items()},
        "model_params_total": n_total,
        "model_params_active": n_active,
        "trace": sess.summary(),
        "replicated_ops": replicated,
    })
    if cs.step.device.type == "cuda":
        g = cs.graph_stream
        rec["graph_stream"] = None if g is None else {
            "n_ops": g.n_ops, "command_bytes": g.text_bytes,
            "by_opcode": g.counts_by_opcode()}
        if capture_error is not None:
            rec["graph_stream_reason"] = capture_error
    return rec


class _Eager:
    """A step that could not be captured: each call runs it."""

    def __init__(self, fn: Any, device: torch.device) -> None:
        self.fn, self.device = fn, device

    def __call__(self) -> Any:
        return self.fn()


def _capture(cap: CommandStreamCapture, name: str, step: Any,
             args: Sequence[Any], dev: torch.device
             ) -> Tuple[Any, Optional[str]]:
    """The step recorded (and on the card captured) through ``cap``; on
    the card a capture that fails records the step eagerly instead, with
    the reason."""
    try:
        return cap.lower_and_compile(name, step, args=args, device=dev), None
    except RuntimeError as e:
        if dev.type != "cuda":
            raise
        reason = f"{type(e).__name__}: {e}"[:500]
    from ..core.capture import CapturedStream
    from ..core.stream import recorded_call
    torch.cuda.synchronize(dev)
    _, ops, secs = recorded_call(lambda: step(*args), dev)
    cs = CapturedStream(
        name=name, step=_Eager(lambda: step(*args), dev), stream=ops,
        graph_stream=None, cost={"flops": float(ops.total_flops),
                                 "bytes accessed": float(ops.memory_bytes)},
        memory={}, lower_time_s=secs)
    return cs, reason


#: a record's fields that a weighted recording gives as the full-depth
#: recording of the same cell does (``weighted_differences``); ``n_ops``
#: and ``counts_by_opcode`` count a weighted body once
WEIGHTED_FIELDS = ("roofline", "attribution", "replicated_ops", "memory",
                   "dropped_shardings", "stream/flops", "stream/memory_bytes",
                   "stream/collective_link_bytes", "stream/collectives",
                   "stream/collective_counts")


def weighted_differences(a: Dict[str, Any], b: Dict[str, Any],
                         fields: Sequence[str] = WEIGHTED_FIELDS
                         ) -> List[Tuple[str, Any, Any]]:
    """Where the records ``a`` and ``b`` differ in ``fields`` (a path such
    as ``stream/flops``): integers and strings exactly, floats beyond 1e-9
    relative, dicts and lists entry by entry.  Empty where a weighted
    record gives what the full-depth one does."""
    def walk(x: Any, y: Any, path: str) -> List[Tuple[str, Any, Any]]:
        if isinstance(x, dict) and isinstance(y, dict):
            if set(x) != set(y):
                return [(path, sorted(x), sorted(y))]
            return [d for k in x for d in walk(x[k], y[k], f"{path}/{k}")]
        if isinstance(x, list) and isinstance(y, list) and len(x) == len(y):
            return [d for i, (u, v) in enumerate(zip(x, y))
                    for d in walk(u, v, f"{path}/{i}")]
        if (isinstance(x, float) or isinstance(y, float)) and (
                isinstance(x, (int, float)) and isinstance(y, (int, float))):
            return ([] if abs(x - y) <= 1e-9 * max(abs(x), abs(y))
                    else [(path, x, y)])
        return [] if x == y else [(path, x, y)]

    out: List[Tuple[str, Any, Any]] = []
    for field in fields:
        x, y = a, b
        for k in field.split("/"):
            x, y = x[k], y[k]
        out += walk(x, y, field)
    return out


def dry_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Any,
             name: str, rec: Dict[str, Any], device: str = "meta",
             keep_artifacts: bool = False,
             full_depth: Optional[bool] = None) -> Dict[str, Any]:
    """Record one cell of ``cfg`` at ``shape`` on the fake ``mesh`` into
    ``rec`` (``run_cell`` without the config and mesh lookup).

    On ``meta`` each layer stack is recorded as the reference's scan body
    is: its layers run until one leaves its input's sharding unchanged,
    and that layer's entries are weighted by the layers left
    (``models.layers.layer_loop``); everything outside the stacks (the
    embedding, the final norm, the loss, the optimizer on the stacked
    leaves, the decode state) keeps its full depth, and so do the params,
    the state and the moments.  The totals, the attribution, the memory
    and ``replicated_ops`` are those of the full-depth recording
    (``full_depth=True``, the default on the card, whose graph replays);
    ``n_ops`` and the opcode counts count each recorded layer once (the
    weighted one standing for the rest), as the reference's count its
    scan body once."""
    dev = torch.device(device)
    if full_depth is None:
        full_depth = dev.type != "meta"
    n_chips = mesh.size()
    # the plain route; on meta the model's own allocations (a fresh state)
    # land on meta too
    model = get_model(cfg, impl="ref",
                      device="cpu" if dev.type == "meta" else dev)
    model.device = dev
    rules = ShardingRules(mesh, cfg)
    if cfg.seq_shard and shape.kind in ("train", "prefill"):
        dp = dp_axes(mesh)
        sp = to_placements(P(dp if len(dp) > 1 else dp[0], "model", None),
                           mesh)
        model.constraint = lambda x: x.redistribute(mesh, sp)
    sess = TraceSession(name=name)
    cap = sess.capture
    B, S = shape.global_batch, shape.seq_len
    batch_g = make_input_specs(cfg, shape)
    params_g = _param_tree(cfg)
    # the specs in the reference's order, so that ``dropped`` lists what
    # its record lists: the params, then the moments (train: step, master,
    # m, v) or the decode state, then the batch; a prefill's cache is the
    # step's own there (GSPMD shards it), its drops not recorded here
    p_specs = rules.param_specs(params_g)
    if shape.kind == "train":
        fp32 = map_params(lambda t: torch.empty(
            t.shape, dtype=torch.float32, device="meta"), params_g)
        o_specs = [rules.opt_specs(fp32) for _ in range(3)]
    elif shape.kind == "decode":
        state_g = _state_tree(model, B, S)
        s_specs = rules.state_specs(state_g)
    b_specs = rules.data_specs(batch_g)
    vocab = f"tokens:{cfg.vocab_size}"
    batch = _distribute(batch_g, b_specs, mesh, dev,
                        lambda path, leaf: vocab if not
                        leaf.dtype.is_floating_point else "randn")
    params = _distribute(params_g, p_specs, mesh, dev, _float_fill)
    n_total, n_active = cfg.param_counts()
    t0 = time.time()
    with _sharded_run(), weighted_stacks(not full_depth):
        if shape.kind == "train":
            opt = AdamWState(
                step=_local((), torch.int32, P(), mesh, dev, "zeros"),
                master=_distribute(fp32, o_specs[0], mesh, dev, _float_fill),
                m=_distribute(fp32, o_specs[1], mesh, dev, _float_fill),
                v=_distribute(fp32, o_specs[2], mesh, dev, _float_fill))
            step = make_train_step(model, cfg)
            cs, why = _capture(cap, name, step, (params, opt, batch), dev)
            tokens = B * S
            if cfg.family == "audio":
                tokens = B * (S + S // cfg.enc_seq_ratio)
            mf = model_flops(n_active, tokens, "train")
        elif shape.kind == "prefill":
            state_g = _state_tree(model, B, S)
            state = _distribute(state_g, ShardingRules(mesh, cfg).state_specs(
                state_g), mesh, dev, _state_fill)
            prefill = make_prefill_step(model, cfg, max_seq=S)

            def step(params: Any, batch: Any) -> Any:
                return prefill(params, batch, state)
            cs, why = _capture(cap, name, step, (params, batch), dev)
            mf = model_flops(n_active, B * S, "inference")
        else:
            state = _distribute(state_g, s_specs, mesh, dev, _state_fill)
            step = make_decode_step(model, cfg)
            cs, why = _capture(cap, name, step,
                               (params, state, batch["tokens"]), dev)
            mf = model_flops(n_active, B, "inference")
    wall = time.time() - t0
    _record(rec, cs, sess, wall, n_chips, mf, rules.dropped, n_total,
            n_active, why, replicated_ops(cs.stream.entries))
    if keep_artifacts:
        rec["_captured"] = cs
    return rec


def _state_tree(model: Any, batch: int, max_seq: int) -> Any:
    """The model's decode state, its shapes and types on ``meta``."""
    keep = model.device
    model.device = torch.device("meta")
    try:
        return model.init_decode_state(batch, max_seq)
    finally:
        model.device = keep


def _state_fill(path: str, leaf: Any) -> str:
    return "zeros" if path.endswith("length") else _float_fill(path, leaf)


def _cell_config(arch: str, multi_pod: bool,
                 overrides: Optional[Dict[str, Any]]) -> ModelConfig:
    layout = MeshLayout.production(multi_pod)
    cfg = resolve(ARCHS[arch], model_axis=layout.shape["model"])
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def cell_skip(arch: str, shape_name: str, multi_pod: bool,
              overrides: Optional[Dict[str, Any]] = None) -> str:
    """Why the cell is skipped (the reference's ``skip_reason``), or ""."""
    return skip_reason(_cell_config(arch, multi_pod, overrides),
                       SHAPES[shape_name])


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             keep_artifacts: bool = False,
             overrides: Optional[Dict[str, Any]] = None,
             device: str = "meta",
             full_depth: Optional[bool] = None) -> Dict[str, Any]:
    """Record one cell's rank-0 program; returns the JSON record
    (``full_depth``: :func:`dry_cell`)."""
    reason = cell_skip(arch, shape_name, multi_pod, overrides)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "chips": MeshLayout.production(multi_pod).size,
    }
    if reason:
        rec.update({"status": "skip", "reason": reason})
        return rec
    return dry_cell(_cell_config(arch, multi_pod, overrides),
                    SHAPES[shape_name], fake_mesh(multi_pod),
                    f"{arch}:{shape_name}", rec, device, keep_artifacts,
                    full_depth)


def run_pp_cell(arch: str, shape_name: str, multi_pod: bool,
                overrides: Optional[Dict[str, Any]] = None,
                keep_artifacts: bool = False,
                tokens_per_launch: int = 1,
                device: str = "meta") -> Dict[str, Any]:
    """Record one launch of the pipeline-parallel decode on rank 0."""
    shape = SHAPES[shape_name]
    assert shape.kind == "decode", "PP path is a decode-serving feature"
    cfg = _cell_config(arch, multi_pod, overrides)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "chips": MeshLayout.production(multi_pod).size}
    return dry_pp_cell(cfg, shape, fake_mesh(multi_pod),
                       f"{arch}:{shape_name}:pp", rec, tokens_per_launch,
                       device, keep_artifacts)


def dry_pp_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Any, name: str,
                rec: Dict[str, Any], tokens_per_launch: int = 1,
                device: str = "meta", keep_artifacts: bool = False
                ) -> Dict[str, Any]:
    """One PP launch on rank 0 of the fake ``mesh`` into ``rec``: its local
    blocks (``PPDecoder.param_specs`` / ``state_specs``) through
    ``make_local_step``, the per-device body of the reference's
    ``shard_map``; rank 0 is the first stage."""
    from ..distributed.pp_decode import PPDecoder, pp_param_specs
    dev = torch.device(device)
    pp = PPDecoder(cfg, mesh, tokens_per_launch=tokens_per_launch)
    B, S, T = shape.global_batch, shape.seq_len, tokens_per_launch
    dtype = dtype_of(cfg)

    def block(spec: Any, shape_: Sequence[int], dt: torch.dtype) -> Any:
        fill = "randn" if dt.is_floating_point else "zeros"
        return _local(shape_, dt, spec, mesh, dev, fill).to_local()

    def walk(t: Any, s: Any) -> Any:
        if isinstance(t, dict):
            return {k: walk(t[k], s[k]) for k in t}
        return block(s, t.shape, t.dtype or dtype)

    params = walk(pp_param_specs(cfg, pp.n_stages, pp.layers_per_stage),
                  pp.param_specs())
    if dev.type != "meta":
        params["valid"].fill_(True)
    s_specs = pp.state_specs()
    kv = (pp.n_stages, pp.layers_per_stage, B, S, cfg.n_kv_heads, cfg.hd)
    wire = (pp.n_stages, B // pp.n_stages, T, cfg.d_model)
    state = {"k": block(s_specs["k"], kv, dtype),
             "v": block(s_specs["v"], kv, dtype),
             "wire": block(s_specs["wire"], wire, dtype),
             "length": block(s_specs["length"], (), torch.int32)}
    tokens = (torch.empty((B, T), dtype=torch.int32, device=dev)
              if dev.type == "meta" else
              torch.randint(0, cfg.vocab_size, (B, T), dtype=torch.int32,
                            device=dev))
    sess = TraceSession(name=name)
    t0 = time.time()
    cs, why = _capture(sess.capture, name, pp.make_local_step(B, S),
                       (params, state, tokens), dev)
    wall = time.time() - t0
    n_total, n_active = cfg.param_counts()
    _record(rec, cs, sess, wall, mesh.size(),
            model_flops(n_active, B * T, "inference"), [], n_total,
            n_active, why, {})
    rec.update({"attribution": {}, "pp": True,
                "tokens_per_launch": tokens_per_launch})
    if keep_artifacts:
        rec["_captured"] = cs
    return rec


# ---------------------------------------------------------------- CLI
def _print_summary(rec: Dict[str, Any]) -> None:
    tag = f"{rec['arch']} × {rec['shape']} × {rec['mesh']}({rec['chips']})"
    if rec["status"] == "skip":
        print(f"SKIP {tag}: {rec['reason']}")
        return
    if rec["status"] == "error":
        print(f"FAIL {tag}: {rec['error'][:500]}")
        return
    r = rec["roofline"]
    m = rec["memory"]
    per_dev = (m.get("argument_size_in_bytes", 0)
               + m.get("temp_size_in_bytes", 0)) / 2**30
    print(f"OK   {tag}  wall={rec['wall_s']}s")
    print(f"     memory/device: args+temp={per_dev:.2f} GiB "
          f"(args={m.get('argument_size_in_bytes', 0)/2**30:.2f}, "
          f"out={m.get('output_size_in_bytes', 0)/2**30:.2f}, "
          f"temp={m.get('temp_size_in_bytes', 0)/2**30:.2f})")
    print(f"     roofline: compute={r['compute_s']*1e3:.3f}ms "
          f"memory={r['memory_s']*1e3:.3f}ms "
          f"collective={r['collective_s']*1e3:.3f}ms "
          f"-> {r['bottleneck']}-bound  "
          f"MF-ratio={r['model_flops_ratio']:.3f} "
          f"roofline-frac={r['roofline_fraction']:.3f}")
    cols = rec["stream"].get("collectives", {})
    if cols:
        tops = sorted(cols.items(), key=lambda kv: -kv[1])[:4]
        print("     collectives: " + ", ".join(
            f"{k}={v/2**20:.1f}MiB" for k, v in tops))


def _load_done(path: str) -> set:
    done = set()
    try:
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("status") in ("ok", "skip"):
                        done.add((r["arch"], r["shape"], r["mesh"]))
                except (ValueError, KeyError):
                    pass
    except FileNotFoundError:
        pass
    return done


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=RESULTS_DEFAULT)
    ap.add_argument("--force", action="store_true",
                    help="rerun completed cells")
    ap.add_argument("--device", default="meta", choices=["meta", "cuda"],
                    help="meta: record only; cuda: run rank 0's program on "
                         "the card")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    done = set() if args.force else _load_done(args.out)

    n_fail = 0
    for multi in meshes:
        mesh_name = "multi" if multi else "single"
        for arch in archs:
            for shape in shapes:
                if (arch, shape, mesh_name) in done:
                    print(f"SKIP (done) {arch} × {shape} × {mesh_name}")
                    continue
                try:
                    rec = run_cell(arch, shape, multi, device=args.device)
                except Exception as e:       # recorded, and fails the run
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "chips": MeshLayout.production(multi).size,
                           "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    n_fail += 1
                _print_summary(rec)
                with open(args.out, "a") as f:
                    f.write(json.dumps(
                        {k: v for k, v in rec.items()
                         if not k.startswith("_")}) + "\n")
    release_fake_mesh()
    if n_fail:
        raise SystemExit(f"{n_fail} cell(s) failed")


if __name__ == "__main__":
    main()
