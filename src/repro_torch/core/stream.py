"""The command stream of one submission unit, the port's counterpart of
``repro.core.hlo``.

The paper reconstructs the pushbuffer a doorbell commits and decodes each
method.  The reference decodes XLA's compiled HLO, the instruction stream a
TPU consumes.  On CUDA the submission unit is a captured CUDA Graph
(``core.graphs.CapturedStep``), and the port reads it two ways:

* :func:`decode_graph` reads the graph itself through the runtime's graph
  API and the driver's (``kernels/csrc/graph_decode.cu``): every node, in
  capture order, with its type, and for a kernel its function's name, grid,
  block, dynamic shared memory and cluster; for a copy or a fill its bytes
  and direction; conditional and child-graph bodies are decoded in turn.
  This is what the driver turns into pushbuffer entries, complete and
  unsampled.  Card only; a graph it cannot read raises.
* :func:`record_ops` records the aten ops of one run of a function under a
  ``TorchDispatchMode``: their operand and result bytes, their FLOPs (the
  matmul, convolution and attention family by ``torch.utils.flop_counter``'s
  formulas, elementwise ops by result elements and reductions by operand
  elements, as the reference counts HLO), their Python call path and their
  engine.  The port's kernels are no aten ops; each reports one ``kernel``
  entry with its cost (``kernels.recorded``).  Any device, the CPU and
  ``meta`` included.

  On DTensors (``torch.distributed.tensor``) the recorder charges what one
  rank runs: it lets DTensor's own dispatch handle a DTensor op and records
  the local ops that come back from it, at the local shards' shapes, and
  leaves out the ops DTensor runs to propagate shardings (on fake tensors,
  or below ``_sharding_prop``).  Collectives, functional
  (``_c10d_functional``) or not (``c10d``), are ``collective`` entries
  under the reference's opcodes (``COLLECTIVE_OPS``), with ``_link_bytes``
  at the size of the op's own group; a send and its receive are a
  ``collective-permute-start`` / ``-done`` pair whose link bytes the send
  carries.  ``wait_tensor`` and ``_wrap_tensor_autograd`` are free.

  A layer stack can be recorded as the reference's scan body is, once for
  the layers that run the same program: :func:`restamp` stamps the entries
  recorded since a :func:`mark` with ``multiplier=n`` (and
  :func:`set_multiplier` the entries to come), and every aggregate of
  :class:`CommandStream` weights by it.  :class:`weighted_stacks` turns
  this on for the models' layer loops (``models.layers.layer_loop``).

:class:`CommandEntry`, :class:`CommandStream` (totals, engine and opcode
counts, collective accounting), :func:`dtype_bytes`, ``COLLECTIVE_OPS`` and
``_link_bytes`` are the reference's, as the port's own copy.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import re
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .. import kernels as _kernels

__all__ = [
    "CommandEntry",
    "CommandStream",
    "GraphEntry",
    "decode_graph",
    "record_ops",
    "dtype_bytes",
    "kernel_label",
    "kernel_base",
    "COLLECTIVE_OPS",
    "set_multiplier",
    "mark",
    "restamp",
    "weighted_stacks",
]

_DTYPE_BYTES: Dict[str, float] = {
    "pred": 1, "s2": 0.25, "s4": 0.5, "s8": 1, "s16": 2, "s32": 4, "s64": 8,
    "u2": 0.25, "u4": 0.5, "u8": 1, "u16": 2, "u32": 4, "u64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3b11fnuz": 1, "f8e4m3": 1,
    "f8e5m2fnuz": 1, "f8e4m3fnuz": 1, "f8e3m4": 1, "f8e8m0fnu": 1,
    "f4e2m1fn": 0.5, "bf16": 2, "f16": 2, "f32": 4, "f64": 8,
    "c64": 8, "c128": 16, "token": 0, "opaque": 0,
}

COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
    "collective-broadcast",
    "ragged-all-to-all",
)


def dtype_bytes(dtype: str) -> float:
    return _DTYPE_BYTES.get(dtype, 4)


def _link_bytes(opcode: str, result_b: int, operand_b: int, n: int) -> int:
    """Per-device link bytes for a ring realization of the collective."""
    if n <= 1:
        return 0
    frac = (n - 1) / n
    if opcode.startswith("all-gather"):
        # async '-start' ops carry (operand, result) tuples; recover the
        # gathered buffer size before applying the ring fraction.
        gathered = result_b - operand_b if opcode.endswith("-start") else result_b
        return int(max(gathered, operand_b) * frac)
    if opcode.startswith("reduce-scatter"):
        return int(operand_b * frac)
    if opcode.startswith("all-reduce"):
        return int(2 * operand_b * frac)
    if opcode.startswith(("all-to-all", "ragged-all-to-all")):
        return int(operand_b * frac)
    if opcode.startswith(("collective-permute", "collective-broadcast")):
        return int(operand_b)
    return int(operand_b * frac)


@dataclasses.dataclass
class CommandEntry:
    """One decoded command: an aten op, a kernel call or a graph node."""

    index: int
    name: str
    opcode: str
    computation: str
    multiplier: int            # execution count (1; the layers a weighted
                               # body stands for; unknown under a conditional)
    result_bytes: int
    operand_bytes: int
    engine: str                # compute | collective | transfer | control | host | kernel | other
    flops: int = 0             # per single execution
    group_size: int = 1
    link_bytes: int = 0        # per single execution, per-device link bytes
    op_path: str = ""          # Python call path, or the kernel's name
    raw: str = ""

    def describe(self) -> str:
        extra = ""
        if self.engine == "collective":
            extra = f" groups={self.group_size} link_bytes={self.link_bytes}"
        if self.flops:
            extra += f" flops={self.flops}"
        mult = f" x{self.multiplier}" if self.multiplier != 1 else ""
        return (f"CS[{self.index:>4d}] {self.opcode:<22s} {self.engine:<10s}"
                f" out={self.result_bytes}B in={self.operand_bytes}B{extra}{mult}")


@dataclasses.dataclass
class GraphEntry(CommandEntry):
    """One node of a decoded CUDA Graph (:func:`decode_graph`).

    ``name`` is a kernel's mangled name (``<unnamed>`` where the driver
    would not give it), ``op_path`` its demangled name and ``label`` its
    short label (:func:`kernel_label`); ``depth`` counts the conditional
    or child-graph bodies the node sits in."""

    label: str = ""
    grid: Tuple[int, int, int] = (0, 0, 0)
    block: Tuple[int, int, int] = (0, 0, 0)
    cluster: Tuple[int, int, int] = (0, 0, 0)
    shared_bytes: int = 0
    direction: str = ""
    depth: int = 0

    def describe(self) -> str:
        pad = "  " * self.depth
        head = f"CS[{self.index:>4d}] {pad}{self.opcode:<12s}"
        if self.opcode == "kernel":
            cl = (f" cluster={self.cluster}"
                  if max(self.cluster) > 1 else "")
            return (f"{head} {self.label:<44s} grid={self.grid} "
                    f"block={self.block} smem={self.shared_bytes}B{cl}")
        if self.opcode in ("memcpy", "memset"):
            return f"{head} {self.result_bytes}B {self.direction}"
        return head.rstrip() + (f" {self.raw}" if self.raw else "")


@dataclasses.dataclass
class CommandStream:
    """A fully decoded command stream (one submission unit)."""

    entries: List[CommandEntry]
    text_bytes: int
    n_ops: int
    unknown_trip_counts: bool = False

    # ---- aggregates (all multiplier weighted) ----------------------------
    @property
    def total_flops(self) -> int:
        return sum(e.flops * e.multiplier for e in self.entries)

    @property
    def memory_bytes(self) -> int:
        """Memory-traffic proxy: operand+result bytes of every executed
        command (each op's inputs and outputs cross device memory)."""
        return sum((e.result_bytes + e.operand_bytes) * e.multiplier
                   for e in self.entries
                   if e.engine not in ("control",) or e.opcode == "fusion")

    @property
    def collective_entries(self) -> List[CommandEntry]:
        return [e for e in self.entries if e.engine == "collective"]

    @property
    def collective_link_bytes(self) -> int:
        return sum(e.link_bytes * e.multiplier for e in self.collective_entries)

    def collective_bytes_by_op(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.collective_entries:
            key = e.opcode.replace("-start", "").replace("-done", "")
            out[key] = out.get(key, 0) + e.link_bytes * e.multiplier
        return out

    def collective_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.collective_entries:
            if e.opcode.endswith("-done"):
                continue
            key = e.opcode.replace("-start", "")
            out[key] = out.get(key, 0) + e.multiplier
        return out

    def counts_by_engine(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.entries:
            out[e.engine] = out.get(e.engine, 0) + 1
        return out

    def counts_by_opcode(self, top: int = 0) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.entries:
            out[e.opcode] = out.get(e.opcode, 0) + 1
        if top:
            out = dict(sorted(out.items(), key=lambda kv: -kv[1])[:top])
        return out

    def summary(self) -> Dict[str, object]:
        return {
            "n_ops": self.n_ops,
            "command_bytes": self.text_bytes,
            "flops": self.total_flops,
            "memory_bytes": self.memory_bytes,
            "collective_link_bytes": self.collective_link_bytes,
            "collectives": self.collective_bytes_by_op(),
            "collective_counts": self.collective_counts(),
            "unknown_trip_counts": self.unknown_trip_counts,
        }


# ---------------------------------------------------------------- kernel names
def kernel_label(mangled: str) -> str:
    """``flash_attention_mma_kernel<256>`` from an Itanium-mangled name: the
    first length-prefixed identifier ending in ``_kernel``, and its template
    arguments (types and integers); the name itself if there is none."""
    for m in re.finditer(r"(?=(\d+)([A-Za-z_]\w*))", mangled):
        n, ident = int(m.group(1)), m.group(2)
        if len(ident) >= n and ident[:n].endswith("_kernel"):
            args = re.match(r"I(.*?)EE", ident[n:])
            if not args:
                return ident[:n]
            names = {"f": "float", "13__nv_bfloat16": "bf16"}
            toks = re.findall(r"13__nv_bfloat16|Li\d+|f", args.group(1))
            return ident[:n] + "<" + ", ".join(
                names.get(t, t[2:]) for t in toks) + ">"
    return mangled


def kernel_base(name: str) -> str:
    """The qualified function name of a demangled kernel name, without its
    return type, template arguments and parameters
    (``(anonymous namespace)::rms_norm_kernel``); a name that is no C++
    signature comes back as it is."""
    s = name.replace("(anonymous namespace)", "\0")
    if s.startswith("void "):
        s = s[5:]
    s = re.split(r"[<(]", s, maxsplit=1)[0].strip()
    return s.replace("\0", "(anonymous namespace)")


# ---------------------------------------------------------------- graph decode
# CUgraphNodeType -> (opcode, engine); kernels on the compute engines,
# copies and fills on the copy engine, the rest is control or host work
_NODE_TYPES = {
    0: ("kernel", "compute"), 1: ("memcpy", "transfer"),
    2: ("memset", "transfer"), 3: ("host", "host"), 4: ("graph", "control"),
    5: ("empty", "control"), 6: ("event_wait", "control"),
    7: ("event_record", "control"), 8: ("semaphore_signal", "control"),
    9: ("semaphore_wait", "control"), 10: ("mem_alloc", "control"),
    11: ("mem_free", "control"), 12: ("batch_mem_op", "control"),
    13: ("conditional", "control"),
}
_KERNEL, _CHILD, _CONDITIONAL = 0, 4, 13
# cudaMemcpyKind
_DIRECTIONS = {0: "host->host", 1: "host->device", 2: "device->host",
               3: "device->device", 4: "default"}
_NAME_BYTES = 1024


class _NodeRecord(ctypes.Structure):
    """``NodeRecord`` of ``kernels/csrc/graph_decode.cu``."""

    _fields_ = [("type", ctypes.c_int), ("status", ctypes.c_int),
                ("stage", ctypes.c_int),
                ("name", ctypes.c_char * _NAME_BYTES),
                ("demangled", ctypes.c_char * _NAME_BYTES),
                ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("cluster", ctypes.c_uint * 3),
                ("shared_bytes", ctypes.c_uint), ("bytes", ctypes.c_longlong),
                ("direction", ctypes.c_int), ("body", ctypes.c_void_p)]


def _graph_handle(graph: Any) -> int:
    if isinstance(graph, int):
        return graph
    if hasattr(graph, "raw_cuda_graph"):
        return graph.raw_cuda_graph()
    raise TypeError(f"decode_graph: expected a cudaGraph_t handle or a "
                    f"torch.cuda.CUDAGraph, got {type(graph).__name__}")


# the graph API call of graph_decode that failed (NodeRecord::stage)
_STAGES = ("", "cuGraphNodeGetType", "cuGraphKernelNodeGetParams",
           "cudaGraphMemcpyNodeGetParams", "cudaGraphMemsetNodeGetParams",
           "cudaGraphChildGraphNodeGetGraph")


def _graph_nodes(lib: Any, graph: int) -> Sequence[_NodeRecord]:
    from ..kernels import _build
    n = ctypes.c_longlong()
    _build.check(lib.graph_decode(graph, None, 0, ctypes.byref(n)),
                 f"graph_decode of graph {hex(graph)}")
    recs = (_NodeRecord * n.value)()
    err = lib.graph_decode(graph, ctypes.cast(recs, ctypes.c_void_p), n.value,
                           ctypes.byref(n))
    if err:
        r = recs[n.value]
        opcode = _NODE_TYPES.get(r.type, (f"type{r.type}",))[0]
        _build.check(err, f"graph_decode of graph {hex(graph)}, node "
                     f"{n.value} ({opcode}): {_STAGES[r.stage]}")
    return recs[:n.value]


def _graph_entry(index: int, r: _NodeRecord, graph: int, depth: int
                 ) -> GraphEntry:
    opcode, engine = _NODE_TYPES.get(r.type, (f"type{r.type}", "other"))
    e = GraphEntry(index=index, name="", opcode=opcode,
                   computation=hex(graph), multiplier=1, result_bytes=0,
                   operand_bytes=0, engine=engine, depth=depth)
    if r.type == _KERNEL:
        e.name = r.name.decode(errors="replace") or "<unnamed>"
        e.op_path = r.demangled.decode(errors="replace") or e.name
        e.label = kernel_label(e.name)
        if e.label == e.name != "<unnamed>":     # no ..._kernel in the name
            e.label = kernel_base(e.op_path).rsplit("::", 1)[-1]
        e.grid, e.block, e.cluster = (tuple(r.grid), tuple(r.block),
                                      tuple(r.cluster))
        e.shared_bytes = r.shared_bytes
    elif opcode == "memcpy":
        e.result_bytes = e.operand_bytes = r.bytes
        e.direction = _DIRECTIONS.get(r.direction, str(r.direction))
    elif opcode == "memset":
        e.result_bytes = r.bytes
        e.direction = "device"
    elif r.type == _CHILD:
        e.raw = f"body {hex(r.body or 0)}"
    return e


def decode_graph(graph: Any, bodies: Sequence[int] = ()) -> CommandStream:
    """Every node of a captured CUDA Graph, in capture order, conditional
    and child-graph bodies decoded after their node (card only).

    ``graph`` is a raw ``cudaGraph_t`` or a ``torch.cuda.CUDAGraph`` kept
    with ``keep_graph=True``.  A child graph's body comes from the runtime;
    a conditional node's from ``bodies`` (one a conditional node, in
    order), since the code that built the graph knows it: a conditional
    node without one raises.  Conditional bodies run an unknown number of times:
    ``unknown_trip_counts`` is set and their nodes count once, as the
    reference counts a while loop without ``known_trip_count``.  ``n_ops``
    counts the decoded nodes; ``text_bytes`` is, by definition, the bytes
    of ``graph_footprint`` over the graph and every body it holds."""
    from ..kernels import _build
    from .graphs import graph_footprint
    lib = _build.library()
    if lib.graph_decode_record_bytes() != ctypes.sizeof(_NodeRecord):
        raise RuntimeError("graph_decode: the library's node record is "
                           f"{lib.graph_decode_record_bytes()} bytes, the "
                           f"binding's {ctypes.sizeof(_NodeRecord)}")
    entries: List[CommandEntry] = []
    graphs: List[int] = []
    supplied = list(bodies)
    unknown = False

    def walk(g: int, depth: int) -> None:
        nonlocal unknown
        graphs.append(g)
        for r in _graph_nodes(lib, g):
            entries.append(_graph_entry(len(entries), r, g, depth))
            if r.type == _CHILD:
                walk(r.body, depth + 1)
            elif r.type == _CONDITIONAL:
                if not supplied:
                    raise RuntimeError(
                        f"decode_graph: conditional node {len(entries) - 1} "
                        f"of graph {hex(g)}: no body graph supplied")
                unknown = True
                walk(supplied.pop(0), depth + 1)

    walk(_graph_handle(graph), 0)
    if supplied:
        raise ValueError(f"decode_graph: {len(supplied)} supplied body "
                         f"graphs were not needed")
    return CommandStream(entries=entries,
                         text_bytes=graph_footprint(graphs)[0],
                         n_ops=len(entries), unknown_trip_counts=unknown)


# ---------------------------------------------------------------- op record
# as the package was imported: a frame's file name carries the same prefix
# (not normalised where the import path was not)
_PKG = os.path.dirname(os.path.dirname(__file__))
_CORE = os.path.dirname(__file__)
_KERNELS_INIT = os.path.join(_PKG, "kernels", "__init__.py")
# no device traffic: aliases, allocations, metadata, and a scalar read to
# the host (a captured step holds none; a host-side constant's does not count)
_FREE_OPS = frozenset((
    "detach", "alias", "lift_fresh", "_unsafe_view", "_local_scalar_dense",
    "empty", "empty_like", "empty_strided",
    "new_empty", "new_empty_strided", "resize_", "set_", "record_stream",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "is_same_size", "_has_compatible_shallow_copy_type"))
# the reference's transfer class: copies, gathers, scatters, concatenation,
# padding, fills and constants
_TRANSFER_OPS = frozenset((
    "copy", "clone", "index", "_unsafe_index", "index_select", "gather",
    "scatter", "scatter_add", "scatter_reduce", "index_put", "_unsafe_index_put",
    "index_copy", "index_add", "index_fill", "masked_scatter", "put", "take",
    "cat", "stack", "constant_pad_nd", "pad", "embedding", "slice_scatter",
    "select_scatter", "roll", "flip", "repeat", "fill", "zero", "zeros",
    "zeros_like", "ones", "ones_like", "full", "full_like", "arange",
    "scalar_tensor", "tril", "triu"))
# gathers read only the rows they return (and their indices), as the
# reference charges a dynamic-slice its slice
_GATHERS = frozenset(("index", "_unsafe_index", "index_select", "gather",
                      "embedding", "take"))
# in-place ops that write only the rows of their source
_SCATTERS = frozenset(("index_put", "_unsafe_index_put", "index_copy",
                       "index_add", "scatter", "scatter_add", "scatter_reduce",
                       "masked_scatter", "put", "slice_scatter", "select_scatter"))
# collectives: (namespace, op) -> (opcode, the argument the op sends, the
# argument it writes or None for its result)
_COLLECTIVES: Dict[Tuple[str, str], Tuple[str, str, Optional[str]]] = {
    ("_c10d_functional", "all_reduce"): ("all-reduce", "input", None),
    ("_c10d_functional", "all_reduce_"): ("all-reduce", "input", "input"),
    ("_c10d_functional", "all_reduce_coalesced"):
        ("all-reduce", "inputs", None),
    ("_c10d_functional", "all_gather_into_tensor"):
        ("all-gather", "input", None),
    ("_c10d_functional", "all_gather_into_tensor_out"):
        ("all-gather", "input", "out"),
    ("_c10d_functional", "reduce_scatter_tensor"):
        ("reduce-scatter", "input", None),
    ("_c10d_functional", "all_to_all_single"): ("all-to-all", "input", None),
    ("_c10d_functional", "broadcast"): ("collective-broadcast", "input", None),
    ("_c10d_functional", "broadcast_"):
        ("collective-broadcast", "input", "input"),
    ("c10d", "allreduce_"): ("all-reduce", "tensors", "tensors"),
    ("c10d", "allgather_"): ("all-gather", "input_tensors", "output_tensors"),
    ("c10d", "_allgather_base_"):
        ("all-gather", "input_tensor", "output_tensor"),
    ("c10d", "reduce_scatter_"):
        ("reduce-scatter", "input_tensors", "output_tensors"),
    ("c10d", "_reduce_scatter_base_"):
        ("reduce-scatter", "input_tensor", "output_tensor"),
    ("c10d", "alltoall_base_"): ("all-to-all", "input", "output"),
    ("c10d", "alltoall_"): ("all-to-all", "input_tensors", "output_tensors"),
    ("c10d", "broadcast_"): ("collective-broadcast", "tensors", "tensors"),
    ("_dtensor", "shard_dim_alltoall"): ("all-to-all", "input", None),
    ("c10d", "send"): ("collective-permute-start", "tensors", None),
    ("c10d", "recv_"): ("collective-permute-done", None, "tensors"),
}
# no device work of its own: a wait on a collective, autograd's wrapper
_FREE_COLLECTIVES = frozenset(("wait_tensor", "_wrap_tensor_autograd",
                               "barrier", "monitored_barrier_"))
# DTensor's sharding propagation runs ops below these modules
_PROPAGATION_FILES = ("_sharding_prop.py", "_op_schema.py")


def _group_size(arg: Any) -> int:
    """The size of a collective's group: a ``c10d`` op's process group, or
    a functional op's group name."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    if isinstance(arg, str):
        return _resolve_process_group(arg).size()
    if isinstance(arg, torch.ScriptObject):
        return dist.ProcessGroup.unbox(arg).size()
    return arg.size()


def _meta_arg(a: Any) -> Any:
    """A hashable stand-in for one argument of a meta op, or raises
    ``TypeError``: a tensor's layout, or a plain value."""
    if isinstance(a, torch.Tensor):
        if type(a) is not torch.Tensor or a.device.type != "meta":
            raise TypeError
        return ("T", tuple(a.shape), a.stride(), a.dtype,
                a.storage_offset())
    if isinstance(a, (list, tuple)):
        return (type(a).__name__,) + tuple(_meta_arg(v) for v in a)
    if a is None or isinstance(a, (bool, int, float, str, torch.dtype,
                                   torch.device, torch.layout,
                                   torch.memory_format)):
        return a
    raise TypeError


def _meta_key(func: Any, args: tuple, kwargs: dict) -> Any:
    """The cache key of a functional op on meta tensors, else None."""
    schema = func._schema
    if func.is_view or schema.is_mutable or not args:
        return None
    try:
        key = (func, _meta_arg(args),
               tuple(sorted((k, _meta_arg(v)) for k, v in kwargs.items())))
    except TypeError:
        return None
    if not any(isinstance(a, tuple) and a[:1] == ("T",) for a in key[1]):
        return None
    return key


def _meta_layout(out: Any) -> Any:
    """(shape, stride, dtype) of a fresh meta output, a list of them for a
    tuple of tensors, or None."""
    def one(t: Any) -> Any:
        if not (isinstance(t, torch.Tensor) and type(t) is torch.Tensor
                and t.device.type == "meta" and t.storage_offset() == 0):
            raise TypeError
        return (tuple(t.shape), t.stride(), t.dtype)
    try:
        if isinstance(out, tuple):
            return [one(t) for t in out]
        return one(out)
    except TypeError:
        return None


def _meta_empty(layout: Any) -> torch.Tensor:
    shape, stride, dtype = layout
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


def _subclass(types: Any, module: str, name: str) -> bool:
    """Whether one of ``types`` subclasses ``module.name``; False while the
    module is not imported (no such tensor can exist)."""
    mod = sys.modules.get(module)
    cls = getattr(mod, name, None) if mod is not None else None
    return cls is not None and any(issubclass(t, cls) for t in types)


_ELEMENTWISE_OPS = frozenset((
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "pow", "tanh",
    "exp", "log", "rsqrt", "sqrt", "neg", "abs", "floor", "ceil", "sign", "cos",
    "sin", "sigmoid", "expm1", "log1p", "erf", "atan2", "remainder", "round",
    "reciprocal", "square", "gelu", "silu", "relu", "softplus", "clamp",
    "clamp_min", "clamp_max", "where", "masked_fill", "eq", "ne", "lt", "le",
    "gt", "ge", "logical_and", "logical_or", "logical_not", "bitwise_and",
    "bitwise_or", "bitwise_not", "lerp", "addcmul", "addcdiv"))
_REDUCE_OPS = frozenset((
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod",
    "var", "std", "norm", "linalg_vector_norm", "logsumexp", "any", "all",
    "cumsum", "cumprod", "_softmax", "_log_softmax", "topk", "sort"))


def _tensors(x: Any) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(ts: Sequence[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


#: files whose frames stay out of op paths (``hide_frames``)
_HIDDEN: set = set()


def hide_frames(filename: str) -> None:
    """Keep a module's frames out of the recorded op paths: the dry-run's
    DTensor handlers, which stand between a model's function and its ops."""
    _HIDDEN.add(filename)


def _call_path(top: Any) -> Optional[str]:
    """The port's functions on the Python stack below the frame ``top``,
    outermost first (the recorder's own frames left out); None for an op
    that DTensor's sharding propagation runs."""
    names = []
    f = sys._getframe(2)
    while f is not None and f is not top:
        fn = f.f_code.co_filename
        if (fn.startswith(_PKG) and not fn.startswith(_CORE)
                and fn != _KERNELS_INIT and fn not in _HIDDEN):
            names.append(f.f_code.co_name)
        elif fn.endswith(_PROPAGATION_FILES):
            return None
        f = f.f_back
    return "/".join(reversed(names))


class _OpRecorder(TorchDispatchMode):
    """Records every aten op of a run, and one entry per kernel call;
    ``top`` is the frame that runs the recorded function."""

    def __init__(self, top: Any, host_free: bool = False) -> None:
        super().__init__()
        self.entries: List[CommandEntry] = []
        self._top = top
        self._host_free = host_free    # host-only ops are no commands
        self._inside = 0          # > 0 inside a kernel wrapper
        self.multiplier = 1       # stamped on each entry (``set_multiplier``)
        # (op, arguments) -> the outputs' layouts, for meta ops
        self._meta_outs: Dict[Any, Any] = {}

    def _add(self, e: CommandEntry) -> None:
        e.index = len(self.entries)
        e.multiplier = self.multiplier
        self.entries.append(e)

    # -- kernels (called by kernels.recorded) -------------------------------
    def kernel(self, fn: Callable, cost: Callable, args: tuple,
               kwargs: dict) -> Any:
        if self._inside:
            return fn(*args, **kwargs)
        self._inside += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._inside -= 1
        c = cost(*args, **kwargs)
        self._add(CommandEntry(
            index=0, name=c.name, opcode=c.name, computation="eager",
            multiplier=1, result_bytes=c.result_bytes,
            operand_bytes=c.operand_bytes, engine="kernel", flops=c.flops,
            op_path=c.name, raw=f"kernel {c.name} flops={c.flops} "
            f"in={c.operand_bytes}B out={c.result_bytes}B"))
        return out

    # -- aten ops ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._inside:
            return func(*args, **kwargs)
        # a DTensor op goes to DTensor's own dispatch, whose local ops (and
        # collectives) come back here; a fake tensor is sharding propagation
        if _subclass(types, "torch.distributed.tensor", "DTensor"):
            return NotImplemented
        if _subclass(types, "torch._subclasses.fake_tensor", "FakeTensor"):
            return func(*args, **kwargs)
        # under inference_mode a composite op (matmul, einsum, linear)
        # reaches the mode whole: record what it decomposes into, as it
        # would outside inference_mode
        if torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd):
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = self._meta_call(func, args, kwargs)
        self._record(func, args, kwargs, out)
        return out

    def _meta_call(self, func, args, kwargs) -> Any:
        """``func`` on its arguments.  A functional op on ``meta`` tensors
        (no view, nothing written) returns fresh tensors of the shapes,
        strides and types it returned before on the same arguments: its
        shape function runs in Python, at a cost the dry-run's million ops
        a cell would pay again and again."""
        key = _meta_key(func, args, kwargs)
        if key is None:
            return func(*args, **kwargs)
        known = self._meta_outs.get(key)
        if known is None:
            out = func(*args, **kwargs)
            known = _meta_layout(out)
            if known is not None:
                self._meta_outs[key] = known
            return out
        if isinstance(known, list):
            return tuple(_meta_empty(k) for k in known)
        return _meta_empty(known)

    def _record(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        op = packet.__name__
        base = op[:-1] if op.endswith("_") and not op.startswith("_") else op
        if func.is_view or op in _FREE_OPS or base in _FREE_OPS:
            return
        path = _call_path(self._top)
        if path is None:
            return
        namespace = func.namespace
        if namespace in ("_c10d_functional", "c10d", "_dtensor"):
            if op not in _FREE_COLLECTIVES:
                self._collective(func, namespace, op, args, kwargs, out, path)
            return
        written, read = [], []
        by_name: Dict[str, List[torch.Tensor]] = {}
        for i, a in enumerate(func._schema.arguments):
            ts = _tensors(args[i] if i < len(args) else kwargs.get(a.name))
            by_name[a.name] = ts
            if a.alias_info is not None and a.alias_info.is_write:
                written += ts
            else:
                read += ts
        results = _tensors(out)
        if self._host_free and all(t.device.type == "cpu"
                                   for t in read + written + results):
            return
        operand_b = _nbytes(read)
        if base in _GATHERS and read:
            operand_b += _nbytes(results) - _nbytes(read[:1])
        if written and base in _SCATTERS:
            # in place into rows: the write is the source's rows
            result_b = _nbytes(by_name.get("values") or by_name.get("source")
                               or by_name.get("src") or [])
        elif written:
            result_b = _nbytes(written)       # in place: one write, charged once
        else:
            result_b = _nbytes(results)
        flops = 0
        if packet in flop_registry:
            engine = "compute"
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        elif base in _TRANSFER_OPS or (
                base == "_to_copy" and results and read
                and results[0].device != read[0].device):
            engine = "transfer"
        else:
            engine = "other"
            if base in _ELEMENTWISE_OPS:
                flops = sum(t.numel() for t in (results or written))
            elif base in _REDUCE_OPS and read:
                flops = read[0].numel()
        shapes = ",".join(f"{list(t.shape)}" for t in read)
        raw = f"{func} ({shapes}) -> " + ",".join(
            f"{list(t.shape)}" for t in (results or written))
        self._add(CommandEntry(
            index=0, name=str(func), opcode=op, computation="eager",
            multiplier=1, result_bytes=result_b, operand_bytes=operand_b,
            engine=engine, flops=flops, op_path=f"{path}/{op}",
            raw=raw[:240]))

    def _collective(self, func, namespace, op, args, kwargs, out,
                    path) -> None:
        if (namespace, op) not in _COLLECTIVES:
            raise NotImplementedError(f"op recorder: collective {func} has no "
                                      f"opcode among COLLECTIVE_OPS")
        opcode, sent, written = _COLLECTIVES[(namespace, op)]
        named: Dict[str, Any] = {}
        for i, a in enumerate(func._schema.arguments):
            named[a.name] = args[i] if i < len(args) else kwargs.get(a.name)
        operand_b = _nbytes(_tensors(named[sent])) if sent else 0
        result_b = _nbytes(_tensors(named[written] if written else out))
        group = named.get("group_name", named.get("process_group"))
        n = _group_size(group)
        if opcode == "collective-permute-done":
            link = 0          # the send carries the bytes over the link
        else:
            link = _link_bytes(opcode, result_b, operand_b, n)
        shapes = [list(t.shape) for t in _tensors(
            named[sent] if sent else named[written])]
        self._add(CommandEntry(
            index=0, name=str(func), opcode=opcode, computation="eager",
            multiplier=1, result_bytes=result_b, operand_bytes=operand_b,
            engine="collective", group_size=n, link_bytes=link,
            op_path=f"{path}/{op}",
            raw=f"{func} {shapes} group={n} link={link}B"[:240]))

    def stream(self) -> CommandStream:
        """The recorded entries; ``text_bytes`` is the size of their listing
        (one ``raw`` line an entry)."""
        text = "\n".join(e.raw for e in self.entries)
        return CommandStream(entries=self.entries,
                             text_bytes=len(text.encode()),
                             n_ops=len(self.entries))


def set_multiplier(n: int) -> int:
    """Stamp ``n`` on the active recorder's next entries; returns the
    multiplier it replaces (1 while nothing records, and nothing set).
    For a scope that opens and closes in autograd's backward, where no
    ``with`` block spans it (``models.layers.weighted_layers``)."""
    rec = _kernels.recorder
    if not isinstance(rec, _OpRecorder):
        return 1
    prev, rec.multiplier = rec.multiplier, n
    return prev


def mark() -> Optional[int]:
    """The number of entries the active recorder holds, the position of
    the next; None while nothing records."""
    rec = _kernels.recorder
    return len(rec.entries) if isinstance(rec, _OpRecorder) else None


def restamp(at: Optional[int], n: int) -> None:
    """Stamp ``n`` on the entries recorded since the :func:`mark` ``at``: a
    layer found, once it has run, to stand for ``n`` layers."""
    rec = _kernels.recorder
    if at is None or not isinstance(rec, _OpRecorder):
        return
    for e in rec.entries[at:]:
        e.multiplier = n


class weighted_stacks:
    """A scope in which the models' layer loops, while a recorder records,
    record a weighted body in place of the layers that run the same
    program (``models.layers.layer_loop``); ``weighted_stacks(False)``
    turns it off inside.  :meth:`active` says whether a loop does so now.
    """

    _on = False

    def __init__(self, on: bool = True) -> None:
        self.on = on

    def __enter__(self) -> None:
        self.prev, weighted_stacks._on = weighted_stacks._on, self.on

    def __exit__(self, *exc: Any) -> None:
        weighted_stacks._on = self.prev

    @staticmethod
    def active() -> bool:
        return (weighted_stacks._on
                and isinstance(_kernels.recorder, _OpRecorder))


def recorded_call(fn: Callable, device: Optional[torch.device] = None
                  ) -> Tuple[Any, CommandStream, float]:
    """Run ``fn()`` once under the op recorder: its result, its op-level
    stream and the run's wall time (on a CUDA ``device`` until its current
    stream has run it).  On a ``device`` other than the CPU, an op whose
    tensors all lie on the host is host work, not a command, and is left
    out (DTensor's index bookkeeping)."""
    rec = _OpRecorder(sys._getframe(), host_free=device is not None
                      and device.type != "cpu")
    prev = _kernels.recorder
    _kernels.recorder = rec
    t0 = time.perf_counter()
    try:
        with rec:
            out = fn()
        if device is not None and device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
    finally:
        _kernels.recorder = prev
    return out, rec.stream(), time.perf_counter() - t0


def record_ops(fn: Callable, *args: Any) -> CommandStream:
    """The op-level command stream of one run of ``fn(*args)`` under
    ``torch.inference_mode()``, on any device."""
    with torch.inference_mode():
        return recorded_call(lambda: fn(*args))[1]
