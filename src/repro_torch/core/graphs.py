"""Execution graphs: launch modes and the command-footprint law, the port's
copy of ``repro.core.graphs``.

The paper's second case study (§6.3) explains CUDA Graph launch scaling with
two submission-level indicators: the **command footprint** (bytes of commands
the host emits per launch) and the **number of submission cycles** (doorbell
writes).  CUDA 11.8 launches a K-kernel chain with K-ish doorbells and a
footprint linear in K; CUDA 13.0 uses one doorbell and a near-constant
footprint.

On the card the experiment runs on the driver the paper studied.  A chain of
K identical nodes (``x *= scales[k]`` over ``width`` floats, one hand-written
kernel, ``kernels/csrc/exec_graph.cu``) is submitted in three modes that
differ only in how the same kernel reaches the stream:

* ``per_op``   — K launches, K doorbells;
* ``graphed``  — the K launches captured into ONE CUDA Graph: one doorbell,
  a footprint that grows with K;
* ``multistep``— one graph built with the runtime's graph API: a memset node
  zeroes a step counter, a conditional WHILE node runs a body of two kernel
  nodes (the node, and a one-thread node that advances the counter and sets
  the condition) K times.  One doorbell AND a footprint constant in K: the
  counterpart of the reference's ``lax.scan``.

**Footprint** (the port's stand-in for the paper's pushbuffer bytes, which
no API exposes): ``command_footprint(mode) -> (bytes, ops)`` is read from the
graph itself, never counted in Python.  ``ops`` is its node count
(``cudaGraphGetNodes``), conditional bodies included; ``bytes`` is the size
of its verbose description (``cudaGraphDebugDotPrint`` with
``cudaGraphDebugDotFlagsVerbose``), conditional bodies included: every node
with its type, kernel, launch geometry and parameters, which is what the
driver has to turn into commands.  ``per_op`` re-submits a one-node graph's
worth of commands K times, so its figure is the one-node graph's times K, as
in the reference.

:class:`CapturedStep` is the one place the port captures: ``fn()`` on fixed
buffers as one replay, the counterpart of ``jax.jit`` for one shape.  The
server's prefill and T-step decode, the ``graphed`` chain and
:class:`MultiStepLauncher` all go through it.  On the CPU (only when the
caller passes ``device="cpu"``) nothing is captured: every call runs the same
step function directly, the footprint fields are ``None`` and
``command_footprint`` raises.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import ctypes
import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device, wait
from ..kernels import KernelCost, _build, launches
from .doorbell import DoorbellTracker
from .session import TraceSession, resolve_session
from .stream import CommandStream, decode_graph, recorded_call

__all__ = ["LaunchStats", "ExecGraph", "MultiStepLauncher", "LAUNCH_MODES",
           "CapturedStep", "graph_footprint", "record_captures"]

LAUNCH_MODES = ("per_op", "graphed", "multistep")

_RECORDING: contextvars.ContextVar = contextvars.ContextVar(
    "record_captures", default=False)


@contextlib.contextmanager
def record_captures() -> Any:
    """Steps captured inside this block record their op-level stream
    (``CapturedStep.ops``).  Off by default: the recorder intercepts every
    op of the eager warm-up in Python, which costs a large gemma-2b decode
    warm-up some 20 times its eager time on the card's host."""
    token = _RECORDING.set(True)
    try:
        yield
    finally:
        _RECORDING.reset(token)


def graph_footprint(graphs: List[int]) -> Tuple[int, int]:
    """(bytes, nodes) of raw ``cudaGraph_t`` handles, summed: the size of
    each one's verbose ``cudaGraphDebugDotPrint`` and its node count."""
    lib = _build.library()
    total_bytes = total_nodes = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot").encode()
        for g in graphs:
            nodes, nbytes = ctypes.c_longlong(), ctypes.c_longlong()
            _build.check(lib.graph_footprint(g, path, ctypes.byref(nodes),
                                             ctypes.byref(nbytes)),
                         "graph_footprint")
            total_bytes += nbytes.value
            total_nodes += nodes.value
    return total_bytes, total_nodes


def node_cost(x: torch.Tensor, scales: torch.Tensor, k: int, index_ptr: int,
               stream: int) -> KernelCost:
    """One node kernel's work (``ExecGraph._node``): x and the node's scale
    and index read, x written; one multiply an element."""
    return KernelCost("exec_graph", x.numel(), x.numel() * 4 + 8,
                      x.numel() * 4)


# (bytes, nodes) of one node captured alone, by device and width
_ONE_NODE: Dict[Tuple[str, int], Tuple[int, int]] = {}


class CapturedStep:
    """``fn()`` as one CUDA Graph replay: the port's ``jax.jit`` for one shape.

    ``fn`` takes no arguments and works on tensors whose addresses stay fixed
    from call to call (parameters, static state and input buffers); what it
    allocates comes from the graph's own memory pool, and what it returns is
    rewritten in place by every replay.

    On a CUDA device, :meth:`capture` (or the first call) does four things:

    * runs ``fn`` once eagerly on a side stream, as PyTorch requires before
      capture; this also builds and loads the kernels' library, so that no
      ``nvcc`` or module load happens while a stream captures;
    * captures ``fn`` into a ``torch.cuda.CUDAGraph`` with its own pool,
      then instantiates and uploads it;
    * records the kernel launches (``kernels.launches``) the capture added,
      and takes them back: a capture launches nothing;
    * and every call then replays the graph and adds the recorded launches.

    Inside :func:`record_captures` the eager warm-up runs under the op
    recorder (``core.stream``): ``ops`` is the step's op-level command
    stream and ``record_s`` that run's time, so the stream is read without
    running ``fn`` again (a serving step writes its KV cache).
    ``pool_bytes`` is what the graph's memory pool took over the capture.

    A failed capture raises; there is no eager fallback on the card.  On the
    CPU every call runs ``fn`` directly (the first one inside
    :func:`record_captures` under the op recorder), so the CPU tests run
    exactly the code the card captures.
    """

    def __init__(self, fn: Callable[[], Any], device: torch.device) -> None:
        self.fn = fn
        self.device = device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Any = None
        self.launches: "collections.Counter[str]" = collections.Counter()
        self.ops: Optional[CommandStream] = None
        self.record_s = 0.0       # the recorded eager run, once
        self.upload_s = 0.0       # capture + instantiate + upload, once
        self.pool_bytes: Optional[int] = None

    def capture(self) -> None:
        if self.device.type != "cuda" or self.graph is not None:
            return
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            if _RECORDING.get():
                _, self.ops, self.record_s = recorded_call(self.fn,
                                                           self.device)
            else:
                self.fn()
        current.wait_stream(side)
        before = collections.Counter(launches)
        # the capture empties the allocator's cache first; so do we, so
        # that what is reserved after it is the graph's own pool
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph):
                out = self.fn()
        finally:
            added = collections.Counter(
                {k: n - before[k] for k, n in launches.items()
                 if n != before[k]})
            launches.clear()
            launches.update(before)
        graph.instantiate()
        _build.check(_build.library().graph_upload(
            graph.raw_cuda_graph_exec(), _build.stream_ptr(self.device)),
            "graph_upload")
        wait(self.device)
        self.upload_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph, self.out, self.launches = graph, out, added

    def __call__(self) -> Any:
        if self.device.type != "cuda":
            if self.ops is None and _RECORDING.get():
                self.out, self.ops, self.record_s = recorded_call(
                    self.fn, self.device)
                return self.out
            return self.fn()
        self.capture()
        self.graph.replay()
        launches.update(self.launches)
        return self.out

    def footprint(self) -> Tuple[int, int]:
        """(bytes, nodes) of the captured graph (:func:`graph_footprint`)."""
        if self.graph is None:
            raise RuntimeError("no graph: not captured, or on the CPU")
        return graph_footprint([self.graph.raw_cuda_graph()])


@dataclasses.dataclass
class LaunchStats:
    """The paper's three indicators for one launch."""

    mode: str
    chain_len: int
    doorbells: int                 # submission cycles
    command_bytes: Optional[int]   # footprint per launch; None on the CPU
    n_ops: Optional[int]           # graph nodes per launch; None on the CPU
    launch_s: float                # host wall time to submit (excl. completion)
    complete_s: float              # wall time to completion
    upload_s: float                # build/capture + instantiate + upload, once


class ExecGraph:
    """A chain of K identical nodes ``x -> x * scales[k]`` over ``width``
    float32 values.

    Mirrors the paper's benchmark graph: a linear chain of identical small
    kernels (scalar multiply over an N-element array), issued to one stream.
    ``device=None`` means ``cuda``.
    """

    def __init__(self, chain_len: int, width: int = 1024,
                 device: Optional[Any] = None) -> None:
        self.chain_len = int(chain_len)
        self.width = int(width)
        if self.chain_len < 1 or self.width < 1:
            raise ValueError(f"chain_len {chain_len} and width {width} must "
                             f"be positive")
        self.device = resolve_device(device)
        dev = self.device
        self.scales = torch.from_numpy(np.linspace(
            1.0, 1.0 + 1e-6, self.chain_len).astype(np.float32)).to(dev)
        self.x = torch.ones(self.width, dtype=torch.float32, device=dev)
        # node k reads scales[index[k]]; multistep's nodes read the counter
        self._index = torch.arange(self.chain_len, dtype=torch.int32,
                                   device=dev)
        self._counter = torch.zeros(1, dtype=torch.int32, device=dev)
        # pre-staged node pointers: per_op must measure dispatch cost, not
        # host-side indexing
        self._index_ptrs = [self._index.data_ptr() + 4 * k
                            for k in range(self.chain_len)]
        self._graphs: Dict[str, Any] = {}
        self._upload_s: Dict[str, float] = {}
        self._footprint: Dict[str, Tuple[int, int]] = {}

    def __del__(self) -> None:
        handle = getattr(self, "_graphs", {}).get("multistep")
        if isinstance(handle, int):
            _build.library().exec_graph_multistep_destroy(handle)

    # -- node ---------------------------------------------------------------
    def _node(self, k: int, stream: int) -> None:
        """Node k on the stream: the kernel, or its plain version on the CPU."""
        if self.device.type == "cpu":
            self.x.mul_(self.scales[k])
            return
        _build.check(_build.library().exec_graph_node(
            self.x.data_ptr(), self.scales.data_ptr(), self._index_ptrs[k],
            self.width, stream), "exec_graph")
        launches["exec_graph"] += 1

    def _stream(self) -> int:
        return (_build.stream_ptr(self.device) if self.device.type == "cuda"
                else 0)

    def _chain(self) -> None:
        stream = self._stream()
        for k in range(self.chain_len):
            self._node(k, stream)

    # -- instantiate + upload (≙ cudaGraphInstantiate/Upload) ---------------
    def upload(self, mode: str) -> None:
        if mode not in LAUNCH_MODES:
            raise ValueError(f"unknown mode {mode!r}")
        cuda = self.device.type == "cuda"
        t0 = time.perf_counter()
        if cuda:
            _build.check(_build.library().exec_graph_prepare(), "exec_graph")
        if mode == "per_op":
            self._graphs[mode] = None          # nothing to build
        elif mode == "graphed":
            step = CapturedStep(self._chain, self.device)
            step.capture()
            self._graphs[mode] = step
        elif not cuda:
            self._graphs[mode] = None
        else:
            handle = ctypes.c_void_p()
            _build.check(_build.library().exec_graph_multistep_build(
                self.x.data_ptr(), self.scales.data_ptr(),
                self._counter.data_ptr(), self.chain_len, self.width,
                self._stream(), ctypes.byref(handle)), "exec_graph multistep")
            self._graphs[mode] = handle.value
        wait(self.device)
        self._upload_s[mode] = time.perf_counter() - t0

    def _one_node_footprint(self) -> Tuple[int, int]:
        """The footprint of one node captured alone, measured once per
        device and width: the command each per_op launch re-submits (its
        description names addresses, whose digits differ between chains)."""
        key = (str(self.device), self.width)
        if key not in _ONE_NODE:
            one = CapturedStep(lambda: self._node(0, self._stream()),
                               self.device)
            one.capture()
            _ONE_NODE[key] = one.footprint()
        return _ONE_NODE[key]

    def command_footprint(self, mode: str) -> Tuple[int, int]:
        """(bytes, ops) of command stream submitted per *launch*, read from
        the graph (see the module's docstring).

        per_op re-submits its (single-node) graph chain_len times — the
        total emitted per launch grows with K, like CUDA 11.8's per-kernel
        command emission.  Raises on the CPU, where there is no graph.
        """
        if self.device.type != "cuda":
            raise RuntimeError("command_footprint: no graph on the CPU")
        if mode not in self._footprint:
            if mode not in self._graphs:
                self.upload(mode)
            if mode == "per_op":
                nbytes, nodes = self._one_node_footprint()
                self._footprint[mode] = (nbytes * self.chain_len,
                                         nodes * self.chain_len)
            elif mode == "graphed":
                self._footprint[mode] = self._graphs[mode].footprint()
            else:
                self._footprint[mode] = graph_footprint(
                    list(self._multistep_graphs()))
        return self._footprint[mode]

    def _multistep_graphs(self) -> Tuple[int, int]:
        """The multistep graph's top-level graph and its WHILE body."""
        graph, body = ctypes.c_void_p(), ctypes.c_void_p()
        _build.library().exec_graph_multistep_graphs(
            self._graphs["multistep"], ctypes.byref(graph), ctypes.byref(body))
        return graph.value, body.value

    def decode(self, mode: str) -> CommandStream:
        """The graph a ``graphed`` or ``multistep`` launch submits, decoded
        node by node (``core.stream.decode_graph``; card only)."""
        if self.device.type != "cuda" or mode == "per_op":
            raise RuntimeError(f"decode: no {mode} graph on {self.device}")
        if mode not in self._graphs:
            self.upload(mode)
        if mode == "graphed":
            return decode_graph(self._graphs[mode].graph)
        graph, body = self._multistep_graphs()
        return decode_graph(graph, [body])

    # -- launch (≙ cudaGraphLaunch) ------------------------------------------
    def launch(self, mode: str, tracker: Optional[DoorbellTracker] = None,
               session: Optional[TraceSession] = None
               ) -> Tuple[torch.Tensor, LaunchStats]:
        if mode not in self._graphs:
            self.upload(mode)
        tracker = tracker or DoorbellTracker(session=session)
        cuda = self.device.type == "cuda"
        cmd_bytes, n_ops = (self.command_footprint(mode) if cuda
                            else (None, None))
        self.x.fill_(1.0)
        stream = self._stream()
        wait(self.device)

        t0 = time.perf_counter()
        if mode == "per_op":
            for k in range(self.chain_len):
                self._node(k, stream)
                tracker.ring("per_op_dispatch")
        elif mode == "graphed":
            self._graphs[mode]()
            tracker.ring("graphed_dispatch")
        else:
            if cuda:
                _build.check(_build.library().exec_graph_multistep_launch(
                    self._graphs[mode], stream), "exec_graph multistep")
                launches["exec_graph"] += self.chain_len
                launches["exec_graph_advance"] += self.chain_len
            else:
                self._chain()       # the WHILE loop's plain version
            tracker.ring("multistep_dispatch")
        t1 = time.perf_counter()
        wait(self.device)
        t2 = time.perf_counter()

        doorbells = self.chain_len if mode == "per_op" else 1
        stats = LaunchStats(
            mode=mode, chain_len=self.chain_len, doorbells=doorbells,
            command_bytes=cmd_bytes, n_ops=n_ops,
            launch_s=t1 - t0, complete_s=t2 - t0,
            upload_s=self._upload_s.get(mode, 0.0))
        sess = resolve_session(session)
        if sess is not None:
            sess.emit("graph_launch", f"{mode}_launch", dur_s=stats.launch_s,
                      complete_s=stats.complete_s, t=t0, mode=mode,
                      chain_len=stats.chain_len, doorbells=stats.doorbells,
                      command_bytes=stats.command_bytes, n_ops=stats.n_ops)
        return self.x.clone(), stats

    def reference(self) -> torch.Tensor:
        """Oracle result of the chain."""
        prod = np.prod(self.scales.cpu().numpy().astype(np.float64))
        return torch.full((self.width,), float(np.float32(prod)),
                          dtype=torch.float32, device=self.device)


def _tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensors of nested tuples, lists and dicts."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _signature(tree: Any) -> Any:
    return _tree_map(lambda t: (tuple(t.shape), t.dtype, t.device), tree)


class MultiStepLauncher:
    """Train/serve K steps per launch — the footprint lesson applied.

    Runs ``step(carry, batch) -> (carry, aux)`` K times, over ``batches``
    stacked along a leading K axis, as one :class:`CapturedStep` replay (one
    graph per shape of ``(carry, batches)``, as ``jax.jit`` compiles one per
    shape): one doorbell submits K steps, and the aux values come back
    stacked.  Carry and batches are tensors or nested tuples, lists and
    dicts of them; each call copies them into the graph's fixed inputs and
    returns copies of its outputs.

    Unlike the reference's ``lax.scan``, whose command footprint is O(1) in
    K, the graph holds K copies of the step's launches: its footprint grows
    with K.  :class:`ExecGraph`'s ``multistep`` mode keeps the footprint
    constant with a conditional WHILE node, whose body must be fixed kernel
    nodes rather than a captured Python step.
    """

    def __init__(self, step_fn: Callable, k: int,
                 session: Optional[TraceSession] = None,
                 device: Optional[Any] = None) -> None:
        self.k = int(k)
        self.step_fn = step_fn
        self.device = resolve_device(device)
        self._session = session
        self.tracker = DoorbellTracker(session=session)
        self._graphs: Dict[Any, Tuple[CapturedStep, Any]] = {}

    def _k_steps(self, carry: Any, batches: Any) -> Tuple[Any, Any]:
        auxs = []
        for i in range(self.k):
            carry, aux = self.step_fn(carry, _tree_map(lambda t: t[i],
                                                       batches))
            auxs.append(aux)
        return carry, _tree_map(lambda *xs: torch.stack(xs), *auxs)

    def __call__(self, carry: Any, batches: Any) -> Tuple[Any, Any]:
        """``batches`` must be stacked along a leading K axis."""
        key = repr(_signature((carry, batches)))
        if key not in self._graphs:
            static = _tree_map(lambda t: t.detach().clone(), (carry, batches))
            self._graphs[key] = (CapturedStep(
                lambda: self._k_steps(*static), self.device), static)
        step, static = self._graphs[key]
        _tree_map(lambda dst, src: dst.copy_(src), static, (carry, batches))
        t0 = time.perf_counter()
        out = step()
        t1 = time.perf_counter()
        self.tracker.ring("multistep_launch")
        sess = resolve_session(self._session)
        if sess is not None:
            sess.emit("graph_launch", "multistep_launch", dur_s=t1 - t0,
                      t=t0, mode="multistep", chain_len=self.k, doorbells=1)
        return _tree_map(lambda t: t.clone(), out)
