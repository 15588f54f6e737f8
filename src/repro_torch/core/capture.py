"""Command-stream capture at the submission boundary, the port's copy of
``repro.core.capture``.

The paper's watchpoint traps the userspace driver at the exact moment a
submission is committed (the doorbell write), guaranteeing a complete and
consistent view of the command stream.  In the port the submission unit is
a captured CUDA Graph (``core.graphs.CapturedStep``): its capture is the
commit boundary and every replay a doorbell.  :class:`CommandStreamCapture`
owns that boundary: everything captured through it is recorded, never
sampled, never partial, with two decoded streams:

* ``stream``, the op-level stream recorded during the step's eager warm-up
  (``core.stream.record_ops``'s recorder, inside ``record_captures()``):
  aten ops and one entry per port kernel, with FLOPs and bytes, on any
  device;
* ``graph_stream``, the graph itself decoded node by node
  (``core.stream.decode_graph``) on the card; ``None`` on the CPU and on
  ``meta``, where nothing is captured.

A step may take DTensors (``launch/dryrun.py``): the stream then holds
what this rank runs, and the argument and output bytes are those of its
local shards.  On ``meta`` nothing is allocated: the step is recorded in
one direct run, and ``memory`` holds no temp bytes.

``cost`` holds the op-level stream's ``{"flops", "bytes accessed"}``, the
counterpart of XLA's ``cost_analysis``; ``memory`` the argument, output and
(on the card) temp bytes, temp being what the graph's pool took over the
capture.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from ..device import resolve_device
from .graphs import CapturedStep, record_captures
from .session import TraceSession, resolve_session
from .stream import CommandStream, decode_graph

__all__ = ["CapturedStream", "CommandStreamCapture", "capture_fn"]


@dataclasses.dataclass
class CapturedStream:
    """One captured submission unit (≙ one GPFIFO entry + its pushbuffer)."""

    name: str
    step: CapturedStep                  # the captured step, replayed per call
    stream: CommandStream               # op-level stream
    graph_stream: Optional[CommandStream]   # decoded graph; None on the CPU
    cost: Dict[str, float]              # op-level {"flops", "bytes accessed"}
    memory: Dict[str, int]              # argument / output / temp bytes
    lower_time_s: float = 0.0           # the recorded eager run
    compile_time_s: float = 0.0         # capture + instantiate + upload

    # -- convenience -------------------------------------------------------
    @property
    def xla_flops(self) -> float:
        """The op-level count, under the reference's name for the
        compiler's own count."""
        return float(self.cost.get("flops", 0.0))

    @property
    def xla_bytes(self) -> float:
        return float(self.cost.get("bytes accessed", 0.0))

    @property
    def flops(self) -> int:
        return self.stream.total_flops

    @property
    def memory_bytes(self) -> int:
        return self.stream.memory_bytes

    @property
    def collective_link_bytes(self) -> int:
        return self.stream.collective_link_bytes

    @property
    def command_bytes(self) -> Optional[int]:
        """The graph's footprint in bytes; None on the CPU."""
        return None if self.graph_stream is None else self.graph_stream.text_bytes

    @property
    def n_ops(self) -> Optional[int]:
        """The graph's node count; None on the CPU."""
        return None if self.graph_stream is None else self.graph_stream.n_ops

    def summary(self) -> Dict[str, Any]:
        out = dict(self.stream.summary())
        out.update({
            "name": self.name,
            "command_bytes": self.command_bytes,
            "n_ops": self.n_ops,
            "op_entries": self.stream.n_ops,
            "xla_flops": self.xla_flops,
            "xla_bytes_accessed": self.xla_bytes,
            "lower_time_s": round(self.lower_time_s, 4),
            "compile_time_s": round(self.compile_time_s, 4),
            **{f"mem_{k}": v for k, v in self.memory.items()},
        })
        return out


def _nbytes(tree: Any) -> int:
    """Bytes of the tensors in nested tuples, lists and dicts; of a
    DTensor, its local shard's."""
    if isinstance(tree, torch.Tensor):
        tree = getattr(tree, "_local_tensor", tree)
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return 0


def _first_device(tree: Any) -> Optional[torch.device]:
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, (list, tuple)):
        for v in tree:
            dev = _first_device(v)
            if dev is not None:
                return dev
    return None


class CommandStreamCapture:
    """Owns the capture boundary and records every submission unit.

    Usage::

        cap = CommandStreamCapture()
        cs = cap.lower_and_compile("decode", model.decode_step,
                                   args=(params, state, tokens))
        cs.step()                       # one replay: one doorbell
        cs.graph_stream.counts_by_opcode()
    """

    def __init__(self, session: Optional[TraceSession] = None) -> None:
        self.captured: Dict[str, CapturedStream] = {}
        self._session = session

    def _emit(self, cs: CapturedStream, t: float) -> None:
        """Publish one ``compile`` event for a captured submission unit."""
        sess = resolve_session(self._session)
        if sess is not None:
            sess.emit("compile", cs.name,
                      dur_s=cs.lower_time_s + cs.compile_time_s, t=t,
                      command_bytes=cs.command_bytes, n_ops=cs.n_ops,
                      flops=cs.flops, memory_bytes=cs.memory_bytes)

    def _captured(self, name: str, step: CapturedStep, args_bytes: int,
                  t: float) -> CapturedStream:
        if step.ops is None:
            raise RuntimeError(f"{name}: the step recorded no op stream; "
                               f"capture it (on the CPU, call it first) "
                               f"inside core.graphs.record_captures()")
        cuda = step.device.type == "cuda"
        graph = decode_graph(step.graph) if cuda else None
        memory = {"argument_size_in_bytes": args_bytes,
                  "output_size_in_bytes": _nbytes(step.out)}
        if cuda:
            memory["temp_size_in_bytes"] = step.pool_bytes
        cs = CapturedStream(
            name=name, step=step, stream=step.ops, graph_stream=graph,
            cost={"flops": float(step.ops.total_flops),
                  "bytes accessed": float(step.ops.memory_bytes)},
            memory=memory, lower_time_s=step.record_s,
            compile_time_s=step.upload_s)
        self.captured[name] = cs
        self._emit(cs, t=t)
        return cs

    def lower_and_compile(self, name: str, fn: Callable,
                          args: Sequence[Any] = (),
                          kwargs: Optional[Dict[str, Any]] = None,
                          device: Optional[Any] = None) -> CapturedStream:
        """``fn(*args, **kwargs)`` as one :class:`CapturedStep` on the
        tensors it is given, which keep their addresses from replay to
        replay.  The step runs on the device of its first tensor argument
        (``device`` where given; the card where there is neither): on the
        card it is recorded, captured and decoded, on the CPU and on
        ``meta`` recorded in one direct run."""
        kwargs = kwargs or {}
        dev = (device if device is not None
               else _first_device([list(args), kwargs]))
        dev = (torch.device("meta") if torch.device(dev or "cuda").type
               == "meta" else resolve_device(dev))
        step = CapturedStep(lambda: fn(*args, **kwargs), dev)
        t0 = time.perf_counter()
        with record_captures():
            if dev.type == "cuda":
                step.capture()
            else:
                step()
        return self._captured(name, step, _nbytes([list(args), kwargs]), t0)

    def capture_compiled(self, name: str, step: CapturedStep
                         ) -> CapturedStream:
        """A :class:`CapturedStep` that already exists (``Server.graphs()``,
        the engine's ``graphs()``), captured inside ``record_captures()``:
        its graph decoded and the op stream recorded when it was captured
        (on the CPU, at its first call)."""
        return self._captured(name, step, 0, time.perf_counter())


def capture_fn(fn: Callable, *args, name: str = "fn", **kw) -> CapturedStream:
    """One-shot convenience wrapper."""
    return CommandStreamCapture().lower_and_compile(name, fn, args=args, **kw)
