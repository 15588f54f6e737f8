"""Core: the unified trace session, the doorbell tracker and the paper's
instruments: command-stream capture at the submission boundary (the
op-level stream and the decoded CUDA Graph), the Listing-1 report, the
three-term roofline, inline vs direct transfers, graph launch modes and
progress trackers."""
from .session import (BARRIER_EVENT, EVENT_KINDS, SPAN_EVENT, JsonlSink,
                      RingBufferSink, Sink, SpanFrame, SpanHandle, TraceEvent,
                      TraceSession, ambient_span, current_session,
                      resolve_session)
from .capture import CapturedStream, CommandStreamCapture, capture_fn
from .dma import (HybridMover, INLINE_THRESHOLD_DEFAULT, TransferRecord,
                  direct_put, inline_put, sweep_transfer)
from .doorbell import DoorbellRecord, DoorbellTracker, payload_bytes
from .graphs import (LAUNCH_MODES, CapturedStep, ExecGraph, LaunchStats,
                     MultiStepLauncher, record_captures)
from .report import render_roofline_row, render_submission
from .roofline import (H100_SXM, HW, RooflineReport, adjusted, analyze,
                       attribute, model_flops)
from .semaphore import Heartbeat, ProgressTracker, SemaphoreToken
from .stream import (COLLECTIVE_OPS, CommandEntry, CommandStream,
                     decode_graph, record_ops)

__all__ = [
    "BARRIER_EVENT", "EVENT_KINDS", "SPAN_EVENT", "JsonlSink",
    "RingBufferSink", "Sink", "SpanFrame", "SpanHandle", "TraceEvent",
    "TraceSession", "ambient_span", "current_session", "resolve_session",
    "CapturedStream", "CommandStreamCapture", "capture_fn",
    "HybridMover", "INLINE_THRESHOLD_DEFAULT", "TransferRecord",
    "direct_put", "inline_put", "sweep_transfer",
    "DoorbellRecord", "DoorbellTracker", "payload_bytes",
    "LAUNCH_MODES", "CapturedStep", "ExecGraph", "LaunchStats",
    "MultiStepLauncher", "record_captures",
    "COLLECTIVE_OPS", "CommandEntry", "CommandStream", "decode_graph",
    "record_ops", "render_submission", "render_roofline_row",
    "H100_SXM", "HW", "RooflineReport", "adjusted", "analyze", "attribute",
    "model_flops",
    "Heartbeat", "ProgressTracker", "SemaphoreToken",
]
