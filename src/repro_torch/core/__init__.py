"""Core: the unified trace session, the doorbell tracker, the paper's
instruments (inline vs direct transfers, graph launch modes, progress
trackers) and the hardware peaks of roofline bounds."""
from .session import (BARRIER_EVENT, EVENT_KINDS, SPAN_EVENT, JsonlSink,
                      RingBufferSink, Sink, SpanFrame, SpanHandle, TraceEvent,
                      TraceSession, ambient_span, current_session,
                      resolve_session)
from .dma import (HybridMover, INLINE_THRESHOLD_DEFAULT, TransferRecord,
                  direct_put, inline_put, sweep_transfer)
from .doorbell import DoorbellRecord, DoorbellTracker, payload_bytes
from .graphs import (LAUNCH_MODES, CapturedStep, ExecGraph, LaunchStats,
                     MultiStepLauncher)
from .roofline import H100_SXM, HW, model_flops
from .semaphore import Heartbeat, ProgressTracker, SemaphoreToken

__all__ = [
    "BARRIER_EVENT", "EVENT_KINDS", "SPAN_EVENT", "JsonlSink",
    "RingBufferSink", "Sink", "SpanFrame", "SpanHandle", "TraceEvent",
    "TraceSession", "ambient_span", "current_session", "resolve_session",
    "HybridMover", "INLINE_THRESHOLD_DEFAULT", "TransferRecord",
    "direct_put", "inline_put", "sweep_transfer",
    "DoorbellRecord", "DoorbellTracker", "payload_bytes",
    "LAUNCH_MODES", "CapturedStep", "ExecGraph", "LaunchStats",
    "MultiStepLauncher",
    "H100_SXM", "HW", "model_flops",
    "Heartbeat", "ProgressTracker", "SemaphoreToken",
]
