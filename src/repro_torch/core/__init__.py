"""Core: the unified trace session and the doorbell tracker."""
from .doorbell import DoorbellRecord, DoorbellTracker, payload_bytes
from .session import (BARRIER_EVENT, EVENT_KINDS, SPAN_EVENT, JsonlSink,
                      RingBufferSink, Sink, SpanFrame, SpanHandle, TraceEvent,
                      TraceSession, ambient_span, current_session,
                      resolve_session)

__all__ = [
    "BARRIER_EVENT", "EVENT_KINDS", "SPAN_EVENT", "JsonlSink",
    "RingBufferSink", "Sink", "SpanFrame", "SpanHandle", "TraceEvent",
    "TraceSession", "ambient_span", "current_session", "resolve_session",
    "DoorbellRecord", "DoorbellTracker", "payload_bytes",
]
