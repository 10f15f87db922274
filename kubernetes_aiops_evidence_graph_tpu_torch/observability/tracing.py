"""Span tracing — actually wired, unlike the reference.

The reference declares OTel deps + a Tempo endpoint but contains zero
opentelemetry imports (SURVEY.md §5). Here: a dependency-free tracer with
workflow-step and collector spans, in-memory ring buffer + JSON export, and
a ``torch.profiler`` bridge for the device passes (``device_trace``).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional


@dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    name: str
    # absolute epoch bounds (OTLP export needs wall-clock nanos); the
    # DURATION is measured on the monotonic clock — an NTP step between
    # start and end must never yield a negative span
    start_s: float
    end_s: float = 0.0
    attributes: dict[str, Any] = field(default_factory=dict)
    status: str = "ok"
    start_mono: float = 0.0
    end_mono: float = 0.0

    @property
    def duration_ms(self) -> float:
        if self.end_mono or self.start_mono:
            return (self.end_mono - self.start_mono) * 1e3
        return (self.end_s - self.start_s) * 1e3

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "name": self.name,
            "start_s": self.start_s, "duration_ms": self.duration_ms,
            "attributes": self.attributes, "status": self.status,
        }


class Tracer:
    def __init__(self, max_spans: int = 4096) -> None:
        self._spans: list[Span] = []
        self._lock = threading.Lock()
        self._max = max_spans
        self._tls = threading.local()
        # spans silently evicted by the ring buffer — a tracer that loses
        # data without counting it is not auditable (graft-scope)
        self.dropped = 0
        # optional on-end hook (observability/otlp.OtlpExporter.enqueue);
        # must never raise into the traced code path
        self.on_end = None

    def _current(self) -> Optional[Span]:
        # the thread's own attribute dict: a missing attribute read through
        # getattr costs an exception on every tick of an untraced thread
        stack = self._tls.__dict__.get("stack")
        return stack[-1] if stack else None

    @contextlib.contextmanager
    def span(self, name: str, parent: "Span | tuple | None" = None,
             **attributes: Any) -> Iterator[Span]:
        """Open a span. ``parent`` overrides the thread-local stack with an
        explicit context — either a Span or a ``(trace_id, span_id)`` pair
        — so a workflow resumed on another thread (or launched from a
        webhook whose HTTP span is long closed) can still join its
        originating trace (graft-scope context propagation)."""
        if parent is None:
            parent = self._current()
        if isinstance(parent, tuple):
            trace_id, parent_id = parent
        elif parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = uuid.uuid4().hex[:16], None
        s = Span(
            trace_id=trace_id,
            span_id=uuid.uuid4().hex[:16],
            parent_id=parent_id,
            name=name,
            # graft-audit: allow[wall-clock] absolute epoch field for OTLP startTimeUnixNano; the duration uses start_mono
            start_s=time.time(),
            start_mono=time.monotonic(),
            attributes=attributes,
        )
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append(s)
        try:
            yield s
        except Exception as exc:
            s.status = f"error:{type(exc).__name__}"
            raise
        finally:
            s.end_mono = time.monotonic()
            # derive the epoch end from the monotonic duration so the
            # exported span is internally consistent even across an NTP
            # step mid-span
            s.end_s = s.start_s + (s.end_mono - s.start_mono)
            stack.pop()
            self._record(s)

    def _record(self, s: Span) -> None:
        with self._lock:
            self._spans.append(s)
            if len(self._spans) > self._max:
                evicted = len(self._spans) - self._max
                self.dropped += evicted
                from .metrics import TRACE_SPANS_DROPPED
                TRACE_SPANS_DROPPED.inc(float(evicted), site="tracer_ring")
                self._spans = self._spans[-self._max:]
        if self.on_end is not None:
            try:
                self.on_end(s)
            except Exception:  # graft-audit: allow[broad-except] telemetry hook must never break the traced path
                pass

    def emit(self, s: Span) -> None:
        """Record a pre-timed span built outside the context-manager path
        (graft-scope materializes a tick's stage spans retrospectively at
        the fetch boundary — one emit per fetched tick, zero span objects
        in the per-stage hot path)."""
        self._record(s)

    @contextlib.contextmanager
    def attach(self, span: Span) -> Iterator[Span]:
        """Push an ALREADY-OPEN span onto this thread's context stack
        without re-timing or re-recording it: workflow steps run on
        executor threads whose stack is empty, so without this every span
        a step opens (collector spans, serving-tick spans) would start an
        unrelated trace instead of parenting under the step."""
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append(span)
        try:
            yield span
        finally:
            stack.pop()

    def export(self, trace_id: str | None = None) -> list[dict]:
        with self._lock:
            return [s.to_dict() for s in self._spans
                    if trace_id is None or s.trace_id == trace_id]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


TRACER = Tracer()


@contextlib.contextmanager
def device_trace(log_dir: str, device=None) -> Iterator[None]:
    """torch.profiler bridge for the scoring path: wraps a block in a
    profiler trace (the host's CPU activity and, on the card, its CUDA
    activity: every kernel and copy with its device time) and writes it
    as a Chrome trace (``trace.json``, viewable in Perfetto or
    chrome://tracing) into ``log_dir`` at exit. ``device`` None is the
    card and raises without one; ``"cpu"`` traces the CPU activity only.

    On the card the trace opens with :data:`TRACE_LEAD_KERNELS` small
    kernels under a ``device_trace.lead`` range, then the block: late in
    a long process an H100 session was seen to lose the kernel records
    of its first ten launches (their launch calls recorded, the kernels
    not), in every session, whatever waited before them."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from ..device import resolve_device
    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        # the trace holds the block's device work, not what was queued
        # before it
        torch.cuda.synchronize(dev)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        if dev.type == "cuda":
            with record_function("device_trace.lead"):
                lead = torch.zeros(1, device=dev)
                for _ in range(TRACE_LEAD_KERNELS):
                    lead.add_(1.0)
                torch.cuda.synchronize(dev)
        try:
            yield
        finally:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


TRACE_LEAD_KERNELS = 128
"""Small kernels that open a card trace ahead of the traced block."""
