"""OTLP/HTTP span export — ships the in-process tracer's spans to Tempo.

The reference declares a Tempo OTLP endpoint (docker-compose.yml:149-161,
observability/tempo/tempo.yaml) and OTel settings (settings.py:90-91) but
contains zero opentelemetry imports, so nothing ever ships. Here the
dependency-free tracer (tracing.py) gets a real exporter: spans are
enqueued on end and a daemon thread POSTs OTLP/HTTP JSON batches to
``{endpoint}/v1/traces``. Export is best-effort — a dead collector never
blocks or fails the pipeline (same degradation polarity as collectors).
"""
from __future__ import annotations

import http.client
import json
import threading
import urllib.request
from typing import Any

from .tracing import Span

_FLUSH_INTERVAL_S = 2.0
_MAX_BATCH = 512
_MAX_QUEUE = 8192


def _otlp_value(v: Any) -> dict:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def span_to_otlp(s: Span) -> dict:
    """One tracer Span -> OTLP JSON span (trace ids padded to 32 hex)."""
    return {
        "traceId": s.trace_id.zfill(32)[:32],
        "spanId": s.span_id.zfill(16)[:16],
        **({"parentSpanId": s.parent_id.zfill(16)[:16]} if s.parent_id else {}),
        "name": s.name,
        "kind": 1,  # SPAN_KIND_INTERNAL
        "startTimeUnixNano": str(int(s.start_s * 1e9)),
        "endTimeUnixNano": str(int(s.end_s * 1e9)),
        "attributes": [{"key": k, "value": _otlp_value(v)}
                       for k, v in s.attributes.items()],
        "status": ({"code": 1} if s.status == "ok"
                   else {"code": 2, "message": s.status}),
    }


class OtlpExporter:
    """Batching background exporter. Attach with ``TRACER.on_end``."""

    def __init__(self, endpoint: str, service_name: str = "kaeg-tpu",
                 flush_interval_s: float = _FLUSH_INTERVAL_S) -> None:
        self.endpoint = endpoint.rstrip("/")
        self.service_name = service_name
        self._queue: list[Span] = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._dropped = 0
        self._exported = 0
        self._flush_interval_s = flush_interval_s
        self.tracer = None     # set by attach(); read by stats()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="kaeg-otlp-export")
        self._thread.start()

    def attach(self, tracer) -> "OtlpExporter":
        """Wire this exporter as the tracer's on-end hook and remember the
        tracer so stats() can report ITS ring-buffer losses too — one
        stats surface for every place the telemetry path can drop data."""
        tracer.on_end = self.enqueue
        self.tracer = tracer
        return self

    # -- producer side ----------------------------------------------------

    def enqueue(self, span: Span) -> None:
        with self._lock:
            if len(self._queue) >= _MAX_QUEUE:
                self._count_dropped(1)  # bounded queue: never grow unbounded
                return                  # when the collector is down
            self._queue.append(span)
        if len(self._queue) >= _MAX_BATCH:
            self._wake.set()

    def _count_dropped(self, n: int) -> None:
        """Caller holds ``_lock``."""
        self._dropped += n
        from .metrics import TRACE_SPANS_DROPPED
        TRACE_SPANS_DROPPED.inc(float(n), site="exporter_queue")

    # -- consumer side ----------------------------------------------------

    def _loop(self) -> None:
        while not self._stop:
            self._wake.wait(self._flush_interval_s)
            self._wake.clear()
            self.flush()

    def flush(self) -> int:
        """Drain and POST one batch; returns spans shipped (0 on failure —
        the batch is dropped, not retried: traces are telemetry, and a dead
        Tempo must not grow host memory)."""
        with self._lock:
            batch, self._queue = self._queue[:_MAX_BATCH], self._queue[_MAX_BATCH:]
        if not batch:
            return 0
        body = json.dumps({
            "resourceSpans": [{
                "resource": {"attributes": [{
                    "key": "service.name",
                    "value": {"stringValue": self.service_name}}]},
                "scopeSpans": [{
                    "scope": {"name": "kaeg.tracer"},
                    "spans": [span_to_otlp(s) for s in batch],
                }],
            }],
        }).encode()
        try:
            req = urllib.request.Request(
                self.endpoint + "/v1/traces", body,
                {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=5) as resp:
                resp.read()
            with self._lock:   # daemon flush and manual flush/close race
                self._exported += len(batch)
            return len(batch)
        except (OSError, http.client.HTTPException):
            # dead/unreachable collector: RETAIN the batch (front of the
            # queue, original order) up to the bounded-queue cap so a
            # transient outage loses nothing; beyond the cap the overflow
            # is dropped and counted. Never block or fail the traced path
            # (export stays best-effort); returning 0 is what stops the
            # close() drain loop from spinning on a dead endpoint.
            with self._lock:
                space = _MAX_QUEUE - len(self._queue)
                keep = batch[:space] if space > 0 else []
                self._queue[:0] = keep
                if len(batch) > len(keep):
                    self._count_dropped(len(batch) - len(keep))
            return 0

    def stats(self) -> dict:
        with self._lock:
            return {"queued": len(self._queue), "exported": self._exported,
                    "dropped": self._dropped,
                    # the tracer's own ring-buffer evictions, when attached:
                    # every loss site in the span path, one surface
                    "tracer_dropped": getattr(self.tracer, "dropped", 0)}

    def close(self) -> None:
        """Stop the flush thread and drain what a live collector will
        take. Idempotent, and flush() stays safe to call afterwards (a
        final manual flush after close is the shutdown idiom)."""
        self._stop = True
        self._wake.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2)
        while self.flush():   # drain the whole backlog, not one batch
            pass
