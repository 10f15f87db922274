from .logging import BoundLogger, configure, get_logger
from .metrics import (
    ALERTS_DEDUPLICATED,
    ALERTS_RECEIVED,
    COLLECTOR_DURATION,
    EVIDENCE_COLLECTED,
    HYPOTHESES_GENERATED,
    INCIDENTS_CREATED,
    INCIDENTS_RESOLVED,
    RCA_DURATION,
    REGISTRY,
    REMEDIATION_ATTEMPTS,
    WEBHOOK_LATENCY,
    WORKFLOW_STEP_DURATION,
    WORKFLOW_STEPS,
    Counter,
    Gauge,
    Histogram,
    Registry,
)
from .tracing import TRACER, Span, Tracer

# wire the collector hook (avoids an import cycle at package load)
from .. import observability_hooks as _hooks
from .metrics import COLLECTOR_DURATION as _cd, EVIDENCE_COLLECTED as _ec


def _observe_collector(name: str, result) -> None:
    _cd.observe(result.duration_seconds, collector=name)
    _ec.inc(len(result.evidence), collector=name)


_hooks.set_collector_observer(_observe_collector)

__all__ = [
    "BoundLogger", "configure", "get_logger",
    "REGISTRY", "Counter", "Gauge", "Histogram", "Registry",
    "ALERTS_RECEIVED", "ALERTS_DEDUPLICATED", "INCIDENTS_CREATED",
    "INCIDENTS_RESOLVED", "REMEDIATION_ATTEMPTS", "HYPOTHESES_GENERATED",
    "EVIDENCE_COLLECTED", "WEBHOOK_LATENCY", "COLLECTOR_DURATION",
    "RCA_DURATION", "WORKFLOW_STEP_DURATION", "WORKFLOW_STEPS",
    "TRACER", "Tracer", "Span",
]
