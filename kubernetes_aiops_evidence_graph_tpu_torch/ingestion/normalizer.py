"""Alert normalization: Alertmanager / Grafana / Prometheus payloads →
IncidentCreate.

Parity with the reference AlertNormalizer (normalizer.py:15-218): the same
severity map, title/cluster/service extraction order from labels, and the
sha256 fingerprint over source:alertname:namespace:service (:208-218, via
utils.hashing.alert_fingerprint).
"""
from __future__ import annotations

from typing import Any

from ..models import IncidentCreate, IncidentSource, Severity
from ..utils.hashing import alert_fingerprint
from ..utils.timeutils import parse_iso, utcnow

_SEVERITY_MAP = {
    "critical": Severity.CRITICAL,
    "error": Severity.HIGH,
    "high": Severity.HIGH,
    "warning": Severity.MEDIUM,
    "medium": Severity.MEDIUM,
    "info": Severity.INFO,
    "low": Severity.LOW,
    "none": Severity.INFO,
}


def _severity(raw: str | None) -> Severity:
    return _SEVERITY_MAP.get((raw or "").lower(), Severity.MEDIUM)


def _service_from(labels: dict[str, str]) -> str | None:
    for key in ("service", "app", "deployment", "job", "pod"):
        if labels.get(key):
            val = labels[key]
            if key == "pod":  # strip replicaset/pod suffixes
                parts = val.rsplit("-", 2)
                return parts[0] if len(parts) == 3 else val
            return val
    return None


def _title_from(labels: dict[str, str], annotations: dict[str, str]) -> str:
    alertname = labels.get("alertname", "UnknownAlert")
    subject = labels.get("pod") or labels.get("deployment") or labels.get("service")
    if annotations.get("summary"):
        return annotations["summary"][:500]
    return f"{alertname}: {subject}" if subject else alertname


class AlertNormalizer:
    """Classmethod-style API matching the reference normalizer."""

    @classmethod
    def normalize_alertmanager(cls, alert: dict[str, Any]) -> IncidentCreate:
        labels = alert.get("labels", {}) or {}
        annotations = alert.get("annotations", {}) or {}
        namespace = labels.get("namespace", "default")
        service = _service_from(labels)
        started = alert.get("startsAt")
        return IncidentCreate(
            fingerprint=alert_fingerprint(
                "alertmanager", labels.get("alertname", ""), namespace, service),
            title=_title_from(labels, annotations),
            description=annotations.get("description"),
            severity=_severity(labels.get("severity")),
            source=IncidentSource.ALERTMANAGER,
            cluster=labels.get("cluster", "default"),
            namespace=namespace,
            service=service,
            labels=dict(labels),
            annotations=dict(annotations),
            started_at=parse_iso(started) if started else utcnow(),
        )

    @classmethod
    def normalize_grafana(cls, payload: dict[str, Any]) -> list[IncidentCreate]:
        out = []
        for alert in payload.get("alerts", []) or []:
            labels = alert.get("labels", {}) or {}
            annotations = alert.get("annotations", {}) or {}
            namespace = labels.get("namespace", "default")
            service = _service_from(labels)
            started = alert.get("startsAt")
            out.append(IncidentCreate(
                fingerprint=alert_fingerprint(
                    "grafana", labels.get("alertname", payload.get("title", "")),
                    namespace, service),
                title=_title_from(labels, annotations) if labels
                else (payload.get("title") or "Grafana alert")[:500],
                description=annotations.get("description") or payload.get("message"),
                severity=_severity(labels.get("severity")),
                source=IncidentSource.GRAFANA,
                cluster=labels.get("cluster", "default"),
                namespace=namespace,
                service=service,
                labels=dict(labels),
                annotations=dict(annotations),
                started_at=parse_iso(started) if started else utcnow(),
            ))
        return out

    @classmethod
    def normalize_prometheus(cls, alert: dict[str, Any]) -> IncidentCreate:
        inc = cls.normalize_alertmanager(alert)
        return IncidentCreate(**{
            **inc.model_dump(),
            "source": IncidentSource.PROMETHEUS,
            "fingerprint": alert_fingerprint(
                "prometheus", inc.labels.get("alertname", ""),
                inc.namespace, inc.service),
        })
