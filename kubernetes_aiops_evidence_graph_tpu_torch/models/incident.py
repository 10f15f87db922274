"""Incident model — the central entity linking evidence, hypotheses, actions.

Capability parity with the reference (src/models/incident.py:12-132):
same severity/status/source vocabularies and K8s context fields, so alert
payloads and persisted rows are interchangeable between the two systems.
"""
from __future__ import annotations

from dataclasses import field
from datetime import datetime
from enum import Enum
from typing import Optional
from uuid import UUID, uuid4

from ..utils.timeutils import utcnow
from ._base import Model, model


class Severity(str, Enum):
    CRITICAL = "critical"
    HIGH = "high"
    MEDIUM = "medium"
    LOW = "low"
    INFO = "info"


class IncidentStatus(str, Enum):
    OPEN = "open"
    INVESTIGATING = "investigating"
    IDENTIFIED = "identified"
    REMEDIATING = "remediating"
    RESOLVED = "resolved"
    CLOSED = "closed"


class IncidentSource(str, Enum):
    ALERTMANAGER = "alertmanager"
    GRAFANA = "grafana"
    PROMETHEUS = "prometheus"
    MANUAL = "manual"
    SYNTHETIC = "synthetic"


@model
class Incident(Model):
    id: UUID = field(default_factory=uuid4)
    fingerprint: str
    title: str
    description: Optional[str] = None
    severity: Severity = Severity.MEDIUM
    status: IncidentStatus = IncidentStatus.OPEN
    source: IncidentSource = IncidentSource.MANUAL

    # Kubernetes context
    cluster: str = "local"
    namespace: str = "default"
    service: Optional[str] = None

    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)

    started_at: datetime = field(default_factory=utcnow)
    acknowledged_at: Optional[datetime] = None
    resolved_at: Optional[datetime] = None
    created_at: datetime = field(default_factory=utcnow)
    updated_at: datetime = field(default_factory=utcnow)


@model
class IncidentCreate(Model):
    fingerprint: str
    title: str
    description: Optional[str] = None
    severity: Severity
    source: IncidentSource
    cluster: str = "local"
    namespace: str = "default"
    service: Optional[str] = None
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    started_at: datetime = field(default_factory=utcnow)


@model
class IncidentUpdate(Model):
    title: Optional[str] = None
    description: Optional[str] = None
    severity: Optional[Severity] = None
    status: Optional[IncidentStatus] = None
    acknowledged_at: Optional[datetime] = None
    resolved_at: Optional[datetime] = None


@model
class IncidentSummary(Model):
    id: UUID
    fingerprint: str
    title: str
    severity: Severity
    status: IncidentStatus
    cluster: str
    namespace: str
    service: Optional[str] = None
    started_at: datetime
