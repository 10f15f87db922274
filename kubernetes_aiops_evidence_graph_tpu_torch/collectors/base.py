"""Collector base — template method with timing + error isolation.

Parity with the reference BaseCollector (src/services/collectors/base.py:33-111):
the evidence window is ``incident.started_at - evidence_time_window_minutes``
→ now; ``run()`` never raises — failures come back as an unsuccessful
CollectorResult; ``make_evidence`` stamps incident/namespace/window.
"""
from __future__ import annotations

import time
from datetime import datetime, timedelta
from typing import Any

from ..config import Settings, get_settings
from ..models import CollectorResult, Evidence, EvidenceSource, EvidenceType, Incident
from ..observability_hooks import observe_collector


class BaseCollector:
    name = "base"
    source = EvidenceSource.SIMULATOR

    def __init__(self, backend: Any, settings: Settings | None = None) -> None:
        self.backend = backend
        self.settings = settings or get_settings()

    def window(self, incident: Incident, now: datetime) -> tuple[datetime, datetime]:
        start = incident.started_at - timedelta(minutes=self.settings.evidence_time_window_minutes)
        return start, now

    def run(self, incident: Incident) -> CollectorResult:
        t0 = time.perf_counter()
        try:
            result = self.collect(incident)
            result.collector_name = self.name
        except Exception as exc:  # graft-audit: allow[broad-except] collector isolation (base.py:71-86): one bad collector never sinks the evidence pass
            result = CollectorResult(collector_name=self.name, success=False, errors=[str(exc)])
        result.duration_seconds = time.perf_counter() - t0
        observe_collector(self.name, result)
        return result

    def collect(self, incident: Incident) -> CollectorResult:
        raise NotImplementedError

    def make_evidence(
        self,
        incident: Incident,
        evidence_type: EvidenceType,
        entity_name: str,
        data: dict,
        signal_strength: float = 0.5,
        is_anomaly: bool = False,
        namespace: str | None = None,
        summary: str | None = None,
    ) -> Evidence:
        start, end = self.window(incident, getattr(self.backend, "now", incident.started_at))
        return Evidence(
            incident_id=incident.id,
            evidence_type=evidence_type,
            source=self.source,
            entity_name=entity_name,
            entity_namespace=namespace or incident.namespace,
            data=data,
            summary=summary,
            signal_strength=signal_strength,
            is_anomaly=is_anomaly,
            time_window_start=start,
            time_window_end=end,
        )
