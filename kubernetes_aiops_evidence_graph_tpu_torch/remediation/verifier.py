"""Remediation verifier — did the action actually help?

Parity with the reference RemediationVerifier (verifier.py:24-193): compares
error-rate and restart signals before vs after (the reference diffs now vs
``offset 15m`` PromQL; here before-values are captured at execution time and
compared against current backend state), checks pod health (Running +
Ready), and succeeds only when metrics improved AND pods are healthy
(:37-43).
"""
from __future__ import annotations

from typing import Any

from ..models import Incident, RemediationAction, VerificationResult


class RemediationVerifier:
    def __init__(self, backend: Any) -> None:
        self.backend = backend

    def capture_baseline(self, incident: Incident) -> dict:
        """Snapshot pre-remediation signals (the 'offset 15m' side)."""
        ns, svc = incident.namespace, incident.service or ""
        pods = self.backend.list_pods(ns, svc)
        return {
            "error_rate": self.backend.query_metric(ns, svc, "error_rate") or 0.0,
            "restarts": sum(p.restart_count for p in pods),
            "healthy_pods": sum(
                1 for p in pods if p.phase == "Running" and p.ready),
            "total_pods": len(pods),
        }

    def verify(
        self,
        incident: Incident,
        action: RemediationAction,
        baseline: dict | None = None,
    ) -> VerificationResult:
        ns, svc = incident.namespace, incident.service or ""
        before = baseline or {}
        pods = self.backend.list_pods(ns, svc)
        healthy_after = sum(1 for p in pods if p.phase == "Running" and p.ready)
        restarts_after = sum(p.restart_count for p in pods)
        error_after = self.backend.query_metric(ns, svc, "error_rate") or 0.0

        error_before = before.get("error_rate", 0.0)
        restarts_before = before.get("restarts", 0)
        healthy_before = before.get("healthy_pods", 0)

        metrics_improved = (
            error_after <= error_before and restarts_after <= restarts_before
        )
        pods_healthy = len(pods) > 0 and healthy_after == len(pods)
        success = bool(metrics_improved and pods_healthy)  # verifier.py:37-43

        return VerificationResult(
            action_id=action.id,
            incident_id=incident.id,
            success=success,
            metrics_improved=metrics_improved,
            error_rate_before=error_before,
            error_rate_after=error_after,
            restart_count_before=int(restarts_before),
            restart_count_after=int(restarts_after),
            pods_healthy_before=int(healthy_before),
            pods_healthy_after=int(healthy_after),
            verification_details={
                "total_pods": len(pods),
                "action_type": action.action_type.value,
            },
        )
