"""Jira integration — incident tickets.

Parity with the reference JiraClient (slack_client.py:116-206): creates a
Bug issue carrying the RCA description with the severity→priority map;
REST call gated on configuration with an offline queue.
"""
from __future__ import annotations

import base64
import json
import urllib.request
from typing import Optional

from ..config import Settings, get_settings
from ..models import Hypothesis, Incident

_PRIORITY = {
    "critical": "Highest", "high": "High", "medium": "Medium",
    "low": "Low", "info": "Lowest",
}


class JiraClient:
    def __init__(self, settings: Settings | None = None) -> None:
        self.settings = settings or get_settings()
        self.outbox: list[dict] = []

    @property
    def configured(self) -> bool:
        return bool(self.settings.jira_url)

    def create_incident_ticket(
        self,
        incident: Incident,
        top_hypothesis: Optional[Hypothesis] = None,
        evidence: tuple | list = (),
    ) -> dict:
        description = [f"Incident: {incident.title}",
                       f"Severity: {incident.severity.value}",
                       f"Namespace: {incident.namespace}",
                       f"Service: {incident.service or '-'}"]
        if top_hypothesis is not None:
            description += [
                "",
                f"Top hypothesis ({top_hypothesis.confidence:.0%}): "
                f"{top_hypothesis.title}",
                top_hypothesis.description,
                "Recommended actions:",
                *[f"- {a}" for a in top_hypothesis.recommended_actions],
            ]
        from ..runbook.generator import evidence_detail_lines
        detail = evidence_detail_lines(evidence)
        if detail:
            description += ["", "Key evidence:", *[f"- {d}" for d in detail]]
        payload = {
            "fields": {
                "project": {"key": self.settings.jira_project},
                "issuetype": {"name": "Bug"},
                "summary": f"[AIOps] {incident.title}",
                "description": "\n".join(description),
                "priority": {"name": _PRIORITY.get(incident.severity.value, "Medium")},
                "labels": ["aiops", f"severity-{incident.severity.value}"],
            }
        }
        if not self.configured:
            self.outbox.append(payload)
            return {"created": False, "queued": True, "payload": payload}
        req = urllib.request.Request(
            f"{self.settings.jira_url}/rest/api/2/issue",
            data=json.dumps(payload).encode(),
            headers={
                "Content-Type": "application/json",
                "Authorization": "Basic " + base64.b64encode(
                    f"{self.settings.jira_user}:{self.settings.jira_token}".encode()
                ).decode(),
            })
        with urllib.request.urlopen(req, timeout=15) as resp:  # noqa: S310
            body = json.loads(resp.read())
        return {"created": True, "key": body.get("key")}
