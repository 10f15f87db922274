"""Runbook model (reference persists runbooks as a Postgres row,
src/services/runbook/generator.py:273-293 + scripts/init-db.sql runbooks
table)."""
from __future__ import annotations

from dataclasses import field
from datetime import datetime
from typing import Any
from uuid import UUID, uuid4

from ..utils.timeutils import utcnow
from ._base import Model, model


@model
class RunbookStep(Model):
    order: int
    title: str
    description: str = ""
    commands: list[str] = field(default_factory=list)


@model
class Runbook(Model):
    id: UUID = field(default_factory=uuid4)
    incident_id: UUID
    hypothesis_id: UUID | None = None
    title: str
    summary: str = ""
    steps: list[RunbookStep] = field(default_factory=list)
    kubectl_commands: list[str] = field(default_factory=list)
    investigation_queries: list[str] = field(default_factory=list)
    dashboard_links: dict[str, str] = field(default_factory=dict)
    metadata: dict[str, Any] = field(default_factory=dict)
    generated_at: datetime = field(default_factory=utcnow)
