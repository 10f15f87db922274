"""Evidence collectors (reference src/services/collectors/__init__.py:1-14).

``collect_all`` replaces the reference's collect_all_evidence activity loop
(activities.py:26-94) — and actually runs collectors concurrently when given
an executor (the reference's docstring claimed parallel but looped
sequentially, SURVEY.md §3.6 item 9).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any

from ..config import Settings
from ..models import CollectorResult, Incident
from .base import BaseCollector
from .deploy_diff import DeployDiffCollector
from .kubernetes import KubernetesCollector
from .logs import LogsCollector
from .metrics import MetricsCollector

ALL_COLLECTORS = (KubernetesCollector, LogsCollector, MetricsCollector, DeployDiffCollector)


def default_collectors(backend: Any, settings: Settings | None = None) -> list[BaseCollector]:
    return [cls(backend, settings) for cls in ALL_COLLECTORS]


def collect_all(
    incident: Incident,
    collectors: list[BaseCollector],
    parallel: bool = True,
) -> list[CollectorResult]:
    if parallel and len(collectors) > 1:
        with ThreadPoolExecutor(max_workers=len(collectors)) as pool:
            return list(pool.map(lambda c: c.run(incident), collectors))
    return [c.run(incident) for c in collectors]


__all__ = [
    "ALL_COLLECTORS", "BaseCollector", "KubernetesCollector", "LogsCollector",
    "MetricsCollector", "DeployDiffCollector", "collect_all", "default_collectors",
]
