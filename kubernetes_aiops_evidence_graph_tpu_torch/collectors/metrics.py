"""Metrics collector — alert-driven PromQL category selection over
time-series windows.

Parity with the reference MetricsCollector (metrics_collector.py:31-329):
loads the promql library, selects categories by alertname keywords
(:78-99), queries the backend per named query over the evidence window
(``query_range``, step = max(15, range/100), :161-185), downsamples to
≤``max_metric_points`` and keeps last-50 values + min/max/avg/current
(:195-245), and applies the per-family anomaly thresholds (:247-329) to
set signal strength. Unlike the reference — which collects the series but
thresholds only the final sample — the threshold applies to the family's
windowed statistic (utils/metricseries.EVAL_STAT), so spikes that receded
and trends racing toward a limit still flip rules. Emits one METRIC_SIGNAL
evidence per query with ``query_name`` / ``current_value`` /
``eval_value`` / ``is_anomalous`` + the stats block — the keys the signal
folds read (rules_engine.py:337-350).
"""
from __future__ import annotations

from pathlib import Path

import json

from ..models import CollectorResult, EvidenceSource, EvidenceType, Incident
from ..utils.metricseries import (
    EVAL_STAT, downsample, eval_value, series_stats,
)
from ..utils.timeutils import to_epoch_s
from .base import BaseCollector

_QUERIES_PATH = Path(__file__).resolve().parent.parent / "config" / "promql_queries.json"

# alertname keyword -> categories (reference :78-99)
_KEYWORD_CATEGORIES = (
    ("crash", ("crashloop", "resource")),
    ("oom", ("oom", "resource")),
    ("memory", ("oom", "resource")),
    ("imagepull", ("deployment",)),
    ("notready", ("node", "deployment")),
    ("node", ("node",)),
    ("hpa", ("hpa", "latency")),
    ("scal", ("hpa", "latency")),
    ("latency", ("latency", "error_rate")),
    ("slow", ("latency", "error_rate")),
    ("error", ("error_rate", "network")),
    ("throttl", ("resource",)),
)
_DEFAULT_CATEGORIES = ("crashloop", "resource", "error_rate")

# query family -> (threshold, predicate description) (reference :247-329)
_THRESHOLDS: dict[str, float] = {
    "pod_restarts": 5.0,
    "error_rate": 0.1,
    "memory_usage_pct": 90.0,
    "latency_p99_seconds": 5.0,
    "cpu_throttle_ratio": 0.5,
    "oom_events": 0.0,      # any OOM is anomalous (strict >)
    "hpa_at_max": 0.5,      # gauge 0/1
}
_STRENGTH: dict[str, float] = {
    "pod_restarts": 0.9,
    "error_rate": 0.9,
    "memory_usage_pct": 0.9,
    "latency_p99_seconds": 0.9,
    "cpu_throttle_ratio": 0.8,
    "oom_events": 0.95,
    "hpa_at_max": 0.8,
}


from functools import lru_cache


@lru_cache(maxsize=1)
def load_query_library() -> dict[str, dict[str, str]]:
    # memoized: the live backend renders a query per metric per collect and
    # must not re-read/re-parse the library on the per-query hot path. The
    # library is the JAX package's promql_queries.yaml, shipped as JSON so
    # the port needs no YAML parser.
    with open(_QUERIES_PATH) as fh:
        return json.load(fh)


def select_categories(alertname: str) -> list[str]:
    lowered = (alertname or "").lower()
    cats: list[str] = []
    for keyword, categories in _KEYWORD_CATEGORIES:
        if keyword in lowered:
            for c in categories:
                if c not in cats:
                    cats.append(c)
    return cats or list(_DEFAULT_CATEGORIES)


class MetricsCollector(BaseCollector):
    name = "metrics"
    source = EvidenceSource.PROMETHEUS

    def __init__(self, backend, settings=None) -> None:
        super().__init__(backend, settings)
        self.library = load_query_library()

    def _fetch_series(self, incident: Incident,
                      query_name: str) -> list[tuple[float, float]]:
        """Window series from the backend; instant-value fallback when the
        backend predates query_metric_range (single-sample series — stats
        then degenerate to the instant semantics)."""
        start, end = self.window(
            incident, getattr(self.backend, "now", incident.started_at))
        start_s, end_s = to_epoch_s(start), to_epoch_s(end)
        range_fn = getattr(self.backend, "query_metric_range", None)
        if range_fn is not None:
            samples = range_fn(incident.namespace, incident.service,
                               query_name, start_s, end_s)
            if samples:
                return downsample(sorted(samples),
                                  self.settings.max_metric_points)
        value = self.backend.query_metric(
            incident.namespace, incident.service, query_name)
        return [] if value is None else [(end_s, float(value))]

    def collect(self, incident: Incident) -> CollectorResult:
        result = CollectorResult(collector_name=self.name)
        if not incident.service:
            return result
        alertname = incident.labels.get("alertname", incident.title)
        seen: set[str] = set()
        for category in select_categories(alertname):
            for query_name in self.library.get(category, {}):
                if query_name in seen:
                    continue
                seen.add(query_name)
                samples = self._fetch_series(incident, query_name)
                if not samples:
                    continue
                stats = series_stats(samples)
                ev = eval_value(query_name, stats)
                threshold = _THRESHOLDS.get(query_name)
                anomalous = (threshold is not None and ev is not None
                             and ev > threshold)
                result.evidence.append(self.make_evidence(
                    incident, EvidenceType.METRIC_SIGNAL, incident.service,
                    {
                        "query_name": query_name,
                        "category": category,
                        "current_value": float(stats["current_value"]),
                        "eval_value": None if ev is None else float(ev),
                        "eval_stat": EVAL_STAT.get(query_name, "current"),
                        "threshold": threshold,
                        "is_anomalous": anomalous,
                        **{k: stats[k] for k in
                           ("values", "num_points", "min_value", "max_value",
                            "avg_value", "trend_per_min")},
                    },
                    signal_strength=_STRENGTH.get(query_name, 0.5) if anomalous else 0.3,
                    is_anomaly=anomalous,
                ))
        return result
