"""CPU-side signal extraction: evidence list → condition vector.

Faithful re-implementation of the reference's signal fold + condition
checkers (rules_engine.py:265-410), extended with the four conditions the
reference declared but never implemented (SURVEY.md §3.6 defect 5). This is
the accuracy oracle the TPU backend is parity-tested against.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Iterable

import numpy as np

from .ruleset import (
    Cond,
    MEMORY_HIGH_PCT,
    MULTIPLE_PODS_THRESHOLD,
    NETWORK_ERRORS_THRESHOLD,
    NUM_CONDS,
    POD_NOT_READY_SECONDS,
    PROBLEM_POD_RESTARTS,
)

_IMAGE_PULL_REASONS = {"ImagePullBackOff", "ErrImagePull", "ImageInspectError"}
_CONFIG_REASONS = {"ContainerCannotRun", "CreateContainerConfigError"}
_NETWORK_LOG_PATTERNS = {"network", "connection", "timeout"}


@dataclass
class Signals:
    """The folded signal state (reference _init_signals, rules_engine.py:274-290)."""
    waiting_reasons: set[str] = field(default_factory=set)
    terminated_reasons: set[str] = field(default_factory=set)
    log_patterns: set[str] = field(default_factory=set)
    has_recent_deploy: bool = False
    has_image_change: bool = False
    memory_usage_high: bool = False
    cpu_throttling: bool = False
    hpa_at_max: bool = False
    latency_high: bool = False
    node_issues: dict[str, Any] = field(default_factory=dict)
    restart_count: int = 0
    error_count: int = 0
    network_error_count: int = 0
    pod_not_ready: bool = False
    readiness_probe_failing: bool = False
    problem_pods_by_node: dict[str, int] = field(default_factory=lambda: defaultdict(int))
    evidence_ids: list[str] = field(default_factory=list)
    max_signal_strength: float = 0.0


def _is_problem_pod(data: dict) -> bool:
    """Mirror of the collector's signal heuristic (kubernetes_collector.py:269-285)."""
    return bool(
        data.get("waiting_reason")
        or data.get("terminated_reason")
        or (data.get("restart_count", 0) or 0) > PROBLEM_POD_RESTARTS
        or data.get("ready") is False
    )


def extract_signals(evidence: Iterable[dict]) -> Signals:
    """Fold evidence dicts into Signals (rules_engine.py:292-357 semantics)."""
    s = Signals()
    for ev in evidence:
        ev_id = ev.get("id")
        if ev_id is not None:
            s.evidence_ids.append(str(ev_id))
        s.max_signal_strength = max(s.max_signal_strength, float(ev.get("signal_strength", 0) or 0))
        data = ev.get("data", {}) or {}
        ev_type = ev.get("evidence_type")
        if ev_type == "kubernetes_pod":
            _fold_pod(data, s)
        elif ev_type == "deploy_change":
            if data.get("is_recent_change"):
                s.has_recent_deploy = True
        elif ev_type == "image_change":
            if data.get("image_changed"):
                s.has_image_change = True
        elif ev_type == "log_signal":
            for pat in data.get("patterns_found", []) or []:
                s.log_patterns.add(pat)
            s.error_count += int(data.get("error_count", 0) or 0)
            s.network_error_count += int(data.get("network_error_count", 0) or 0)
        elif ev_type == "metric_signal":
            _fold_metric(data, s)
        elif ev_type == "kubernetes_node":
            _fold_node(data, s)
        elif ev_type == "kubernetes_hpa":
            if data.get("at_max") or data.get("hpa_at_max"):
                s.hpa_at_max = True
    return s


def _fold_pod(data: dict, s: Signals) -> None:
    if data.get("waiting_reason"):
        s.waiting_reasons.add(data["waiting_reason"])
    if data.get("terminated_reason"):
        s.terminated_reasons.add(data["terminated_reason"])
    s.restart_count = max(s.restart_count, int(data.get("restart_count", 0) or 0))
    if data.get("ready") is False and float(data.get("not_ready_seconds", 0) or 0) >= POD_NOT_READY_SECONDS:
        s.pod_not_ready = True
    if data.get("readiness_probe_failing"):
        s.readiness_probe_failing = True
    if _is_problem_pod(data) and data.get("node"):
        s.problem_pods_by_node[data["node"]] += 1


def _fold_metric(data: dict, s: Signals) -> None:
    """Reference _process_metric_evidence (rules_engine.py:337-350), with
    thresholds applied to the series eval value (the family's windowed
    statistic — utils/metricseries.EVAL_STAT) instead of the last sample,
    so spikes that receded and trends toward a limit still register."""
    from ..utils.metricseries import metric_eval
    query_name = data.get("query_name", "") or ""
    value = metric_eval(data)
    if "memory" in query_name and data.get("is_anomalous") \
            and value > MEMORY_HIGH_PCT:
        s.memory_usage_high = True
    if "hpa" in query_name and "max" in query_name and value >= 1:
        s.hpa_at_max = True
    if "latency" in query_name and value > 1:
        s.latency_high = True
    if "throttl" in query_name and value > 0.5:
        s.cpu_throttling = True


def _fold_node(data: dict, s: Signals) -> None:
    """Reference _process_node_evidence (rules_engine.py:352-357)."""
    conds = data.get("conditions", {}) or {}
    ready = conds.get("Ready", {})
    status = ready.get("status") if isinstance(ready, dict) else ready
    if status != "True":
        s.node_issues[data.get("name", "?")] = conds


def condition_vector(s: Signals) -> np.ndarray:
    """Evaluate the full condition vocabulary against folded signals.

    Matches reference _check_condition truth semantics (rules_engine.py:380-410)
    for the nine conditions that existed, plus the four fixed ones.
    """
    v = np.zeros(NUM_CONDS, dtype=bool)
    v[Cond.WAITING_CRASHLOOP] = "CrashLoopBackOff" in s.waiting_reasons
    v[Cond.WAITING_IMAGE_PULL] = bool(s.waiting_reasons & _IMAGE_PULL_REASONS)
    v[Cond.TERMINATED_OOM] = "OOMKilled" in s.terminated_reasons
    v[Cond.TERMINATED_CONFIG] = bool(s.terminated_reasons & _CONFIG_REASONS)
    v[Cond.RECENT_DEPLOY] = s.has_recent_deploy
    v[Cond.NO_RECENT_DEPLOY] = not s.has_recent_deploy
    v[Cond.MEMORY_USAGE_HIGH] = s.memory_usage_high
    v[Cond.HPA_AT_MAX] = s.hpa_at_max
    v[Cond.LATENCY_HIGH] = s.latency_high
    v[Cond.LOG_PATTERN_NETWORK] = bool(s.log_patterns & _NETWORK_LOG_PATTERNS)
    v[Cond.NODE_UNHEALTHY] = bool(s.node_issues)
    v[Cond.MULTIPLE_PODS_SAME_NODE] = (
        max(s.problem_pods_by_node.values(), default=0) >= MULTIPLE_PODS_THRESHOLD
    )
    v[Cond.POD_NOT_READY] = s.pod_not_ready
    v[Cond.READINESS_PROBE_FAILING] = s.readiness_probe_failing
    v[Cond.NETWORK_ERRORS_HIGH] = s.network_error_count >= NETWORK_ERRORS_THRESHOLD
    return v
