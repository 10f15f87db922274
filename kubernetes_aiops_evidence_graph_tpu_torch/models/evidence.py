"""Evidence, graph-entity and collector-result models.

Capability parity with the reference (src/models/evidence.py:12-200): the
same 16 evidence types, 7 sources (plus a new ``simulator`` source), Evidence payload shape (``data`` dict +
``signal_strength`` in [0,1]), and the GraphEntity/GraphRelation node/edge
schema — here feeding an in-memory tensorized graph instead of Neo4j.
"""
from __future__ import annotations

from dataclasses import field
from datetime import datetime
from enum import Enum
from typing import Any, Optional
from uuid import UUID, uuid4

from ..utils.timeutils import utcnow
from ._base import Model, model


class EvidenceType(str, Enum):
    KUBERNETES_POD = "kubernetes_pod"
    KUBERNETES_DEPLOYMENT = "kubernetes_deployment"
    KUBERNETES_REPLICASET = "kubernetes_replicaset"
    KUBERNETES_EVENT = "kubernetes_event"
    KUBERNETES_NODE = "kubernetes_node"
    KUBERNETES_SERVICE = "kubernetes_service"
    KUBERNETES_CONFIGMAP = "kubernetes_configmap"
    KUBERNETES_HPA = "kubernetes_hpa"
    KUBERNETES_PVC = "kubernetes_pvc"
    LOG_SIGNAL = "log_signal"
    METRIC_SIGNAL = "metric_signal"
    DEPLOY_CHANGE = "deploy_change"
    CONFIG_CHANGE = "config_change"
    IMAGE_CHANGE = "image_change"
    DEPENDENCY_STATE = "dependency_state"
    NETWORK_TOPOLOGY = "network_topology"


class EvidenceSource(str, Enum):
    KUBERNETES_API = "kubernetes_api"
    PROMETHEUS = "prometheus"
    LOKI = "loki"
    ARGOCD = "argocd"
    HELM = "helm"
    GIT = "git"
    KUBE_STATE_METRICS = "kube_state_metrics"
    SIMULATOR = "simulator"  # new: hermetic replay backend


@model
class Evidence(Model):
    id: UUID = field(default_factory=uuid4)
    incident_id: UUID
    evidence_type: EvidenceType
    source: EvidenceSource

    entity_name: str
    entity_namespace: str = "default"
    entity_uid: Optional[str] = None

    data: dict[str, Any] = field(default_factory=dict)
    summary: Optional[str] = None

    signal_strength: float = 0.5          # in [0, 1]
    is_anomaly: bool = False

    collected_at: datetime = field(default_factory=utcnow)
    time_window_start: Optional[datetime] = None
    time_window_end: Optional[datetime] = None

    def __post_init__(self) -> None:
        if not 0.0 <= self.signal_strength <= 1.0:
            raise ValueError(
                f"signal_strength {self.signal_strength} outside [0, 1]")


@model
class GraphEntity(Model):
    """A node in the evidence graph (reference: Neo4j node, evidence.py:113)."""
    id: str
    type: str  # Incident|Pod|Deployment|Node|Service|HPA|ConfigMap|ChangeEvent|...
    properties: dict[str, Any] = field(default_factory=dict)


@model
class GraphRelation(Model):
    """An edge in the evidence graph (reference: evidence.py:134)."""
    source_id: str
    target_id: str
    relation_type: str  # AFFECTS|SCHEDULED_ON|OWNS|SELECTS|CALLS|HAS_RECENT_CHANGE|CORRELATES_WITH
    properties: dict[str, Any] = field(default_factory=dict)


@model
class CollectorResult(Model):
    """Bundle returned by one collector run (reference: evidence.py:152)."""
    collector_name: str
    success: bool = True
    evidence: list[Evidence] = field(default_factory=list)
    entities: list[GraphEntity] = field(default_factory=list)
    relations: list[GraphRelation] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)
    duration_seconds: float = 0.0


@model
class MetricDataPoint(Model):
    timestamp: datetime
    value: float
    labels: dict[str, str] = field(default_factory=dict)


@model
class MetricEvidence(Model):
    query: str
    metric_name: str
    data_points: list[MetricDataPoint] = field(default_factory=list)
    current_value: Optional[float] = None
    threshold: Optional[float] = None
    is_above_threshold: bool = False


@model
class LogEvidence(Model):
    pod_name: str
    container_name: str = ""
    log_lines: list[dict[str, Any]] = field(default_factory=list)
    error_count: int = 0
    warning_count: int = 0
    patterns_found: list[str] = field(default_factory=list)
    stack_traces: list[str] = field(default_factory=list)


@model
class DeploymentChange(Model):
    deployment_name: str
    namespace: str
    change_type: str  # image_update|config_change|scale|rollback
    old_value: Optional[str] = None
    new_value: Optional[str] = None
    changed_at: datetime
    changed_by: Optional[str] = None
    revision: int = 0
