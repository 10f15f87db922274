"""Remediation action, verification and blast-radius models.

Capability parity with the reference (src/models/action.py:12-263): same
14 action types, risk levels, 9-state status lifecycle, idempotency key,
blast-radius scoring fields, and approval request/response schemas.
"""
from __future__ import annotations

from dataclasses import field
from datetime import datetime
from enum import Enum
from typing import Any, Optional
from uuid import UUID, uuid4

from ..utils.timeutils import utcnow
from ._base import Model, model


class ActionType(str, Enum):
    RESTART_POD = "restart_pod"
    DELETE_POD = "delete_pod"
    RESTART_DEPLOYMENT = "restart_deployment"
    ROLLBACK_DEPLOYMENT = "rollback_deployment"
    SCALE_REPLICAS = "scale_replicas"
    CORDON_NODE = "cordon_node"
    DRAIN_NODE = "drain_node"
    UNCORDON_NODE = "uncordon_node"
    UPDATE_CONFIGMAP = "update_configmap"
    UPDATE_RESOURCE_LIMITS = "update_resource_limits"
    UPDATE_HPA = "update_hpa"
    RESTART_SERVICE = "restart_service"
    ESCALATE_TO_HUMAN = "escalate_to_human"
    CREATE_TICKET = "create_ticket"


class ActionRisk(str, Enum):
    LOW = "low"
    MEDIUM = "medium"
    HIGH = "high"
    CRITICAL = "critical"


class ActionStatus(str, Enum):
    PROPOSED = "proposed"
    PENDING_APPROVAL = "pending_approval"
    APPROVED = "approved"
    REJECTED = "rejected"
    EXECUTING = "executing"
    COMPLETED = "completed"
    FAILED = "failed"
    ROLLED_BACK = "rolled_back"
    SKIPPED = "skipped"


class Environment(str, Enum):
    DEV = "dev"
    STAGING = "staging"
    UAT = "uat"
    PROD = "prod"


@model
class RemediationAction(Model):
    id: UUID = field(default_factory=uuid4)
    incident_id: UUID
    hypothesis_id: Optional[UUID] = None

    idempotency_key: str

    action_type: ActionType
    target_resource: str
    target_namespace: str = "default"
    target_cluster: Optional[str] = None

    parameters: dict[str, Any] = field(default_factory=dict)

    risk_level: ActionRisk = ActionRisk.LOW
    blast_radius_score: float = 0.0       # in [0, 100]
    affected_replicas: int = 0
    environment: Environment = Environment.DEV

    status: ActionStatus = ActionStatus.PROPOSED
    status_reason: Optional[str] = None

    requires_approval: bool = True
    approved_by: Optional[str] = None
    approved_at: Optional[datetime] = None
    rejected_by: Optional[str] = None
    rejected_at: Optional[datetime] = None
    rejection_reason: Optional[str] = None

    executed_at: Optional[datetime] = None
    completed_at: Optional[datetime] = None
    execution_result: Optional[dict[str, Any]] = None
    error_message: Optional[str] = None

    can_rollback: bool = False
    rollback_action_id: Optional[UUID] = None

    created_at: datetime = field(default_factory=utcnow)
    created_by: str = "system"


@model
class VerificationResult(Model):
    id: UUID = field(default_factory=uuid4)
    action_id: UUID
    incident_id: UUID

    success: bool
    metrics_improved: bool

    error_rate_before: Optional[float] = None
    error_rate_after: Optional[float] = None
    latency_p99_before: Optional[float] = None
    latency_p99_after: Optional[float] = None
    restart_count_before: Optional[int] = None
    restart_count_after: Optional[int] = None

    pods_healthy_before: Optional[int] = None
    pods_healthy_after: Optional[int] = None

    verification_details: dict[str, Any] = field(default_factory=dict)
    verification_notes: Optional[str] = None

    verification_started_at: datetime = field(default_factory=utcnow)
    verified_at: datetime = field(default_factory=utcnow)
    wait_duration_seconds: int = 0


@model
class BlastRadiusAssessment(Model):
    action_type: ActionType = ActionType.ESCALATE_TO_HUMAN
    target_resource: str = ""
    target_namespace: str = "default"
    environment: Environment = Environment.DEV

    affected_pods: int = 0
    affected_services: int = 0
    affected_deployments: int = 0
    affected_users_estimate: Optional[int] = None

    base_score: float = 0.0
    environment_multiplier: float = 1.0
    criticality_multiplier: float = 1.0
    final_score: float = 0.0

    is_acceptable: bool = True
    requires_approval: bool = False
    risk_level: ActionRisk = ActionRisk.LOW
    warnings: list[str] = field(default_factory=list)


@model
class ApprovalRequest(Model):
    action_id: UUID
    incident_id: UUID
    incident_title: str
    action_type: ActionType
    target_resource: str
    target_namespace: str
    risk_level: ActionRisk
    blast_radius_score: float
    hypothesis_summary: str = ""
    evidence_summary: str = ""
    recommended_by: str = "kaeg-tpu"
    approval_deadline: Optional[datetime] = None


@model
class ApprovalResponse(Model):
    action_id: UUID
    approved: bool
    responder: str = "system"
    responded_at: datetime = field(default_factory=utcnow)
    notes: Optional[str] = None
