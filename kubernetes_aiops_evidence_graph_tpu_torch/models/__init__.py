"""Public data-model surface (parity with reference src/models/__init__.py:45-84),
as keyword-only dataclasses (see _base.py)."""
from .incident import (
    Incident,
    IncidentCreate,
    IncidentSource,
    IncidentStatus,
    IncidentSummary,
    IncidentUpdate,
    Severity,
    utcnow,
)
from .evidence import (
    CollectorResult,
    DeploymentChange,
    Evidence,
    EvidenceSource,
    EvidenceType,
    GraphEntity,
    GraphRelation,
    LogEvidence,
    MetricDataPoint,
    MetricEvidence,
)
from .hypothesis import (
    DiagnosisRule,
    Hypothesis,
    HypothesisCategory,
    HypothesisFeedback,
    HypothesisSource,
    RCAResult,
)
from .action import (
    ActionRisk,
    ActionStatus,
    ActionType,
    ApprovalRequest,
    ApprovalResponse,
    BlastRadiusAssessment,
    Environment,
    RemediationAction,
    VerificationResult,
)
from .runbook import Runbook, RunbookStep

__all__ = [
    "Incident", "IncidentCreate", "IncidentUpdate", "IncidentSummary",
    "IncidentSource", "IncidentStatus", "Severity", "utcnow",
    "Evidence", "EvidenceType", "EvidenceSource", "GraphEntity",
    "GraphRelation", "CollectorResult", "MetricDataPoint", "MetricEvidence",
    "LogEvidence", "DeploymentChange",
    "Hypothesis", "HypothesisCategory", "HypothesisSource", "DiagnosisRule",
    "RCAResult", "HypothesisFeedback",
    "RemediationAction", "ActionType", "ActionRisk", "ActionStatus",
    "Environment", "VerificationResult", "BlastRadiusAssessment",
    "ApprovalRequest", "ApprovalResponse",
    "Runbook", "RunbookStep",
]
