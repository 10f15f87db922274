"""Hypothesis and RCA-result models.

Capability parity with the reference (src/models/hypothesis.py:12-176):
same 11 categories, 4 sources, confidence/rank/score-breakdown fields.
Extended with ``final_score`` (the ranker's output is persisted explicitly
rather than smuggled into a dict) and ``backend`` (cpu|tpu provenance).
"""
from __future__ import annotations

from dataclasses import field
from datetime import datetime
from enum import Enum
from typing import Optional
from uuid import UUID, uuid4

from ..utils.timeutils import utcnow
from ._base import Model, model, validate_fields


class HypothesisCategory(str, Enum):
    RESOURCE_EXHAUSTION = "resource_exhaustion"
    BAD_DEPLOYMENT = "bad_deployment"
    CONFIGURATION_ERROR = "configuration_error"
    DEPENDENCY_FAILURE = "dependency_failure"
    INFRASTRUCTURE_ISSUE = "infrastructure_issue"
    NETWORK_ISSUE = "network_issue"
    SCALING_ISSUE = "scaling_issue"
    SECURITY_ISSUE = "security_issue"
    EXTERNAL_DEPENDENCY = "external_dependency"
    DATA_ISSUE = "data_issue"
    UNKNOWN = "unknown"


class HypothesisSource(str, Enum):
    RULES_ENGINE = "rules_engine"
    LLM = "llm"
    HYBRID = "hybrid"
    MANUAL = "manual"
    GNN = "gnn"  # new: learned scorer


@model
class Hypothesis(Model):
    id: UUID = field(default_factory=uuid4)
    incident_id: UUID

    category: HypothesisCategory
    title: str
    description: str = ""

    confidence: float                    # in [0, 1]
    rank: int = 0
    final_score: float = 0.0

    supporting_evidence_ids: list[UUID] = field(default_factory=list)
    contradicting_evidence_ids: list[UUID] = field(default_factory=list)

    # Scoring breakdown (reference hypothesis.py:69-72)
    support_count: int = 0
    recency_weight: float = 0.0
    scope_weight: float = 0.0
    signal_strength: float = 0.0

    recommended_actions: list[str] = field(default_factory=list)

    why_not_notes: Optional[str] = None
    reasoning: Optional[str] = None

    rule_id: Optional[str] = None
    backend: str = "cpu"

    generated_at: datetime = field(default_factory=utcnow)
    generated_by: HypothesisSource = HypothesisSource.RULES_ENGINE


@model
class DiagnosisRule(Model):
    """Schema for a deterministic diagnosis rule (reference hypothesis.py:117)."""
    id: str
    name: str
    description: Optional[str] = None
    conditions: list[dict] = field(default_factory=list)
    hypothesis_template: str = ""
    category: HypothesisCategory = HypothesisCategory.UNKNOWN
    confidence_base: float = 0.5
    recommended_actions: list[str] = field(default_factory=list)
    priority: int = 50
    enabled: bool = True


@model
class RCAResult(Model):
    incident_id: UUID
    hypotheses: list[Hypothesis] = field(default_factory=list)
    top_hypothesis: Optional[Hypothesis] = None
    evidence_summary: str = ""
    analysis_duration_seconds: float = 0.0
    rules_matched: list[str] = field(default_factory=list)
    llm_used: bool = False
    backend: str = "cpu"
    generated_at: datetime = field(default_factory=utcnow)


@model
class HypothesisFeedback(Model):
    hypothesis_id: UUID
    was_correct: bool
    actual_root_cause: Optional[str] = None
    feedback_notes: Optional[str] = None
    submitted_by: str = "unknown"
    submitted_at: datetime = field(default_factory=utcnow)

    def __post_init__(self) -> None:
        # a request body: refuse and convert its values as pydantic does
        validate_fields(self)
