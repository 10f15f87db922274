"""Remediation orchestrator — risk, blast radius, policy, proposal.

Parity with the reference RemediationOrchestrator (orchestrator.py:18-184):
same per-action risk map (:22-34), blast-radius formula — pods×5 +
deployments×10, ×1.5 for critical namespaces, × env multiplier
(dev 1 / staging 2 / uat 2.5 / prod 5), capped at 100, max-score/
not-acceptable on error (:39-108) — idempotency key
``{incident}_{action}_{target}_{YYYYMMDDHH}`` (:141) and the dev
auto-approve override (:156-157). Cluster reads go through the backend
interface instead of the kubernetes client.
"""
from __future__ import annotations

from typing import Any, Optional

from ..config import Settings, get_settings
from ..models import (
    ActionRisk,
    ActionStatus,
    ActionType,
    BlastRadiusAssessment,
    Environment,
    Incident,
    RemediationAction,
)
from ..policy import PolicyEngine
from ..utils.timeutils import utcnow

ACTION_RISKS: dict[ActionType, ActionRisk] = {
    ActionType.RESTART_POD: ActionRisk.LOW,
    ActionType.DELETE_POD: ActionRisk.LOW,
    ActionType.RESTART_DEPLOYMENT: ActionRisk.LOW,
    ActionType.SCALE_REPLICAS: ActionRisk.LOW,
    ActionType.ROLLBACK_DEPLOYMENT: ActionRisk.MEDIUM,
    ActionType.CORDON_NODE: ActionRisk.MEDIUM,
    ActionType.UNCORDON_NODE: ActionRisk.MEDIUM,
    ActionType.DRAIN_NODE: ActionRisk.HIGH,
    ActionType.UPDATE_CONFIGMAP: ActionRisk.HIGH,
    ActionType.UPDATE_RESOURCE_LIMITS: ActionRisk.HIGH,
    ActionType.UPDATE_HPA: ActionRisk.MEDIUM,
}

_ENV_MULTIPLIER = {"dev": 1.0, "staging": 2.0, "uat": 2.5, "prod": 5.0}
_CRITICAL_NAMESPACES = {"default", "platform", "core-services"}
_ENV_MAP = {
    "development": Environment.DEV, "dev": Environment.DEV,
    "staging": Environment.STAGING, "uat": Environment.UAT,
    "production": Environment.PROD, "prod": Environment.PROD,
}


class RemediationOrchestrator:
    def __init__(self, backend: Any, settings: Settings | None = None,
                 policy: PolicyEngine | None = None) -> None:
        self.backend = backend
        self.settings = settings or get_settings()
        self.policy = policy or PolicyEngine()

    def calculate_blast_radius(self, incident: Incident) -> BlastRadiusAssessment:
        env = self.settings.environment
        try:
            affected_pods = 0
            affected_deployments = 0
            if incident.service:
                deploys = self.backend.list_deployments(incident.namespace,
                                                        incident.service)
                if deploys:
                    affected_pods = deploys[0].replicas or 1
                    affected_deployments = 1
            multiplier = _ENV_MULTIPLIER.get(env, 3.0)
            base = affected_pods * 5 + affected_deployments * 10
            criticality = 1.5 if incident.namespace in _CRITICAL_NAMESPACES else 1.0
            base *= criticality
            final = min(base * multiplier, 100.0)
            return BlastRadiusAssessment(
                target_resource=incident.service or "",
                target_namespace=incident.namespace,
                environment=_ENV_MAP.get(env, Environment.PROD),
                affected_pods=affected_pods,
                affected_deployments=affected_deployments,
                base_score=base,
                environment_multiplier=multiplier,
                criticality_multiplier=criticality,
                final_score=round(final, 2),
                is_acceptable=final < self.settings.remediation_max_blast_radius,
            )
        except Exception as exc:  # graft-audit: allow[broad-except] max score on error (:102-108): assessment fails closed
            return BlastRadiusAssessment(
                target_namespace=incident.namespace,
                final_score=100.0,
                is_acceptable=False,
                warnings=[str(exc)],
            )

    def propose_action(
        self,
        incident: Incident,
        action_type: str,
        target_resource: str,
        parameters: Optional[dict] = None,
        blast: BlastRadiusAssessment | None = None,
    ) -> RemediationAction:
        try:
            action_enum = ActionType(action_type)
        except ValueError:
            action_enum = ActionType.ESCALATE_TO_HUMAN
        risk = ACTION_RISKS.get(action_enum, ActionRisk.HIGH)
        blast = blast or self.calculate_blast_radius(incident)
        environment = _ENV_MAP.get(self.settings.environment, Environment.PROD)

        idempotency_key = (
            f"{incident.id}_{action_type}_{target_resource}_"
            f"{utcnow().strftime('%Y%m%d%H')}"
        )
        policy_result = self.policy.evaluate_remediation(
            action_type=action_type,
            environment=self.settings.app_env,
            blast_radius_score=blast.final_score,
            namespace=incident.namespace,
            affected_replicas=blast.affected_pods or 1,
        )
        requires_approval = policy_result.get("requires_approval", True)
        if environment == Environment.DEV and self.settings.remediation_auto_approve_dev:
            requires_approval = False

        return RemediationAction(
            incident_id=incident.id,
            idempotency_key=idempotency_key,
            action_type=action_enum,
            target_resource=target_resource,
            target_namespace=incident.namespace,
            target_cluster=incident.cluster,
            parameters=parameters or {},
            risk_level=risk,
            blast_radius_score=blast.final_score,
            affected_replicas=blast.affected_pods,
            environment=environment,
            status=(ActionStatus.PROPOSED if policy_result["allow"]
                    else ActionStatus.REJECTED),
            status_reason=policy_result.get("reason"),
            requires_approval=requires_approval,
            # graft-saga: the saga compensator can invert these classes
            # (scale → prior replicas, cordon → uncordon, rollback →
            # re-rollback); restart-class actions self-heal instead
            can_rollback=action_enum in (ActionType.SCALE_REPLICAS,
                                         ActionType.CORDON_NODE,
                                         ActionType.ROLLBACK_DEPLOYMENT),
        )
