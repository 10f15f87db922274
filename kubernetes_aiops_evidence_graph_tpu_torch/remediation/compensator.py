"""Saga compensation — roll a failed remediation's cluster effect back.

The reference workflow files a ticket when verification fails and walks
away, leaving the mutated cluster state standing (incident_workflow.py's
verify→create_ticket tail). graft-saga closes the loop: a FAILED
verification triggers a policy-gated, journaled compensation per action
type —

* ``scale_replicas``       → restore the pre-action replica count that
                             the executor captured at execute time
                             (``execution_result["prev_replicas"]``)
* ``cordon_node``          → uncordon
* ``rollback_deployment``  → re-rollback (the backend swap restores the
                             pre-action template)
* restart-class            → self-healing no-op (deleting a pod or
                             bouncing a deployment leaves nothing to
                             undo)

Compensation executes through the same two-phase RemediationExecutor
ledger (key = ``<original>:comp``), so a crash mid-compensation
reconciles instead of double-firing. Attempts are bounded
(settings.remediation_compensation_attempts); exhaustion — or a policy
denial — escalates to a human via an ``escalate_to_human`` action row.

The policy gate is PolicyEngine.evaluate_compensation: compensation
restores the pre-action state of an action the policy already allowed
and a human (or dev auto-approve) already approved, so the gate asks
whether the ORIGINAL action type is still env-allowlisted and the
namespace unprotected — not whether the inverse action (e.g. the
HIGH_RISK ``uncordon_node``) would be allowed as a fresh proposal.
"""
from __future__ import annotations

from typing import Any, Callable

from ..config import Settings, get_settings
from ..models import ActionStatus, ActionType, RemediationAction
from ..observability import get_logger
from ..observability import metrics as obs_metrics
from ..policy import PolicyEngine
from .executor import RESTART_CLASS, RemediationExecutor

log = get_logger("remediation.compensator")


class RemediationCompensator:
    def __init__(self, backend: Any, settings: Settings | None = None,
                 db: Any = None, policy: PolicyEngine | None = None,
                 fault_hook: "Callable[[str], None] | None" = None) -> None:
        self.backend = backend
        self.settings = settings or get_settings()
        self.db = db
        self.policy = policy or PolicyEngine()
        self.fault_hook = fault_hook

    def plan(self, action: RemediationAction) -> RemediationAction | None:
        """The inverse action, or None when the class self-heals."""
        if action.action_type in RESTART_CLASS:
            return None
        result = action.execution_result or {}
        inverse: ActionType | None = None
        params: dict[str, Any] = {}
        if action.action_type == ActionType.SCALE_REPLICAS:
            prev = result.get("prev_replicas")
            if prev is None:
                return None  # pre-ledger action rows carry no baseline
            inverse = ActionType.SCALE_REPLICAS
            params = {"replicas": int(prev)}
        elif action.action_type == ActionType.CORDON_NODE:
            inverse = ActionType.UNCORDON_NODE
        elif action.action_type == ActionType.ROLLBACK_DEPLOYMENT:
            inverse = ActionType.ROLLBACK_DEPLOYMENT
        if inverse is None:
            return None
        return RemediationAction(
            incident_id=action.incident_id,
            hypothesis_id=action.hypothesis_id,
            idempotency_key=f"{action.idempotency_key}:comp",
            action_type=inverse,
            target_resource=action.target_resource,
            target_namespace=action.target_namespace,
            target_cluster=action.target_cluster,
            parameters=params,
            risk_level=action.risk_level,
            blast_radius_score=action.blast_radius_score,
            environment=action.environment,
            status=ActionStatus.PROPOSED,
            status_reason=f"compensates {action.action_type.value}",
            requires_approval=False,  # covered by the original approval
            created_by="compensator",
        )

    def compensate(self, action: RemediationAction) -> dict:
        """Run the saga compensation for one executed-but-unverified
        action. Returns a journal-serializable outcome record."""
        at = action.action_type.value
        if action.action_type in RESTART_CLASS:
            obs_metrics.COMPENSATION_ACTIONS.inc(action_type=at,
                                                 outcome="noop")
            return {"compensated": False, "noop": True,
                    "reason": "restart-class actions self-heal"}
        gate = self.policy.evaluate_compensation(
            original_action_type=at,
            environment=self.settings.app_env,
            namespace=action.target_namespace)
        if not gate["allow"]:
            obs_metrics.COMPENSATION_ACTIONS.inc(action_type=at,
                                                 outcome="denied")
            self._escalate(action, f"compensation denied: {gate['reason']}")
            return {"compensated": False, "denied": True,
                    "reason": gate["reason"], "escalated": True}
        comp = self.plan(action)
        if comp is None:
            obs_metrics.COMPENSATION_ACTIONS.inc(action_type=at,
                                                 outcome="noop")
            self._escalate(action, "no compensation plan (missing baseline)")
            return {"compensated": False, "noop": True,
                    "reason": "no compensation plan", "escalated": True}
        attempts = max(int(getattr(self.settings,
                                   "remediation_compensation_attempts", 2)),
                       1)
        executor = RemediationExecutor(self.backend, self.settings,
                                       db=self.db,
                                       fault_hook=self.fault_hook)
        last_error = None
        for attempt in range(1, attempts + 1):
            if attempt > 1:
                # the ledger pinned the failed outcome under this key —
                # retry under an attempt-suffixed key (and a fresh row
                # id) so exactly-once holds per attempt, not per saga
                from uuid import uuid4
                comp.idempotency_key = (
                    f"{action.idempotency_key}:comp{attempt}")
                comp.id = uuid4()
            executed = executor.execute(comp)
            if self.db is not None:
                self.db.upsert_action(executed)
            if executed.status in (ActionStatus.COMPLETED,
                                   ActionStatus.SKIPPED):
                obs_metrics.COMPENSATION_ACTIONS.inc(action_type=at,
                                                     outcome="completed")
                action.status = ActionStatus.ROLLED_BACK
                action.status_reason = "compensated after failed verification"
                action.rollback_action_id = executed.id
                if self.db is not None:
                    self.db.upsert_action(action)
                    self.db.audit(str(action.incident_id),
                                  "action_compensated",
                                  {"action_type": at, "attempt": attempt,
                                   "compensation": comp.action_type.value})
                return {"compensated": True, "attempts": attempt,
                        "action_type": comp.action_type.value,
                        "result": executed.execution_result}
            last_error = executed.error_message
            log.warning("compensation_attempt_failed", attempt=attempt,
                        action_type=at, error=str(last_error))
        obs_metrics.COMPENSATION_ACTIONS.inc(action_type=at,
                                             outcome="failed")
        self._escalate(action,
                       f"compensation failed after {attempts} attempts: "
                       f"{last_error}")
        return {"compensated": False, "attempts": attempts,
                "error": last_error, "escalated": True}

    def _escalate(self, action: RemediationAction, reason: str) -> None:
        """Bounded attempts exhausted (or gate denied): leave a durable
        escalate_to_human action row + audit trail for the operator."""
        obs_metrics.COMPENSATION_ESCALATIONS.inc()
        log.error("compensation_escalated",
                  incident=str(action.incident_id), reason=reason)
        if self.db is None:
            return
        esc = RemediationAction(
            incident_id=action.incident_id,
            hypothesis_id=action.hypothesis_id,
            idempotency_key=f"{action.idempotency_key}:escalate",
            action_type=ActionType.ESCALATE_TO_HUMAN,
            target_resource=action.target_resource,
            target_namespace=action.target_namespace,
            status=ActionStatus.PENDING_APPROVAL,
            status_reason=reason,
            requires_approval=True,
            created_by="compensator",
        )
        self.db.upsert_action(esc)
        self.db.audit(str(action.incident_id), "compensation_escalated",
                      {"reason": reason,
                       "action_type": action.action_type.value})
