"""In-process remediation policy engine.

Evaluates the exact semantics of the reference's Rego policy
(src/services/policy/policies/remediation.rego:1-167) without an external
OPA server: per-environment action allowlists (:27-49), a high-risk set
that is never auto-allowed (:52-59), freeze windows — 22:00-06:00 local,
prod weekends, explicit flag (:62-80) — blast-radius thresholds with dev
exemption and the staging <75 carve-out (:83-95), protected namespaces with
dev exemption (:98-113), the conjunctive allow rule (:116-121), the
requires-approval rules (:124-143), and the denial reasons (:146-166).

Unlike the reference's OPA client (opa_client.py:79-87) there is no network
call to fail — but evaluation errors still fail closed.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime

from ..utils.timeutils import utcnow

ALLOWED_ACTIONS = {
    "dev": {"restart_pod", "delete_pod", "restart_deployment",
            "rollback_deployment", "scale_replicas", "cordon_node"},
    "staging": {"restart_pod", "delete_pod", "restart_deployment",
                "scale_replicas", "rollback_deployment"},
    "prod": {"restart_pod", "delete_pod", "restart_deployment", "scale_replicas"},
}

HIGH_RISK_ACTIONS = {
    "drain_node", "delete_pvc", "update_resource_limits",
    "delete_namespace", "update_configmap", "uncordon_node",
}

PROTECTED_NAMESPACES = {
    "kube-system", "kube-public", "kube-node-lease",
    "istio-system", "cert-manager", "monitoring",
}


@dataclass(frozen=True)
class PolicyInput:
    """Mirror of the OPA input document (opa_client.py:42-53)."""
    action_type: str
    environment: str            # dev|staging|uat|prod
    blast_radius_score: float
    namespace: str
    affected_replicas: int = 1
    current_hour: int | None = None
    is_weekend: bool | None = None
    freeze_active: bool = False
    now: datetime | None = None

    def resolved_hour(self) -> int:
        if self.current_hour is not None:
            return self.current_hour
        return (self.now or utcnow()).hour

    def resolved_weekend(self) -> bool:
        if self.is_weekend is not None:
            return self.is_weekend
        return (self.now or utcnow()).weekday() >= 5


@dataclass
class PolicyResult:
    allow: bool
    requires_approval: bool
    deny_reasons: list[str] = field(default_factory=list)

    @property
    def reason(self) -> str | None:
        return "; ".join(self.deny_reasons) if self.deny_reasons else None


def in_freeze_window(p: PolicyInput) -> bool:
    hour = p.resolved_hour()
    if hour >= 22 or hour < 6:            # late-night freeze (:62-69)
        return True
    if p.environment == "prod" and p.resolved_weekend():  # :71-75
        return True
    return p.freeze_active                # :77-80


def env_allows_action(p: PolicyInput) -> bool:
    allowed = ALLOWED_ACTIONS.get(p.environment)
    if allowed is None:                   # uat & unknown envs have no allowlist
        return False
    if p.action_type not in allowed:
        return False
    if p.environment in ("staging", "prod") and in_freeze_window(p):
        return False                      # dev is exempt from freezes (:9-12)
    return True


def blast_radius_ok(p: PolicyInput) -> bool:
    if p.environment == "dev":            # :88-90
        return True
    if p.environment == "staging" and p.blast_radius_score < 75:  # :92-95
        return True
    return p.blast_radius_score < 50 and p.affected_replicas < 5  # :83-86


def namespace_allowed(p: PolicyInput) -> bool:
    if p.environment == "dev":            # :102-104
        return True
    return p.namespace not in PROTECTED_NAMESPACES


def requires_approval(p: PolicyInput) -> bool:
    return (
        p.environment == "prod"                                   # :124-126
        or (p.environment == "staging" and p.blast_radius_score >= 30)  # :128-131
        or p.action_type == "rollback_deployment"                 # :133-135
        or p.action_type == "cordon_node"                         # :137-139
        or p.affected_replicas >= 3                               # :141-143
    )


def evaluate(p: PolicyInput) -> PolicyResult:
    try:
        env_ok = env_allows_action(p)
        allow = (
            env_ok
            and blast_radius_ok(p)
            and namespace_allowed(p)
            and p.action_type not in HIGH_RISK_ACTIONS
        )
        reasons: list[str] = []
        if not env_ok:
            # every env-level deny carries its own cause, independent of
            # whether namespace/blast checks below also fail — the reference
            # Rego leaves a plain allowlist miss (e.g. cordon_node in prod
            # outside a freeze) reasonless (remediation.rego:146-166 has no
            # rule for it); that is a gap we fix rather than replicate
            env_explained = False
            if p.action_type in HIGH_RISK_ACTIONS:
                reasons.append(
                    f"Action {p.action_type} is high risk and not allowed")
                env_explained = True
            if p.environment in ("staging", "prod") and in_freeze_window(p):
                reasons.append("Action not allowed during freeze window")
                env_explained = True
            if not env_explained:
                if ALLOWED_ACTIONS.get(p.environment) is None:
                    reasons.append(
                        f"Environment {p.environment} has no action allowlist")
                else:
                    reasons.append(
                        f"Action {p.action_type} is not in the"
                        f" {p.environment} allowlist")
        if not namespace_allowed(p):
            reasons.append(f"Namespace {p.namespace} is protected")
        if not blast_radius_ok(p):
            reasons.append(
                f"Blast radius score {p.blast_radius_score} exceeds threshold")
        return PolicyResult(
            allow=allow,
            requires_approval=requires_approval(p),
            deny_reasons=reasons,
        )
    except Exception as exc:  # graft-audit: allow[broad-except] fail closed (opa_client.py:79-87): any evaluation error denies
        return PolicyResult(
            allow=False, requires_approval=True,
            deny_reasons=[f"policy evaluation error: {exc}"])


class PolicyEngine:
    """Object facade matching the reference OPAClient call shape
    (opa_client.py:23-53)."""

    def evaluate_remediation(
        self,
        action_type: str,
        environment: str,
        blast_radius_score: float,
        namespace: str,
        affected_replicas: int = 1,
        freeze_active: bool = False,
        now: datetime | None = None,
    ) -> dict:
        env = {"development": "dev", "production": "prod"}.get(
            environment.lower(), environment.lower())
        result = evaluate(PolicyInput(
            action_type=action_type, environment=env,
            blast_radius_score=blast_radius_score, namespace=namespace,
            affected_replicas=affected_replicas, freeze_active=freeze_active,
            now=now,
        ))
        return {
            "allow": result.allow,
            "requires_approval": result.requires_approval,
            "reason": result.reason,
        }

    def evaluate_compensation(
        self,
        original_action_type: str,
        environment: str,
        namespace: str,
    ) -> dict:
        """graft-saga compensation gate. Compensation RESTORES the
        pre-action state of an action this engine already allowed and an
        approver already signed off on, so the question is not "would the
        inverse action pass as a fresh proposal" (uncordon_node is
        HIGH_RISK and never would) but "is the original action class
        still within this environment's remit". Freeze windows are
        deliberately NOT applied: leaving a failed remediation's mutation
        standing through a freeze is worse than undoing it."""
        env = {"development": "dev", "production": "prod"}.get(
            environment.lower(), environment.lower())
        allowed_set = ALLOWED_ACTIONS.get(env)
        reasons: list[str] = []
        if allowed_set is None:
            reasons.append(f"Environment {env} has no action allowlist")
        elif original_action_type not in allowed_set:
            reasons.append(f"Action {original_action_type} is not in the"
                           f" {env} allowlist")
        if env != "dev" and namespace in PROTECTED_NAMESPACES:
            reasons.append(f"Namespace {namespace} is protected")
        return {
            "allow": not reasons,
            "requires_approval": False,  # covered by the original approval
            "reason": "; ".join(reasons) if reasons else None,
        }
