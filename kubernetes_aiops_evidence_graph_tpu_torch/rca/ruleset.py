"""The diagnosis rule set — single source of truth for both RCA backends.

Semantics are the reference rules engine's (rules_engine.py:16-191 rules,
:359-410 matching, :412-424 confidence; hypothesis_ranker.py:28-61 ranking),
with the reference's latent defects fixed (SURVEY.md §3.6 items 5-6):

* every condition type has a checker — ``multiple_pods_same_node``,
  ``pod_not_ready``, ``readiness_probe_failing`` and ``network_errors_high``
  are real conditions here, so all 10 rules can fire;
* machine-executable actions are separated from prose guidance
  (``action`` vs ``manual_steps``), so the policy engine is never asked to
  evaluate "Check application logs…" as an action type.

Because every condition carries a fixed strength (rules_engine.py:380-410)
and a rule only scores when ALL its conditions hold (:371), each rule's
confidence and final ranking score are compile-time constants — precomputed
here once. The runtime work of RCA is therefore entirely in deciding the
per-incident condition vector, which is exactly what the TPU backend
batches over the evidence graph.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

from ..models import ActionType, HypothesisCategory


class Cond(IntEnum):
    """Condition vocabulary. Index = column in the condition matrix."""
    WAITING_CRASHLOOP = 0
    WAITING_IMAGE_PULL = 1          # ImagePullBackOff | ErrImagePull | ImageInspectError
    TERMINATED_OOM = 2
    TERMINATED_CONFIG = 3           # ContainerCannotRun | CreateContainerConfigError
    RECENT_DEPLOY = 4
    NO_RECENT_DEPLOY = 5
    MEMORY_USAGE_HIGH = 6
    HPA_AT_MAX = 7
    LATENCY_HIGH = 8
    LOG_PATTERN_NETWORK = 9         # network | connection | timeout categories
    NODE_UNHEALTHY = 10
    MULTIPLE_PODS_SAME_NODE = 11    # >= 2 problem pods on one node
    POD_NOT_READY = 12              # not ready >= 300s
    READINESS_PROBE_FAILING = 13
    NETWORK_ERRORS_HIGH = 14        # network error count >= 10


NUM_CONDS = len(Cond)

# Fixed per-condition evidence strengths (rules_engine.py:380-410; the four
# new conditions get strengths consistent with their nearest reference kin).
COND_STRENGTH: dict[Cond, float] = {
    Cond.WAITING_CRASHLOOP: 0.9,
    Cond.WAITING_IMAGE_PULL: 0.9,
    Cond.TERMINATED_OOM: 0.9,
    Cond.TERMINATED_CONFIG: 0.9,
    Cond.RECENT_DEPLOY: 0.8,
    Cond.NO_RECENT_DEPLOY: 0.6,
    Cond.MEMORY_USAGE_HIGH: 0.85,
    Cond.HPA_AT_MAX: 0.75,
    Cond.LATENCY_HIGH: 0.7,
    Cond.LOG_PATTERN_NETWORK: 0.65,
    Cond.NODE_UNHEALTHY: 0.8,
    Cond.MULTIPLE_PODS_SAME_NODE: 0.8,
    Cond.POD_NOT_READY: 0.7,
    Cond.READINESS_PROBE_FAILING: 0.75,
    Cond.NETWORK_ERRORS_HIGH: 0.7,
}

# Thresholds referenced by condition evaluators (shared by both backends).
MULTIPLE_PODS_THRESHOLD = 2
POD_NOT_READY_SECONDS = 300
NETWORK_ERRORS_THRESHOLD = 10
MEMORY_HIGH_PCT = 90            # rules_engine.py:341-344
RECENT_DEPLOY_WINDOW_MIN = 30   # deploy_diff_collector.py recency window
PROBLEM_POD_RESTARTS = 3        # kubernetes_collector.py:269-285 heuristic

# Category ranking weights (hypothesis_ranker.py:28-40).
CATEGORY_WEIGHT: dict[HypothesisCategory, float] = {
    HypothesisCategory.RESOURCE_EXHAUSTION: 1.2,
    HypothesisCategory.BAD_DEPLOYMENT: 1.15,
    HypothesisCategory.CONFIGURATION_ERROR: 1.1,
    HypothesisCategory.INFRASTRUCTURE_ISSUE: 1.05,
    HypothesisCategory.DEPENDENCY_FAILURE: 1.0,
    HypothesisCategory.NETWORK_ISSUE: 0.95,
    HypothesisCategory.SCALING_ISSUE: 0.9,
    HypothesisCategory.SECURITY_ISSUE: 0.85,
    HypothesisCategory.EXTERNAL_DEPENDENCY: 0.8,
    HypothesisCategory.DATA_ISSUE: 0.75,
    HypothesisCategory.UNKNOWN: 0.5,
}


@dataclass(frozen=True)
class Rule:
    id: str
    name: str
    conditions: tuple[Cond, ...]
    category: HypothesisCategory
    hypothesis: str
    description: str
    confidence_base: float
    action: ActionType | None           # machine-executable remediation
    manual_steps: tuple[str, ...] = field(default=())

    @property
    def evidence_strength(self) -> float:
        """Mean condition strength when fully matched (rules_engine.py:377)."""
        return sum(COND_STRENGTH[c] for c in self.conditions) / len(self.conditions)

    @property
    def confidence(self) -> float:
        """confidence = base*0.6 + strength*0.4, *1.1 if >2 conds, cap 0.99,
        round 3 (rules_engine.py:412-424)."""
        conf = self.confidence_base * 0.6 + self.evidence_strength * 0.4
        if len(self.conditions) > 2:
            conf = min(conf * 1.1, 0.99)
        return round(conf, 3)

    @property
    def final_score(self) -> float:
        """Ranker score (hypothesis_ranker.py:44-63): confidence × category
        weight × support boost × signal boost, round 4."""
        score = self.confidence * CATEGORY_WEIGHT[self.category]
        support = len(self.conditions)
        score *= 1 + min(support, 5) * 0.05
        score *= 1 + self.evidence_strength * 0.2
        return round(score, 4)

    @property
    def recommended_actions(self) -> list[str]:
        out = [self.action.value] if self.action else []
        out.extend(self.manual_steps)
        return out


RULES: tuple[Rule, ...] = (
    Rule(
        id="crashloop_recent_deploy",
        name="Bad Deployment - CrashLoop",
        conditions=(Cond.WAITING_CRASHLOOP, Cond.RECENT_DEPLOY),
        category=HypothesisCategory.BAD_DEPLOYMENT,
        hypothesis="Recent deployment caused application crash",
        description=(
            "The application started crash looping immediately after a "
            "deployment; the new code or configuration likely prevents startup."
        ),
        confidence_base=0.90,
        action=ActionType.ROLLBACK_DEPLOYMENT,
        manual_steps=(
            "Check application logs for startup errors",
            "Review recent code changes in the deployment",
        ),
    ),
    Rule(
        id="crashloop_no_change",
        name="Runtime Error - CrashLoop",
        conditions=(Cond.WAITING_CRASHLOOP, Cond.NO_RECENT_DEPLOY),
        category=HypothesisCategory.EXTERNAL_DEPENDENCY,
        hypothesis="Application crashing due to external dependency or data issue",
        description=(
            "Crash looping with no recent deployment points at external "
            "dependencies, database state, or corrupted data."
        ),
        confidence_base=0.75,
        action=ActionType.RESTART_POD,
        manual_steps=(
            "Check external service connectivity",
            "Verify database connections",
            "Review application logs for dependency errors",
        ),
    ),
    Rule(
        id="oom_killed",
        name="Memory Exhaustion",
        conditions=(Cond.TERMINATED_OOM,),
        category=HypothesisCategory.RESOURCE_EXHAUSTION,
        hypothesis="Container killed due to memory limit exceeded",
        description=(
            "The container exceeded its memory limit: a leak, undersized "
            "limits, or a sudden usage spike."
        ),
        confidence_base=0.95,
        action=ActionType.RESTART_DEPLOYMENT,
        manual_steps=(
            "Increase memory limits if appropriate",
            "Check for memory leaks in application",
            "Review memory usage patterns",
        ),
    ),
    Rule(
        id="oom_high_memory",
        name="Memory Pressure",
        conditions=(Cond.MEMORY_USAGE_HIGH,),
        category=HypothesisCategory.RESOURCE_EXHAUSTION,
        hypothesis="Container approaching memory limit",
        description=(
            "Memory usage above 90% of the limit; at risk of OOMKill. Limits "
            "may be too low or there is a leak."
        ),
        confidence_base=0.80,
        action=None,
        manual_steps=(
            "Increase memory limits",
            "Investigate memory usage patterns",
            "Check for memory leaks",
        ),
    ),
    Rule(
        id="image_pull_failure",
        name="Image Pull Error",
        conditions=(Cond.WAITING_IMAGE_PULL,),
        category=HypothesisCategory.CONFIGURATION_ERROR,
        hypothesis="Failed to pull container image",
        description=(
            "The image cannot be pulled: bad tag, registry auth, or network "
            "problems."
        ),
        confidence_base=0.95,
        action=None,
        manual_steps=(
            "Verify image tag exists in registry",
            "Check imagePullSecrets configuration",
            "Verify registry authentication",
            "Check network connectivity to registry",
        ),
    ),
    Rule(
        id="node_failure_isolated",
        name="Node-Specific Issue",
        conditions=(Cond.MULTIPLE_PODS_SAME_NODE, Cond.NODE_UNHEALTHY),
        category=HypothesisCategory.INFRASTRUCTURE_ISSUE,
        hypothesis="Failures isolated to problematic node",
        description=(
            "Multiple failing pods share one node that reports unhealthy "
            "conditions; node infrastructure is the likely root cause."
        ),
        confidence_base=0.85,
        action=ActionType.CORDON_NODE,
        manual_steps=(
            "Migrate pods to healthy nodes",
            "Investigate node health",
            "Check node resource usage",
        ),
    ),
    Rule(
        id="hpa_maxed",
        name="Scaling Limit Reached",
        conditions=(Cond.HPA_AT_MAX, Cond.LATENCY_HIGH),
        category=HypothesisCategory.SCALING_ISSUE,
        hypothesis="HPA at maximum capacity with high latency",
        description=(
            "The autoscaler is at max replicas but latency remains high; the "
            "service needs more capacity than configured."
        ),
        confidence_base=0.80,
        action=ActionType.SCALE_REPLICAS,
        manual_steps=(
            "Increase HPA max replicas",
            "Review resource requests/limits",
            "Consider adding nodes to cluster",
        ),
    ),
    Rule(
        id="readiness_probe_failing",
        name="Readiness Probe Failure",
        conditions=(Cond.POD_NOT_READY, Cond.READINESS_PROBE_FAILING),
        category=HypothesisCategory.DEPENDENCY_FAILURE,
        hypothesis="Pods failing readiness probe",
        description=(
            "Pods never become ready because the readiness probe fails — the "
            "app cannot serve traffic, usually a dependency issue."
        ),
        confidence_base=0.75,
        action=None,
        manual_steps=(
            "Check application health endpoints",
            "Verify database connections",
            "Check external service dependencies",
            "Review probe configuration",
        ),
    ),
    Rule(
        id="config_error",
        name="Configuration Error",
        conditions=(Cond.TERMINATED_CONFIG,),
        category=HypothesisCategory.CONFIGURATION_ERROR,
        hypothesis="Container configuration error",
        description=(
            "The container cannot run due to configuration: missing volumes, "
            "invalid env vars, or security context problems."
        ),
        confidence_base=0.90,
        action=None,
        manual_steps=(
            "Check ConfigMap and Secret references",
            "Verify volume mounts",
            "Review container security context",
            "Check environment variable configurations",
        ),
    ),
    Rule(
        id="network_error",
        name="Network Connectivity Issue",
        conditions=(Cond.LOG_PATTERN_NETWORK, Cond.NETWORK_ERRORS_HIGH),
        category=HypothesisCategory.NETWORK_ISSUE,
        hypothesis="Network connectivity problems",
        description=(
            "The application reports network connectivity errors: DNS, "
            "service mesh, or network policy restrictions."
        ),
        confidence_base=0.70,
        action=None,
        manual_steps=(
            "Check DNS resolution",
            "Verify network policies",
            "Check service mesh configuration",
            "Test connectivity to external services",
        ),
    ),
)

NUM_RULES = len(RULES)
RULE_INDEX = {r.id: i for i, r in enumerate(RULES)}

# Unknown fallback (rules_engine.py:426-447): confidence 0.3, unknown
# category; ranker: 0.3 * 0.5 * 1 * 1 = 0.15.
UNKNOWN_CONFIDENCE = 0.3
UNKNOWN_FINAL_SCORE = round(UNKNOWN_CONFIDENCE * CATEGORY_WEIGHT[HypothesisCategory.UNKNOWN], 4)
UNKNOWN_ACTIONS = (
    "Review application logs",
    "Check recent deployments",
    "Verify external dependencies",
    "Escalate to engineering team",
)
