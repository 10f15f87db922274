"""Fault-injection scenarios.

The reference ships 4 live-cluster scenarios (incident_simulator.py:15-171:
crashloop, oom, imagepull, slowapp). Here each scenario is a deterministic
mutation of FakeCluster state, and the set is widened to 10 so every
diagnosis rule in the shared ruleset has at least one scenario that should
make it the top-1 hypothesis — the ground truth for RCA accuracy.
"""
from __future__ import annotations

from dataclasses import dataclass
from datetime import timedelta
from typing import Callable

import numpy as np

from ..models import Incident, IncidentSource, Severity
from ..utils.hashing import alert_fingerprint
from .cluster import FakeCluster

_ERROR_LINE = "ERROR worker crashed: exit status 1"
_NETWORK_LINES = [
    "ERROR dial tcp 10.0.0.7:5432: connection refused",
    "WARN upstream request timeout after 5s",
    "ERROR read tcp: connection reset by peer",
]


@dataclass(frozen=True)
class Scenario:
    name: str
    alertname: str
    severity: Severity
    expected_rule: str            # ground-truth top-1 rule id
    apply: Callable[[FakeCluster, str, np.random.Generator], None]
    description: str = ""


def _pods(cluster: FakeCluster, target: str):
    ns, dname = target.split("/", 1)
    return ns, dname, cluster.list_pods(ns, dname)


def _burst_logs(cluster: FakeCluster, ns: str, pods, lines: list[str], repeat: int = 8):
    for p in pods:
        cluster.set_logs(ns, p.name, lines * repeat)


def _apply_crashloop_deploy(cluster: FakeCluster, target: str, rng) -> None:
    ns, dname, pods = _pods(cluster, target)
    d = cluster.deployments[target]
    d.revision += 1
    d.prev_image = d.image
    d.image = d.image.rsplit(":", 1)[0] + f":v{d.revision}"
    d.changed_at = cluster.now - timedelta(minutes=10)
    d.ready_replicas = 0
    for p in pods:
        p.phase = "Running"
        p.ready = False
        p.waiting_reason = "CrashLoopBackOff"
        p.restart_count = int(rng.integers(4, 12))
        cluster.add_event(ns, p.name, "BackOff", "Back-off restarting failed container")
    _burst_logs(cluster, ns, pods, [_ERROR_LINE, "CRITICAL panic: nil config"])


def _apply_crashloop(cluster: FakeCluster, target: str, rng) -> None:
    ns, dname, pods = _pods(cluster, target)
    cluster.deployments[target].ready_replicas = 0
    for p in pods:
        p.ready = False
        p.waiting_reason = "CrashLoopBackOff"
        p.restart_count = int(rng.integers(4, 12))
        cluster.add_event(ns, p.name, "BackOff", "Back-off restarting failed container")
    _burst_logs(cluster, ns, pods, [_ERROR_LINE])


def _apply_oom(cluster: FakeCluster, target: str, rng) -> None:
    ns, dname, pods = _pods(cluster, target)
    for p in pods:
        p.terminated_reason = "OOMKilled"
        p.restart_count = int(rng.integers(2, 8))
        cluster.add_event(ns, p.name, "OOMKilling", "Memory cgroup out of memory")
    m = cluster.service_metrics(ns, dname)
    m.memory_pct = 99.0
    m.oom_events = float(len(pods))
    _burst_logs(cluster, ns, pods, ["CRITICAL out of memory", _ERROR_LINE])


def _apply_oom_pressure(cluster: FakeCluster, target: str, rng) -> None:
    ns, dname, _ = _pods(cluster, target)
    m = cluster.service_metrics(ns, dname)
    m.memory_pct = 94.0


def _apply_imagepull(cluster: FakeCluster, target: str, rng) -> None:
    ns, dname, pods = _pods(cluster, target)
    d = cluster.deployments[target]
    d.ready_replicas = 0
    for p in pods:
        p.phase = "Pending"
        p.ready = False
        p.waiting_reason = "ImagePullBackOff"
        cluster.add_event(ns, p.name, "Failed", "Failed to pull image")


def _apply_node_pressure(cluster: FakeCluster, target: str, rng) -> None:
    ns, dname, pods = _pods(cluster, target)
    if not pods:
        return
    node_name = pods[0].node
    node = cluster.nodes[node_name]
    node.conditions["Ready"] = "False"
    node.conditions["MemoryPressure"] = "True"
    # co-locate the target's pods on the sick node: >= 2 problem pods there,
    # with not_ready below the 300s probe-rule threshold so only the node
    # rule fires
    for p in pods:
        p.node = node_name
        p.ready = False
        p.not_ready_seconds = 120.0
        p.restart_count = int(rng.integers(4, 9))
        cluster.add_event(ns, p.name, "NodeNotReady", "Node is not ready")


def _apply_hpa_maxed(cluster: FakeCluster, target: str, rng) -> None:
    ns, dname, pods = _pods(cluster, target)
    hpa = cluster.hpas.get(target)
    if hpa is None:
        from .cluster import HPAState
        hpa = cluster.hpas[target] = HPAState(name=dname, namespace=ns, deployment=dname)
    hpa.current_replicas = hpa.max_replicas
    hpa.at_max = True
    m = cluster.service_metrics(ns, dname)
    m.p99_latency_s = 4.2
    m.hpa_at_max = 1.0


def _apply_probe_failure(cluster: FakeCluster, target: str, rng) -> None:
    ns, dname, pods = _pods(cluster, target)
    cluster.deployments[target].ready_replicas = 0
    for p in pods:
        p.ready = False
        p.not_ready_seconds = 600.0
        p.readiness_probe_failing = True
        cluster.add_event(ns, p.name, "Unhealthy", "Readiness probe failed: HTTP 503")


def _apply_config_error(cluster: FakeCluster, target: str, rng) -> None:
    ns, dname, pods = _pods(cluster, target)
    cmap_key = f"{ns}/{dname}-config"
    if cmap_key not in cluster.configmaps:
        from .cluster import ConfigMapState
        cluster.configmaps[cmap_key] = ConfigMapState(name=f"{dname}-config", namespace=ns,
                                                      mounted_by=[dname])
    cluster.configmaps[cmap_key].changed_at = cluster.now - timedelta(minutes=5)
    for p in pods:
        p.ready = False
        p.terminated_reason = "CreateContainerConfigError"
        cluster.add_event(ns, p.name, "Failed", "Error: configmap key not found")


def _apply_network(cluster: FakeCluster, target: str, rng) -> None:
    ns, dname, pods = _pods(cluster, target)
    m = cluster.service_metrics(ns, dname)
    m.error_rate = 0.31
    _burst_logs(cluster, ns, pods, _NETWORK_LINES, repeat=10)


SCENARIOS: dict[str, Scenario] = {
    s.name: s for s in (
        Scenario("crashloop_deploy", "PodCrashLooping", Severity.CRITICAL,
                 "crashloop_recent_deploy", _apply_crashloop_deploy,
                 "crashloop right after a rollout (reference crashloop + deploy-diff)"),
        Scenario("crashloop", "PodCrashLooping", Severity.CRITICAL,
                 "crashloop_no_change", _apply_crashloop,
                 "crashloop with no recent change (reference crashloop scenario)"),
        Scenario("oom", "ContainerOOMKilled", Severity.CRITICAL,
                 "oom_killed", _apply_oom,
                 "container OOMKilled (reference oom scenario)"),
        Scenario("oom_pressure", "HighMemory", Severity.HIGH,
                 "oom_high_memory", _apply_oom_pressure,
                 "memory >90% of limit, no kill yet"),
        Scenario("imagepull", "PodImagePullBackOff", Severity.HIGH,
                 "image_pull_failure", _apply_imagepull,
                 "unpullable image (reference imagepull scenario)"),
        Scenario("node_pressure", "NodeNotReady", Severity.CRITICAL,
                 "node_failure_isolated", _apply_node_pressure,
                 "unhealthy node taking down co-located pods"),
        Scenario("hpa_maxed", "HPAAtMax", Severity.HIGH,
                 "hpa_maxed", _apply_hpa_maxed,
                 "autoscaler pegged at max with high latency (reference slowapp analog)"),
        Scenario("probe_failure", "PodNotReady", Severity.HIGH,
                 "readiness_probe_failing", _apply_probe_failure,
                 "pods failing readiness probes"),
        Scenario("config_error", "PodCrashLooping", Severity.HIGH,
                 "config_error", _apply_config_error,
                 "bad configmap reference"),
        Scenario("network", "HighErrorRate", Severity.HIGH,
                 "network_error", _apply_network,
                 "connection refused/timeout storm (reference slowapp analog)"),
    )
}


def inject(
    cluster: FakeCluster,
    scenario_name: str,
    target: str,
    rng: np.random.Generator | None = None,
) -> Incident:
    """Apply a scenario to a target "namespace/deployment" and return the
    incident an alert webhook would have created for it."""
    scenario = SCENARIOS[scenario_name]
    rng = rng or np.random.default_rng(cluster.seed)
    scenario.apply(cluster, target, rng)
    ns, dname = target.split("/", 1)
    fp = alert_fingerprint("alertmanager", scenario.alertname, ns, dname)
    return Incident(
        fingerprint=fp,
        title=f"{scenario.alertname}: {dname}",
        description=scenario.description,
        severity=scenario.severity,
        source=IncidentSource.ALERTMANAGER,
        cluster="sim",
        namespace=ns,
        service=dname,
        labels={"alertname": scenario.alertname, "namespace": ns, "service": dname,
                "scenario": scenario.name},
        started_at=cluster.now,
    )
