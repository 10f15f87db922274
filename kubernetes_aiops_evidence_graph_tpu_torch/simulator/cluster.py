"""FakeCluster — hermetic, replayable cluster backend.

The reference's only test story is live fault injection into a real
kind/minikube cluster (src/simulator/incident_simulator.py, SURVEY.md §4).
This FakeCluster replaces the K8s API + Loki + Prometheus trio with a
deterministic in-memory state machine that the collectors query through the
same backend interface they use against real endpoints — so the whole
pipeline runs hermetically at 200 → 50k pod scale (BASELINE.json configs).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime, timedelta
from typing import Optional

from ..utils.timeutils import utcnow


@dataclass
class PodState:
    name: str
    namespace: str
    deployment: str
    service: str
    node: str
    phase: str = "Running"
    ready: bool = True
    restart_count: int = 0
    waiting_reason: Optional[str] = None
    terminated_reason: Optional[str] = None
    not_ready_seconds: float = 0.0
    readiness_probe_failing: bool = False
    started_at: Optional[datetime] = None       # status.startTime
    creation_ts: Optional[datetime] = None      # metadata.creationTimestamp
    # review-surface detail (reference kubernetes_collector.py:194-267):
    # populated from the wire by the live backend; None on the fake
    # cluster, where the collector synthesizes a one-container view from
    # the scalars above (pod_detail in collectors/kubernetes.py)
    conditions: Optional[list] = None          # [{type, status, reason}]
    container_statuses: Optional[list] = None  # per-container state detail
    resources: Optional[dict] = None           # {container: {requests, limits}}
    labels: Optional[dict] = None


@dataclass
class DeploymentState:
    name: str
    namespace: str
    service: str
    replicas: int = 3
    ready_replicas: int = 3
    revision: int = 1
    image: str = "registry.local/app:v1"
    prev_image: Optional[str] = None
    changed_at: Optional[datetime] = None


@dataclass
class NodeState:
    name: str
    # condition -> "True"/"False"; Ready defaults True, pressures default False
    conditions: dict[str, str] = field(default_factory=lambda: {"Ready": "True"})


@dataclass
class ServiceState:
    name: str
    namespace: str
    deployment: str
    calls: list[str] = field(default_factory=list)  # downstream service names


@dataclass
class HPAState:
    name: str
    namespace: str
    deployment: str
    min_replicas: int = 1
    max_replicas: int = 10
    current_replicas: int = 3
    at_max: bool = False


@dataclass
class ConfigMapState:
    name: str
    namespace: str
    changed_at: Optional[datetime] = None
    mounted_by: list[str] = field(default_factory=list)  # deployment names


@dataclass
class EventState:
    namespace: str
    involved_object: str
    reason: str
    type: str = "Warning"
    message: str = ""
    timestamp: Optional[datetime] = None


@dataclass
class ServiceMetrics:
    memory_pct: float = 55.0
    error_rate: float = 0.001
    p99_latency_s: float = 0.12
    cpu_throttle_ratio: float = 0.02
    oom_events: float = 0.0
    restarts_rate: float = 0.0
    hpa_at_max: float = 0.0  # 0/1 gauge
    # optional per-query time series [(epoch_s, value), ...]; when present
    # query_metric_range serves it verbatim (trend/spike scenarios), else a
    # flat series is synthesized from the instant value above
    series: dict[str, list[tuple[float, float]]] = field(default_factory=dict)


class FakeCluster:
    """In-memory cluster implementing the ClusterBackend query surface."""

    def __init__(self, seed: int = 0) -> None:
        self.seed = seed
        self.pods: dict[str, PodState] = {}
        self.deployments: dict[str, DeploymentState] = {}
        self.nodes: dict[str, NodeState] = {}
        self.services: dict[str, ServiceState] = {}
        self.hpas: dict[str, HPAState] = {}
        self.configmaps: dict[str, ConfigMapState] = {}
        self.events: list[EventState] = []
        self.pod_logs: dict[str, list[str]] = {}
        self.metrics: dict[str, ServiceMetrics] = {}
        self.now: datetime = utcnow()
        self._pod_index: dict[tuple[str, str], list[PodState]] | None = None
        self._pod_index_size: int = -1

    # -- keys -------------------------------------------------------------

    @staticmethod
    def _key(namespace: str, name: str) -> str:
        return f"{namespace}/{name}"

    # -- ClusterBackend query surface (used by collectors) ----------------

    def invalidate_index(self) -> None:
        """Drop the service index. Adds/removes are auto-detected by size;
        call this only when *replacing* a pod under the same key."""
        self._pod_index = None

    def add_pod(self, pod: PodState) -> None:
        """Insert a pod keeping the service index incremental — a churn
        stream at 1k events/s must not pay an O(pods) index rebuild per
        create (the rebuild dominated the streaming bench host loop)."""
        import bisect
        key = self._key(pod.namespace, pod.name)
        old = self.pods.get(key)
        if old is not None:
            # replacement under the same key: evict the stale object from
            # its index list first, or it would keep serving dead state
            self.remove_pod(pod.namespace, pod.name)
        self.pods[key] = pod
        if self._pod_index is not None:
            lst = self._pod_index.setdefault((pod.namespace, pod.service), [])
            bisect.insort(lst, pod, key=lambda p: p.name)
            self._pod_index_size += 1

    def remove_pod(self, namespace: str, name: str):
        """Remove a pod, updating the service index in place."""
        p = self.pods.pop(self._key(namespace, name), None)
        if p is not None and self._pod_index is not None:
            lst = self._pod_index.get((p.namespace, p.service))
            if lst is None:
                self._pod_index = None   # index diverged; full rebuild
            else:
                try:
                    lst.remove(p)       # identity-equal object reference
                    self._pod_index_size -= 1
                except ValueError:
                    self._pod_index = None   # replaced object; full rebuild
        return p

    def _pods_by_service(self) -> dict[tuple[str, str], list[PodState]]:
        # auto-invalidate when pods were added/removed (size change); scenario
        # code mutates existing PodState objects in place, which needs no
        # invalidation because the index holds object references
        if self._pod_index is None or self._pod_index_size != len(self.pods):
            idx: dict[tuple[str, str], list[PodState]] = {}
            for p in self.pods.values():
                idx.setdefault((p.namespace, p.service), []).append(p)
            for lst in idx.values():
                lst.sort(key=lambda p: p.name)
            self._pod_index = idx
            self._pod_index_size = len(self.pods)
        return self._pod_index

    def list_pods(self, namespace: str, service: str | None = None) -> list[PodState]:
        if service is not None:
            return list(self._pods_by_service().get((namespace, service), ()))
        out = [p for p in self.pods.values() if p.namespace == namespace]
        return sorted(out, key=lambda p: p.name)

    def list_deployments(self, namespace: str, service: str | None = None) -> list[DeploymentState]:
        out = [
            d for d in self.deployments.values()
            if d.namespace == namespace and (service is None or d.service == service)
        ]
        return sorted(out, key=lambda d: d.name)

    def list_nodes(self) -> list[NodeState]:
        return sorted(self.nodes.values(), key=lambda n: n.name)

    def list_hpas(self, namespace: str, service: str | None = None) -> list[HPAState]:
        out = [
            h for h in self.hpas.values()
            if h.namespace == namespace
            and (service is None or self.deployments.get(self._key(namespace, h.deployment),
                                                         DeploymentState("", "", "")).service == service)
        ]
        return sorted(out, key=lambda h: h.name)

    def list_configmaps(self, namespace: str) -> list[ConfigMapState]:
        return sorted(
            (c for c in self.configmaps.values() if c.namespace == namespace),
            key=lambda c: c.name,
        )

    def list_events(self, namespace: str, since: datetime) -> list[EventState]:
        return [
            e for e in self.events
            if e.namespace == namespace and e.timestamp is not None and e.timestamp >= since
        ]

    def query_logs(self, namespace: str, service: str, limit: int = 1000) -> list[str]:
        """Loki query_range analog: newest-first lines for a service's pods
        (logs_collector.py:80-116)."""
        lines: list[str] = []
        for p in self.list_pods(namespace, service):
            lines.extend(self.pod_logs.get(self._key(namespace, p.name), ()))
        return lines[-limit:][::-1]

    def query_metric(self, namespace: str, service: str, query_name: str) -> float | None:
        """Prometheus instant-value analog, keyed by query name."""
        m = self.metrics.get(self._key(namespace, service))
        if m is None:
            return None
        series = m.series.get(query_name)
        if series:
            return series[-1][1]
        table = {
            "memory_usage_pct": m.memory_pct,
            "error_rate": m.error_rate,
            "latency_p99_seconds": m.p99_latency_s,
            "cpu_throttle_ratio": m.cpu_throttle_ratio,
            "oom_events": m.oom_events,
            "pod_restarts": m.restarts_rate,
            "hpa_at_max": m.hpa_at_max,
        }
        return table.get(query_name)

    def query_metric_range(self, namespace: str, service: str,
                           query_name: str, start_s: float,
                           end_s: float) -> list[tuple[float, float]]:
        """Prometheus query_range analog (metrics_collector.py:161-185):
        serves the scenario-set series clipped to the window, else a
        deterministic flat series synthesized from the instant value — so
        the hermetic path exercises the same series-stats code as live."""
        m = self.metrics.get(self._key(namespace, service))
        if m is None:
            return []
        series = m.series.get(query_name)
        if series:
            return [(t, v) for t, v in series if start_s <= t <= end_s]
        value = self.query_metric(namespace, service, query_name)
        if value is None or end_s <= start_s:
            return []
        step = max(15.0, (end_s - start_s) / 100.0)
        n = max(2, int((end_s - start_s) / step))
        return [(start_s + i * (end_s - start_s) / (n - 1), float(value))
                for i in range(n)]

    def set_metric_series(self, namespace: str, service: str,
                          query_name: str, values: list[float],
                          window_s: float = 900.0) -> None:
        """Spread ``values`` evenly over the trailing ``window_s`` seconds
        ending at cluster ``now`` — scenario/test helper for trend series."""
        from ..utils.timeutils import to_epoch_s
        end = to_epoch_s(self.now)
        n = len(values)
        ts = [end - window_s + (i + 1) * window_s / n for i in range(n)]
        self.service_metrics(namespace, service).series[query_name] = (
            list(zip(ts, values)))

    def rollout_history(self, namespace: str, deployment: str) -> list[dict]:
        d = self.deployments.get(self._key(namespace, deployment))
        if d is None:
            return []
        hist = [{
            "revision": d.revision,
            "image": d.image,
            "changed_at": d.changed_at,
        }]
        if d.prev_image is not None:
            hist.append({
                "revision": d.revision - 1,
                "image": d.prev_image,
                "changed_at": None,
            })
        return hist

    # -- mutation helpers used by scenarios/stream ------------------------

    def add_event(self, namespace: str, obj: str, reason: str, message: str = "") -> None:
        self.events.append(EventState(
            namespace=namespace, involved_object=obj, reason=reason,
            message=message, timestamp=self.now,
        ))

    def set_logs(self, namespace: str, pod: str, lines: list[str]) -> None:
        self.pod_logs[self._key(namespace, pod)] = lines

    def service_metrics(self, namespace: str, service: str) -> ServiceMetrics:
        return self.metrics.setdefault(self._key(namespace, service), ServiceMetrics())

    def advance(self, seconds: float) -> None:
        self.now = self.now + timedelta(seconds=seconds)

    # -- ClusterAdminBackend: remediation actions -------------------------
    # These model how real K8s reacts to the corresponding executor verbs;
    # a restarted/rolled-back pod comes back healthy unless the underlying
    # fault is environmental, so the verifier sees genuine improvement.

    def _node_healthy(self, name: str) -> bool:
        node = self.nodes.get(name)
        if node is None:
            return True
        if node.conditions.get("Ready", "True") != "True":
            return False
        return not any(
            node.conditions.get(c) == "True"
            for c in ("MemoryPressure", "DiskPressure", "PIDPressure",
                      "NetworkUnavailable"))

    def _heal_pod(self, p: PodState) -> None:
        """Restart outcome: healthy unless the fault is environmental — a pod
        rescheduled onto a sick node stays not-ready."""
        p.waiting_reason = None
        p.terminated_reason = None
        p.restart_count = 0
        p.readiness_probe_failing = False
        p.started_at = self.now
        if self._node_healthy(p.node):
            p.phase = "Running"
            p.ready = True
            p.not_ready_seconds = 0.0
        else:
            p.phase = "Pending"
            p.ready = False

    def _recompute_ready(self, namespace: str, deployment: str) -> None:
        d = self.deployments.get(self._key(namespace, deployment))
        if d is not None:
            d.ready_replicas = sum(
                1 for p in self.list_pods(namespace, d.service)
                if p.deployment == deployment and p.ready)

    def _heal_service_metrics(self, namespace: str, service: str) -> None:
        key = self._key(namespace, service)
        if key in self.metrics:  # reset existing gauges, don't invent new ones
            self.metrics[key] = ServiceMetrics()
        for p in self.list_pods(namespace, service):
            self.pod_logs.pop(self._key(namespace, p.name), None)

    def delete_pod(self, namespace: str, name: str) -> bool:
        """Delete → controller recreates it (executor.py:86-134 analog)."""
        key = self._key(namespace, name)
        p = self.pods.get(key)
        if p is None:
            return False
        self._heal_pod(p)
        self._recompute_ready(namespace, p.deployment)
        return True

    def restart_deployment(self, namespace: str, deployment: str) -> bool:
        key = self._key(namespace, deployment)
        d = self.deployments.get(key)
        if d is None:
            return False
        for p in self.list_pods(namespace, d.service):
            if p.deployment == deployment:
                self._heal_pod(p)
        self._recompute_ready(namespace, deployment)
        self._heal_service_metrics(namespace, d.service)
        return True

    def rollback_deployment(self, namespace: str, deployment: str) -> bool:
        """Restore previous template (executor.py:177-234 analog)."""
        key = self._key(namespace, deployment)
        d = self.deployments.get(key)
        if d is None or d.prev_image is None:
            return False
        d.image, d.prev_image = d.prev_image, d.image
        d.revision += 1
        d.changed_at = self.now
        return self.restart_deployment(namespace, deployment)

    def _schedulable_node(self, preferred: str | None = None) -> str:
        """Pick a target node honoring cordons (Unschedulable)."""
        if preferred is not None:
            node = self.nodes.get(preferred)
            if node is not None and node.conditions.get("Unschedulable") != "True":
                return preferred
        for name in sorted(self.nodes):
            if self.nodes[name].conditions.get("Unschedulable") != "True":
                return name
        return preferred or "node-0"

    def scale_deployment(self, namespace: str, deployment: str, replicas: int) -> bool:
        key = self._key(namespace, deployment)
        d = self.deployments.get(key)
        if d is None:
            return False
        pods = [p for p in self.list_pods(namespace, d.service)
                if p.deployment == deployment]
        if replicas < len(pods):  # scale down removes pods
            for p in pods[replicas:]:
                del self.pods[self._key(namespace, p.name)]
        else:
            template = pods[0] if pods else None
            existing = {p.name for p in pods}
            i = 0
            while len(existing) < replicas:
                name = f"{deployment}-scaled-{i}"
                i += 1
                if name in existing:
                    continue
                existing.add(name)
                self.pods[self._key(namespace, name)] = PodState(
                    name=name, namespace=namespace, deployment=deployment,
                    service=d.service,
                    node=self._schedulable_node(template.node if template else None),
                    started_at=self.now)
        d.replicas = replicas
        self.invalidate_index()
        self._recompute_ready(namespace, deployment)
        return True

    def cordon_node(self, name: str) -> bool:
        """Mark unschedulable; surfaced by the kubernetes collector and
        honored by _schedulable_node for future placements."""
        node = self.nodes.get(name)
        if node is None:
            return False
        node.conditions["Unschedulable"] = "True"
        return True

    def uncordon_node(self, name: str) -> bool:
        """Clear the cordon (graft-saga compensation inverse)."""
        node = self.nodes.get(name)
        if node is None:
            return False
        node.conditions.pop("Unschedulable", None)
        return True
