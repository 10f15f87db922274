"""Live cluster backend — the collectors' real-endpoint implementation.

The same ClusterBackend protocol the FakeCluster serves hermetically
(simulator/cluster.py), implemented against a real Kubernetes API server,
Prometheus, and Loki — the trio the reference collectors speak to directly
(kubernetes_collector.py via the kubernetes client; logs_collector.py:80-110
Loki query_range; metrics_collector.py:161-185 Prometheus query_range).

Keeping the seam at the backend (not the collector) means every collector,
the rules engines, and the whole workflow run identically against fake and
live clusters; only this file touches the network. stdlib-only HTTP (this
image has no guaranteed httpx/kubernetes client, and the ingestion edge is
not the hot path).

Auth follows the in-cluster convention: service-account bearer token +
cluster CA from /var/run/secrets/kubernetes.io/serviceaccount, overridable
for out-of-cluster use.

The port's copy of the JAX package's live backend: the same requests,
the same mapping onto the simulator's state dataclasses, stdlib only
(``http.client``, ``urllib``, ``ssl``). ``app.main()`` builds it for
``cluster_backend="kubernetes"``.
"""
from __future__ import annotations

import http.client
import json
import ssl
import urllib.error
import urllib.parse
import urllib.request
from datetime import datetime
from pathlib import Path
from typing import Any, Optional

from ..config import Settings, get_settings
from ..utils.timeutils import parse_iso, utcnow
from ..simulator.cluster import (
    ConfigMapState,
    DeploymentState,
    EventState,
    HPAState,
    NodeState,
    PodState,
)

_SA_DIR = Path("/var/run/secrets/kubernetes.io/serviceaccount")


def _pod_prefix(service: str) -> str:
    return service


class LiveClusterBackend:
    """ClusterBackend over real K8s API + Prometheus + Loki HTTP."""

    def __init__(
        self,
        settings: Settings | None = None,
        *,
        k8s_url: str | None = None,
        k8s_token: str | None = None,
        k8s_ca_path: str | None = None,
        prometheus_url: str | None = None,
        loki_url: str | None = None,
        timeout_s: float = 10.0,
    ) -> None:
        self.settings = settings or get_settings()
        self.k8s_url = (k8s_url or "https://kubernetes.default.svc").rstrip("/")
        self.prometheus_url = (prometheus_url or self.settings.prometheus_url).rstrip("/")
        self.loki_url = (loki_url or self.settings.loki_url).rstrip("/")
        self.timeout_s = timeout_s
        if k8s_token is None and (_SA_DIR / "token").exists():
            k8s_token = (_SA_DIR / "token").read_text().strip()
        self._token = k8s_token
        ca = k8s_ca_path or (str(_SA_DIR / "ca.crt") if (_SA_DIR / "ca.crt").exists() else None)
        if self.k8s_url.startswith("https"):
            self._ctx: ssl.SSLContext | None = (
                ssl.create_default_context(cafile=ca) if ca else ssl.create_default_context())
        else:
            self._ctx = None
        from ..observability import get_logger
        self._log = get_logger("live_backend")

    @property
    def now(self) -> datetime:
        """Wall clock — the FakeCluster pins this for determinism; live
        backends always answer with real time."""
        return utcnow()

    # -- transport --------------------------------------------------------

    def _get(self, base: str, path: str, params: dict[str, Any] | None = None,
             bearer: bool = False) -> Any:
        url = base + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        req = urllib.request.Request(url, headers={"Accept": "application/json"})
        if bearer and self._token:
            req.add_header("Authorization", f"Bearer {self._token}")
        with urllib.request.urlopen(req, timeout=self.timeout_s,
                                    context=self._ctx if base == self.k8s_url else None) as resp:
            ctype = (resp.headers.get("Content-Type") or "").split(";")[0].strip()
            body = resp.read()
            # a proxy/login page answering 200 text/html would otherwise
            # surface as an inscrutable JSONDecodeError ten frames deeper
            if ctype and "json" not in ctype:
                raise ValueError(
                    f"non-JSON response from {url}: Content-Type={ctype!r}, "
                    f"body starts {body[:80]!r}")
            return json.loads(body)

    def _k8s(self, path: str, params: dict[str, Any] | None = None) -> Any:
        return self._get(self.k8s_url, path, params, bearer=True)

    # real API servers chunk large collections; a 50k-pod namespace comes
    # back in pages threaded by metadata.continue (an opaque token the
    # client must echo verbatim). The reference's kubernetes client pages
    # transparently; this client must too or big lists silently truncate.
    _LIST_LIMIT = 500

    def _k8s_list(self, path: str,
                  params: dict[str, Any] | None = None) -> list[dict]:
        # A continue token can outlive etcd compaction on a churning
        # cluster; the API server then answers 410 Gone. The official
        # clients relist from scratch once — do the same rather than
        # failing the whole collection mid-listing.
        for attempt in range(2):
            items: list[dict] = []
            page = dict(params or {})
            page["limit"] = self._LIST_LIMIT
            minted = False  # did WE advance past the caller's first page?
            try:
                while True:
                    data = self._k8s(path, page)
                    items.extend(data.get("items") or [])
                    token = (data.get("metadata") or {}).get("continue")
                    if not token:
                        return items
                    page = dict(params or {})
                    page["limit"] = self._LIST_LIMIT
                    page["continue"] = token
                    minted = True
            except urllib.error.HTTPError as e:
                # Relist only for tokens this loop minted mid-listing
                # (matching the official client: an explicit caller token
                # that is stale is the caller's protocol error to see).
                if e.code != 410 or attempt or not minted:
                    raise
                self._log.warning("k8s_list_expired_continue", path=path)
        raise AssertionError("unreachable: second attempt returns or raises")

    def _k8s_write(self, method: str, path: str, payload: dict | None = None,
                   content_type: str = "application/strategic-merge-patch+json"
                   ) -> bool:
        req = urllib.request.Request(
            self.k8s_url + path, method=method,
            data=json.dumps(payload).encode() if payload is not None else None)
        if self._token:
            req.add_header("Authorization", f"Bearer {self._token}")
        if payload is not None:
            req.add_header("Content-Type", content_type)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s,
                                        context=self._ctx) as resp:
                return 200 <= resp.status < 300
        except (OSError, http.client.HTTPException) as exc:
            self._log.error("k8s_write_failed", method=method, path=path,
                            error=str(exc))
            return False

    # -- K8s object mapping ----------------------------------------------

    @staticmethod
    def _service_of(meta: dict) -> str:
        labels = meta.get("labels") or {}
        return labels.get("app") or labels.get("app.kubernetes.io/name") or meta.get("name", "")

    @staticmethod
    def _owner_deployment(meta: dict) -> str:
        for ref in meta.get("ownerReferences") or []:
            if ref.get("kind") == "ReplicaSet":
                name = ref.get("name", "")
                return name.rsplit("-", 1)[0] if "-" in name else name
            if ref.get("kind") == "Deployment":
                return ref.get("name", "")
        return ""

    def list_pods(self, namespace: str, service: str | None = None) -> list[PodState]:
        params = {"labelSelector": f"app={service}"} if service else None
        out: list[PodState] = []
        for item in self._k8s_list(f"/api/v1/namespaces/{namespace}/pods", params):
            meta, spec, status = item["metadata"], item.get("spec", {}), item.get("status", {})
            waiting = terminated = None
            restarts = 0
            probe_failing = False
            statuses: list[dict] = []
            for cs in status.get("containerStatuses") or []:
                restarts += int(cs.get("restartCount", 0))
                state = cs.get("state") or {}
                # per-container review detail, the reference's payload shape
                # (kubernetes_collector.py:218-245)
                sinfo: dict = {"name": cs.get("name", ""),
                               "ready": bool(cs.get("ready", False)),
                               "restart_count": int(cs.get("restartCount", 0))}
                if "waiting" in state:
                    sinfo["waiting"] = {
                        "reason": state["waiting"].get("reason"),
                        "message": state["waiting"].get("message")}
                    if waiting is None:
                        waiting = state["waiting"].get("reason")
                if "terminated" in state:
                    sinfo["terminated"] = {
                        "reason": state["terminated"].get("reason"),
                        "exit_code": state["terminated"].get("exitCode")}
                lt = (cs.get("lastState") or {}).get("terminated")
                if lt:
                    sinfo["last_terminated"] = {
                        "reason": lt.get("reason"),
                        "exit_code": lt.get("exitCode")}
                statuses.append(sinfo)
                last = lt or state.get("terminated")
                if last and terminated is None:
                    terminated = last.get("reason")
                if "running" in state and not cs.get("ready", True):
                    probe_failing = True
            ready = False
            not_ready_s = 0.0
            for cond in status.get("conditions") or []:
                if cond.get("type") == "Ready":
                    ready = cond.get("status") == "True"
                    if not ready and cond.get("lastTransitionTime"):
                        not_ready_s = max(0.0, (utcnow() - parse_iso(
                            cond["lastTransitionTime"])).total_seconds())
            resources = {
                c["name"]: {"requests": (c.get("resources") or {}).get("requests"),
                            "limits": (c.get("resources") or {}).get("limits")}
                for c in spec.get("containers") or [] if c.get("resources")}
            out.append(PodState(
                name=meta["name"], namespace=namespace,
                deployment=self._owner_deployment(meta) or self._service_of(meta),
                service=self._service_of(meta),
                node=spec.get("nodeName", ""),
                phase=status.get("phase", "Unknown"),
                ready=ready, restart_count=restarts,
                waiting_reason=waiting, terminated_reason=terminated,
                not_ready_seconds=not_ready_s,
                readiness_probe_failing=probe_failing,
                started_at=parse_iso(status["startTime"]) if status.get("startTime") else None,
                creation_ts=parse_iso(meta["creationTimestamp"])
                if meta.get("creationTimestamp") else None,
                conditions=[{"type": c.get("type"), "status": c.get("status"),
                             "reason": c.get("reason")}
                            for c in status.get("conditions") or []],
                container_statuses=statuses,
                resources=resources,
                labels=dict(meta.get("labels") or {}),
            ))
        return sorted(out, key=lambda p: p.name)

    def list_deployments(self, namespace: str, service: str | None = None) -> list[DeploymentState]:
        params = {"labelSelector": f"app={service}"} if service else None
        out: list[DeploymentState] = []
        for item in self._k8s_list(
                f"/apis/apps/v1/namespaces/{namespace}/deployments", params):
            meta, spec, status = item["metadata"], item.get("spec", {}), item.get("status", {})
            containers = ((spec.get("template") or {}).get("spec") or {}).get("containers") or []
            changed_at: Optional[datetime] = None
            for cond in status.get("conditions") or []:
                if cond.get("type") == "Progressing" and cond.get("lastUpdateTime"):
                    changed_at = parse_iso(cond["lastUpdateTime"])
            hist = self.rollout_history(namespace, meta["name"])
            out.append(DeploymentState(
                name=meta["name"], namespace=namespace,
                service=self._service_of(meta),
                replicas=int(spec.get("replicas", 0)),
                ready_replicas=int(status.get("readyReplicas", 0) or 0),
                revision=int((meta.get("annotations") or {}).get(
                    "deployment.kubernetes.io/revision", 1)),
                image=containers[0]["image"] if containers else "",
                prev_image=hist[1]["image"] if len(hist) > 1 else None,
                changed_at=changed_at,
            ))
        return sorted(out, key=lambda d: d.name)

    def list_nodes(self) -> list[NodeState]:
        out = []
        for item in self._k8s_list("/api/v1/nodes"):
            conds = {c["type"]: c["status"]
                     for c in (item.get("status", {}).get("conditions") or [])}
            out.append(NodeState(name=item["metadata"]["name"], conditions=conds))
        return sorted(out, key=lambda n: n.name)

    def list_hpas(self, namespace: str, service: str | None = None) -> list[HPAState]:
        out = []
        for item in self._k8s_list(
                f"/apis/autoscaling/v2/namespaces/{namespace}/horizontalpodautoscalers"):
            spec, status = item.get("spec", {}), item.get("status", {})
            target = (spec.get("scaleTargetRef") or {}).get("name", "")
            if service and target != service:
                # scale targets are deployments; match either name
                labels = item["metadata"].get("labels") or {}
                if labels.get("app") != service:
                    continue
            cur = int(status.get("currentReplicas", 0) or 0)
            mx = int(spec.get("maxReplicas", 0) or 0)
            out.append(HPAState(
                name=item["metadata"]["name"], namespace=namespace,
                deployment=target,
                min_replicas=int(spec.get("minReplicas", 1) or 1),
                max_replicas=mx, current_replicas=cur,
                at_max=mx > 0 and cur >= mx,
            ))
        return sorted(out, key=lambda h: h.name)

    def list_configmaps(self, namespace: str) -> list[ConfigMapState]:
        out = []
        for item in self._k8s_list(f"/api/v1/namespaces/{namespace}/configmaps"):
            meta = item["metadata"]
            # K8s keeps no modification time; managedFields carries the last
            # apply time per manager (deploy_diff uses it as change signal)
            times = [f.get("time") for f in meta.get("managedFields") or [] if f.get("time")]
            changed = max((parse_iso(t) for t in times), default=None)
            if changed is None and meta.get("creationTimestamp"):
                changed = parse_iso(meta["creationTimestamp"])
            out.append(ConfigMapState(
                name=meta["name"], namespace=namespace, changed_at=changed))
        return sorted(out, key=lambda c: c.name)

    def list_events(self, namespace: str, since: datetime) -> list[EventState]:
        out = []
        for item in self._k8s_list(f"/api/v1/namespaces/{namespace}/events"):
            ts = item.get("lastTimestamp") or item.get("eventTime") \
                or (item.get("metadata") or {}).get("creationTimestamp")
            when = parse_iso(ts) if ts else None
            if when is None or when < since:
                continue
            involved = (item.get("involvedObject") or {}).get("name", "")
            out.append(EventState(
                namespace=namespace, involved_object=involved,
                reason=item.get("reason", ""), type=item.get("type", "Normal"),
                message=item.get("message", ""), timestamp=when,
            ))
        return out

    def rollout_history(self, namespace: str, deployment: str) -> list[dict]:
        """Top-2 revisions from owned ReplicaSets (the reference's
        kubectl-rollout-history analog, deploy_diff_collector.py:270-394)."""
        revisions = []
        for item in self._k8s_list(
                f"/apis/apps/v1/namespaces/{namespace}/replicasets"):
            meta = item["metadata"]
            owners = [r.get("name") for r in meta.get("ownerReferences") or []
                      if r.get("kind") == "Deployment"]
            if deployment not in owners:
                continue
            containers = (((item.get("spec") or {}).get("template") or {})
                          .get("spec") or {}).get("containers") or []
            revisions.append({
                "revision": int((meta.get("annotations") or {}).get(
                    "deployment.kubernetes.io/revision", 0)),
                "image": containers[0]["image"] if containers else "",
                "changed_at": parse_iso(meta["creationTimestamp"])
                if meta.get("creationTimestamp") else None,
            })
        revisions.sort(key=lambda r: r["revision"], reverse=True)
        return revisions[:2]

    # -- Loki -------------------------------------------------------------

    def query_logs(self, namespace: str, service: str, limit: int = 1000) -> list[str]:
        """Loki query_range, newest first (reference logs_collector.py:80-116)."""
        logql = f'{{namespace="{namespace}",app="{service}"}}'
        try:
            data = self._get(self.loki_url, "/loki/api/v1/query_range", {
                "query": logql, "limit": limit, "direction": "backward",
            })
        except (OSError, ValueError, http.client.HTTPException) as exc:
            self._log.warning("loki_query_failed", error=str(exc))
            return []
        lines: list[str] = []
        for stream in ((data.get("data") or {}).get("result") or []):
            for _ts, line in stream.get("values") or []:
                lines.append(line)
        return lines[:limit]

    # -- Prometheus --------------------------------------------------------

    def _render_query(self, namespace: str, service: str,
                      query_name: str) -> str | None:
        from .metrics import load_query_library
        for queries in load_query_library().values():
            if query_name in queries:
                return (queries[query_name]
                        .replace("{{namespace}}", namespace)
                        .replace("{{deployment}}", service)
                        .replace("{{pod_prefix}}", _pod_prefix(service)))
        return None

    def query_metric(self, namespace: str, service: str, query_name: str) -> float | None:
        """Render the named query from the promql library and take the max
        sample of a Prometheus instant query (metrics_collector.py:161-185;
        the fake backend answers the same names from its metric table)."""
        promql = self._render_query(namespace, service, query_name)
        if promql is None:
            return None
        try:
            data = self._get(self.prometheus_url, "/api/v1/query", {"query": promql})
        except (OSError, ValueError, http.client.HTTPException) as exc:
            self._log.warning("prometheus_query_failed", error=str(exc))
            return None
        results = ((data.get("data") or {}).get("result") or [])
        values = []
        for r in results:
            pair = r.get("value") or (r.get("values") or [None])[-1]
            if pair and len(pair) == 2:
                try:
                    values.append(float(pair[1]))
                except (TypeError, ValueError):
                    continue
        return max(values) if values else None

    def query_metric_range(self, namespace: str, service: str,
                           query_name: str, start_s: float,
                           end_s: float) -> list[tuple[float, float]]:
        """Prometheus ``query_range`` over the evidence window with the
        reference's step formula — step = max(15, range // 100)
        (metrics_collector.py:161-185). All result series are merged and
        time-sorted; non-finite samples are dropped (:224-236). The caller
        (collectors/metrics.py) downsamples and computes the stats block."""
        promql = self._render_query(namespace, service, query_name)
        if promql is None or end_s <= start_s:
            return []
        step = max(15, int(end_s - start_s) // 100)
        try:
            data = self._get(self.prometheus_url, "/api/v1/query_range", {
                "query": promql, "start": int(start_s), "end": int(end_s),
                "step": step,
            })
        except (OSError, ValueError, http.client.HTTPException) as exc:
            self._log.warning("prometheus_query_range_failed", error=str(exc))
            return []
        samples: list[tuple[float, float]] = []
        for r in ((data.get("data") or {}).get("result") or []):
            for pair in r.get("values") or []:
                if not pair or len(pair) != 2:
                    continue
                try:
                    ts, v = float(pair[0]), float(pair[1])
                except (TypeError, ValueError):
                    continue
                if v == float("inf") or v == float("-inf") or v != v:
                    continue
                samples.append((ts, v))
        samples.sort()
        return samples


    # -- mutations (RemediationExecutor write surface; reference
    # -- executor.py:86-307 via the kubernetes client) ---------------------

    def delete_pod(self, namespace: str, name: str) -> bool:
        """restart_pod = delete the pod (reference executor.py:86-134)."""
        return self._k8s_write(
            "DELETE", f"/api/v1/namespaces/{namespace}/pods/{name}")

    def restart_deployment(self, namespace: str, name: str) -> bool:
        """Patch the restartedAt annotation (reference executor.py:136-175)."""
        return self._k8s_write(
            "PATCH", f"/apis/apps/v1/namespaces/{namespace}/deployments/{name}",
            {"spec": {"template": {"metadata": {"annotations": {
                "kubectl.kubernetes.io/restartedAt": utcnow().isoformat()}}}}})

    def rollback_deployment(self, namespace: str, name: str) -> bool:
        """Copy the previous ReplicaSet's pod template back onto the
        deployment (reference executor.py:177-234, top-2 by revision)."""
        owned = []
        for item in self._k8s_list(
                f"/apis/apps/v1/namespaces/{namespace}/replicasets"):
            meta = item["metadata"]
            if any(r.get("kind") == "Deployment" and r.get("name") == name
                   for r in meta.get("ownerReferences") or []):
                owned.append((int((meta.get("annotations") or {}).get(
                    "deployment.kubernetes.io/revision", 0)), item))
        owned.sort(key=lambda t: t[0], reverse=True)
        if len(owned) < 2:
            self._log.error("rollback_no_previous_revision",
                            namespace=namespace, deployment=name)
            return False
        prev_template = (owned[1][1].get("spec") or {}).get("template")
        if not prev_template:
            return False
        return self._k8s_write(
            "PATCH", f"/apis/apps/v1/namespaces/{namespace}/deployments/{name}",
            {"spec": {"template": prev_template}})

    def scale_deployment(self, namespace: str, name: str, replicas: int) -> bool:
        """Patch the scale subresource (reference executor.py:236-281)."""
        return self._k8s_write(
            "PATCH",
            f"/apis/apps/v1/namespaces/{namespace}/deployments/{name}/scale",
            {"spec": {"replicas": int(replicas)}},
            content_type="application/merge-patch+json")

    def cordon_node(self, name: str) -> bool:
        """unschedulable=true (reference executor.py:283-307)."""
        return self._k8s_write(
            "PATCH", f"/api/v1/nodes/{name}",
            {"spec": {"unschedulable": True}})

    def uncordon_node(self, name: str) -> bool:
        """unschedulable=false (graft-saga compensation inverse)."""
        return self._k8s_write(
            "PATCH", f"/api/v1/nodes/{name}",
            {"spec": {"unschedulable": False}})


def make_backend(settings: Settings | None = None, **overrides) -> Any:
    """cluster_backend setting -> backend instance (fake needs a cluster
    passed explicitly; this factory covers the live path)."""
    settings = settings or get_settings()
    if settings.cluster_backend == "kubernetes":
        return LiveClusterBackend(settings, **overrides)
    raise ValueError(
        f"cluster_backend={settings.cluster_backend!r}: the fake backend is "
        "constructed from a FakeCluster (simulator.generate_cluster), not "
        "from this factory")
