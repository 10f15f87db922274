"""Churn event stream — deterministic cluster mutations at rate.

BASELINE configs[4]: "streaming graph updates (pod churn @1k events/sec)
with incremental TPU re-scoring". This generator emits a seeded, replayable
sequence of cluster events (pod restarts, reschedules, status flips, metric
drifts, rollouts) that the streaming scorer applies as feature/graph deltas
without rebuilding the snapshot.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from .cluster import FakeCluster


@dataclass(frozen=True)
class ChurnEvent:
    kind: str                  # see _KINDS
    namespace: str
    name: str                  # pod or deployment name (or incident uid)
    payload: dict = field(default_factory=dict)


# Full event mix (VERDICT r1 item 2): mutate-in-place kinds PLUS structural
# growth — pod creation/deletion and incident arrival/closure, the events
# Neo4j MERGE absorbs for free in the reference (neo4j.py:95-166).
_KINDS = ("pod_restart", "pod_flip", "reschedule", "metric_drift", "rollout",
          "pod_create", "pod_delete", "incident_arrival", "incident_close")
_WEIGHTS = (0.34, 0.20, 0.08, 0.15, 0.05, 0.08, 0.05, 0.03, 0.02)


def churn_events(
    cluster: FakeCluster,
    count: int,
    seed: int = 0,
    incident_ids: tuple[str, ...] = (),
    structural: bool = True,
) -> Iterator[ChurnEvent]:
    """Yield `count` deterministic events referencing real cluster objects.

    The generator tracks its own created/deleted pods and open incidents
    (seeded from ``incident_ids``) so delete/close events always reference
    something the stream created or was told about. ``structural=False``
    restores the round-1 mutate-in-place-only mix."""
    rng = np.random.default_rng(seed)
    pod_keys = sorted(cluster.pods)
    deploy_keys = sorted(cluster.deployments)
    node_names = sorted(cluster.nodes)
    if not pod_keys or not deploy_keys:
        return
    open_incidents = list(incident_ids)
    created_serial = 0
    if structural:
        kinds_i, weights = _KINDS, _WEIGHTS
    else:
        kinds_i, weights = _KINDS[:5], tuple(
            w / sum(_WEIGHTS[:5]) for w in _WEIGHTS[:5])
    kinds = rng.choice(len(kinds_i), size=count, p=weights)
    for i in range(count):
        kind = kinds_i[kinds[i]]
        if kind in ("pod_restart", "pod_flip", "reschedule", "pod_delete"):
            key = pod_keys[int(rng.integers(0, len(pod_keys)))]
            ns, name = key.split("/", 1)
            payload: dict = {}
            if kind == "pod_restart":
                payload = {"restart_delta": int(rng.integers(1, 3))}
            elif kind == "pod_flip":
                payload = {"ready": bool(rng.random() < 0.5)}
            elif kind == "reschedule":
                payload = {"node": node_names[int(rng.integers(0, len(node_names)))]}
            else:  # pod_delete
                if len(pod_keys) <= 1:
                    continue
                pod_keys.remove(key)
            yield ChurnEvent(kind, ns, name, payload)
        elif kind == "metric_drift":
            key = deploy_keys[int(rng.integers(0, len(deploy_keys)))]
            d = cluster.deployments[key]
            yield ChurnEvent(kind, d.namespace, d.service, {
                "memory_pct": float(np.clip(rng.normal(60, 20), 5, 99)),
                "error_rate": float(np.clip(rng.exponential(0.01), 0, 0.5)),
            })
        elif kind == "rollout":
            key = deploy_keys[int(rng.integers(0, len(deploy_keys)))]
            d = cluster.deployments[key]
            yield ChurnEvent(kind, d.namespace, d.name, {})
        elif kind == "pod_create":
            key = deploy_keys[int(rng.integers(0, len(deploy_keys)))]
            d = cluster.deployments[key]
            created_serial += 1
            name = f"{d.name}-s{created_serial}"
            pod_keys.append(f"{d.namespace}/{name}")
            pod_keys.sort()
            attach = None
            if open_incidents and rng.random() < 0.5:
                attach = open_incidents[int(rng.integers(0, len(open_incidents)))]
            yield ChurnEvent(kind, d.namespace, name, {
                "deployment": d.name, "service": d.service,
                "node": node_names[int(rng.integers(0, len(node_names)))],
                "attach_to": attach,   # becomes evidence of an open incident
            })
        elif kind == "incident_arrival":
            key = deploy_keys[int(rng.integers(0, len(deploy_keys)))]
            d = cluster.deployments[key]
            uid = f"stream-{seed}-{i}"
            open_incidents.append(uid)
            yield ChurnEvent(kind, d.namespace, uid, {
                "deployment": d.name, "service": d.service,
                "max_evidence": int(rng.integers(2, 6)),
            })
        else:  # incident_close
            if not open_incidents:
                continue
            uid = open_incidents.pop(int(rng.integers(0, len(open_incidents))))
            yield ChurnEvent(kind, "", uid, {})


def apply_event(cluster: FakeCluster, event: ChurnEvent) -> list[str]:
    """Mutate cluster state; returns the graph node ids whose features
    changed (the delta set for incremental re-scoring)."""
    touched: list[str] = []
    key = f"{event.namespace}/{event.name}"
    if event.kind == "pod_restart":
        p = cluster.pods.get(key)
        if p is not None:
            p.restart_count += event.payload.get("restart_delta", 1)
            touched.append(f"pod:{p.namespace}:{p.name}")
    elif event.kind == "pod_flip":
        p = cluster.pods.get(key)
        if p is not None:
            p.ready = event.payload["ready"]
            p.not_ready_seconds = 0.0 if p.ready else 360.0
            touched.append(f"pod:{p.namespace}:{p.name}")
    elif event.kind == "reschedule":
        p = cluster.pods.get(key)
        if p is not None:
            p.node = event.payload["node"]
            touched.append(f"pod:{p.namespace}:{p.name}")
    elif event.kind == "metric_drift":
        m = cluster.service_metrics(event.namespace, event.name)
        m.memory_pct = event.payload["memory_pct"]
        m.error_rate = event.payload["error_rate"]
        touched.append(f"service:{event.namespace}:{event.name}")
    elif event.kind == "rollout":
        d = cluster.deployments.get(key)
        if d is not None:
            d.revision += 1
            d.prev_image = d.image
            d.image = d.image.rsplit(":", 1)[0] + f":v{d.revision}"
            d.changed_at = cluster.now
            touched.append(f"deployment:{d.namespace}:{d.name}")
    elif event.kind == "pod_create":
        from .cluster import PodState
        cluster.add_pod(PodState(
            name=event.name, namespace=event.namespace,
            deployment=event.payload["deployment"],
            service=event.payload["service"], node=event.payload["node"],
            started_at=cluster.now))
        touched.append(f"pod:{event.namespace}:{event.name}")
    elif event.kind == "pod_delete":
        if cluster.remove_pod(event.namespace, event.name) is not None:
            touched.append(f"pod:{event.namespace}:{event.name}")
    # incident_arrival / incident_close don't touch cluster state: incidents
    # live in the graph/store; stream_step() handles them there
    return touched


class _StoreOnly:
    """stream_step scorer stand-in that drops every mirror call: drivers
    that serve through a journal-draining path (scorer.sync(), serve(),
    or the graft-shield's write-ahead staging) mutate ONLY the store and
    let the scorer catch up from its change journal — the shield's
    durability guarantee covers exactly what flows through that journal."""

    def __getattr__(self, name):
        return lambda *a, **k: None


_STORE_ONLY = _StoreOnly()


def store_step(cluster: FakeCluster, store, event: ChurnEvent) -> list[str]:
    """stream_step without the direct scorer mirroring: cluster + store
    only. Feature mutations are journaled via ``store.touch_nodes`` (the
    in-place property path bypasses upsert), so a journal-draining
    consumer — scorer.sync(), serve(), the graft-shield WAL — sees every
    change. The full-mix driver for journal-synced serving (graft-shield
    fault-injection tests, recovery bench)."""
    touched = stream_step(cluster, store, _STORE_ONLY, event)
    store.touch_nodes(touched)
    return touched


def stream_step(cluster: FakeCluster, store, scorer, event: ChurnEvent) -> list[str]:
    """Apply ONE event everywhere: cluster state, graph store (authoritative
    — rebuilds read it), and the streaming scorer's incremental state.
    Returns the touched node ids. This is the full-mix driver the bench and
    the rebuild-parity tests share."""
    from ..graph import ids
    from ..models import GraphEntity, GraphRelation

    if event.kind == "reschedule":
        pod_nid = ids.pod_id(event.namespace, event.name)
        node_nid = ids.node_id(event.payload["node"])
        touched = apply_event(cluster, event)
        sync_touched_to_store(cluster, store, touched)
        if touched and store.get_node(pod_nid) is not None:
            for old in store.relations_from(pod_nid, "SCHEDULED_ON"):
                if old != node_nid:
                    store.remove_relation(pod_nid, old, "SCHEDULED_ON")
            store.upsert_relations([GraphRelation(
                source_id=pod_nid, target_id=node_nid,
                relation_type="SCHEDULED_ON")])
            scorer.schedule_pod(pod_nid, node_nid)
        scorer.update_nodes(touched)
        return touched

    if event.kind == "pod_create":
        touched = apply_event(cluster, event)
        p = cluster.pods[f"{event.namespace}/{event.name}"]
        pod_nid = ids.pod_id(p.namespace, p.name)
        store.upsert_entities([GraphEntity(
            id=pod_nid, type="Pod",
            properties={"waiting_reason": p.waiting_reason,
                        "terminated_reason": p.terminated_reason,
                        "restart_count": p.restart_count, "ready": p.ready,
                        "phase": p.phase})])
        store.upsert_relations([
            GraphRelation(source_id=pod_nid,
                          target_id=ids.node_id(p.node),
                          relation_type="SCHEDULED_ON"),
            GraphRelation(source_id=ids.deployment_id(p.namespace, p.deployment),
                          target_id=pod_nid, relation_type="OWNS"),
        ])
        scorer.add_entity(pod_nid)
        scorer.schedule_pod(pod_nid, ids.node_id(p.node))
        attach = event.payload.get("attach_to")
        if attach:
            inc_nid = attach if attach.startswith("incident:") \
                else f"incident:{attach}"
            if store.get_node(inc_nid) is not None:
                store.upsert_relations([GraphRelation(
                    source_id=inc_nid, target_id=pod_nid,
                    relation_type="AFFECTS")])
                scorer.add_evidence(inc_nid, pod_nid)
        return touched

    if event.kind == "pod_delete":
        pod_nid = ids.pod_id(event.namespace, event.name)
        touched = apply_event(cluster, event)
        if touched:
            store.remove_node(pod_nid)
            scorer.remove_entity(pod_nid)
        return touched

    if event.kind == "incident_arrival":
        inc_nid = event.name if event.name.startswith("incident:") \
            else f"incident:{event.name}"
        svc = event.payload["service"]
        pods = cluster.list_pods(event.namespace, svc)
        evidence = [ids.pod_id(p.namespace, p.name)
                    for p in pods[:event.payload.get("max_evidence", 5)]]
        evidence.append(ids.service_id(event.namespace, svc))
        store.upsert_entities([GraphEntity(
            id=inc_nid, type="Incident",
            properties={"severity": "high", "service": svc,
                        "namespace": event.namespace})])
        store.upsert_relations([
            GraphRelation(source_id=inc_nid, target_id=eid,
                          relation_type="AFFECTS")
            for eid in evidence if store.get_node(eid) is not None])
        scorer.add_incident(inc_nid, [
            eid for eid in evidence if store.get_node(eid) is not None])
        return [inc_nid]

    if event.kind == "incident_close":
        inc_nid = event.name if event.name.startswith("incident:") \
            else f"incident:{event.name}"
        if store.get_node(inc_nid) is None:
            return []
        scorer.close_incident(inc_nid)
        store.cleanup_incident(inc_nid)
        return [inc_nid]

    # mutate-in-place kinds
    touched = apply_event(cluster, event)
    sync_touched_to_store(cluster, store, touched)
    scorer.update_nodes(touched)
    return touched


def sync_touched_to_store(cluster: FakeCluster, store, touched: list[str]) -> None:
    """Propagate mutated cluster state onto the graph-store node property
    bags so feature re-extraction sees the new values (the kube-state sync
    delta path; full sync is graph.topology_sync)."""
    for nid in touched:
        kind, rest = nid.split(":", 1)
        node = store.get_node(nid)
        if node is None:
            continue
        if kind == "pod":
            ns, name = rest.split(":", 1)
            p = cluster.pods.get(f"{ns}/{name}")
            if p is not None:
                from ..collectors.kubernetes import pod_detail
                node_obj = store._nodes[nid]  # in-place property update
                node_obj.properties.update(
                    waiting_reason=p.waiting_reason,
                    terminated_reason=p.terminated_reason,
                    restart_count=p.restart_count, ready=p.ready,
                    not_ready_seconds=p.not_ready_seconds, phase=p.phase,
                    # keep the review-surface detail coherent with the
                    # scalars: graph-API consumers read node properties,
                    # and a churned pod must not show pre-churn container
                    # state next to post-churn scalars
                    **pod_detail(p))
        elif kind == "service":
            ns, name = rest.split(":", 1)
            m = cluster.metrics.get(f"{ns}/{name}")
            if m is not None:
                store._nodes[nid].properties.update(
                    memory_usage_high=m.memory_pct > 90,
                    latency_high=m.p99_latency_s > 1.0)
        elif kind == "deployment":
            ns, name = rest.split(":", 1)
            d = cluster.deployments.get(f"{ns}/{name}")
            if d is not None:
                store._nodes[nid].properties.update(
                    revision=d.revision,
                    is_recent_change=True,
                    changed_at=d.changed_at.isoformat() if d.changed_at else None)
