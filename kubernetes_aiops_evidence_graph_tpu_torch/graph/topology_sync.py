"""Cluster-topology sync: load the full cluster into the evidence graph.

The reference's Neo4j graph only ever contains entities touched by incident
evidence; BASELINE.json's large configs ("50k-node multi-namespace mesh
topology") presuppose a continuously-synced topology layer — the kube-state
analog. This module bulk-loads every pod/node/deployment/service/HPA plus
OWNS / SCHEDULED_ON / SELECTS / CALLS edges from a cluster backend into the
store, so incident scoring and 3-hop propagation run against the real mesh.
"""
from __future__ import annotations

from ..models import GraphEntity, GraphRelation
from . import ids
from .store import EvidenceGraphStore


def sync_topology(cluster, store: EvidenceGraphStore) -> dict:
    """Bulk-load FakeCluster/real-backend state into the graph store."""
    entities: list[GraphEntity] = []
    relations: list[GraphRelation] = []

    for n in cluster.nodes.values():
        entities.append(GraphEntity(
            id=ids.node_id(n.name), type="Node",
            properties={"name": n.name,
                        "conditions": {k: {"status": v} for k, v in n.conditions.items()}},
        ))

    for d in cluster.deployments.values():
        dep = ids.deployment_id(d.namespace, d.name)
        entities.append(GraphEntity(
            id=dep, type="Deployment",
            properties={"replicas": d.replicas, "ready_replicas": d.ready_replicas,
                        "unavailable_replicas": max(0, d.replicas - d.ready_replicas),
                        "revision": d.revision},
        ))

    for s in cluster.services.values():
        svc = ids.service_id(s.namespace, s.name)
        entities.append(GraphEntity(id=svc, type="Service",
                                    properties={"name": s.name, "namespace": s.namespace}))
        for callee in s.calls:
            relations.append(GraphRelation(
                source_id=svc, target_id=ids.service_id(s.namespace, callee),
                relation_type="CALLS"))

    for p in cluster.pods.values():
        pod = ids.pod_id(p.namespace, p.name)
        entities.append(GraphEntity(
            id=pod, type="Pod",
            properties={"waiting_reason": p.waiting_reason,
                        "terminated_reason": p.terminated_reason,
                        "restart_count": p.restart_count, "ready": p.ready,
                        "phase": p.phase},
        ))
        relations.append(GraphRelation(
            source_id=pod, target_id=ids.node_id(p.node), relation_type="SCHEDULED_ON"))
        relations.append(GraphRelation(
            source_id=ids.deployment_id(p.namespace, p.deployment), target_id=pod,
            relation_type="OWNS"))
        relations.append(GraphRelation(
            source_id=ids.service_id(p.namespace, p.service), target_id=pod,
            relation_type="SELECTS"))

    for h in cluster.hpas.values():
        hpa = ids.hpa_id(h.namespace, h.name)
        entities.append(GraphEntity(
            id=hpa, type="HPA",
            properties={"at_max": h.at_max or h.current_replicas >= h.max_replicas,
                        "current_replicas": h.current_replicas,
                        "max_replicas": h.max_replicas},
        ))
        relations.append(GraphRelation(
            source_id=hpa, target_id=ids.deployment_id(h.namespace, h.deployment),
            relation_type="OWNS"))

    ne = store.upsert_entities(entities)
    nr = store.upsert_relations(relations)
    return {"entities": ne, "relations": nr}
