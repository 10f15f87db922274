"""Evidence → graph assembly.

Replaces the reference's ``build_evidence_graph`` activity
(activities.py:96-123): collector results (entities + relations) merge into
the in-memory store, and evidence payloads are folded onto the graph nodes
they describe so the tensorizer (snapshot.py) sees every signal the CPU
rules engine would see in the raw evidence list — the invariant the
CPU-vs-TPU parity tests enforce.
"""
from __future__ import annotations

from typing import Iterable

from ..models import CollectorResult, Evidence, EvidenceType, GraphEntity, GraphRelation, Incident
from . import ids
from .store import EvidenceGraphStore

# evidence.data keys that become node properties the feature extractor reads
_MERGE_KEYS = (
    "waiting_reason", "terminated_reason", "restart_count", "ready",
    "not_ready_seconds", "readiness_probe_failing", "phase",
    "error_count", "patterns_found", "network_error_count",
    "is_recent_change", "image_changed", "config_changed", "changed_at",
    "memory_usage_high", "cpu_throttling", "hpa_at_max", "at_max",
    "latency_high", "conditions", "unavailable_replicas",
)

_TYPE_PREFIX = {
    EvidenceType.KUBERNETES_POD: "pod",
    EvidenceType.KUBERNETES_DEPLOYMENT: "deployment",
    EvidenceType.KUBERNETES_REPLICASET: "replicaset",
    EvidenceType.KUBERNETES_NODE: "node",
    EvidenceType.KUBERNETES_SERVICE: "service",
    EvidenceType.KUBERNETES_CONFIGMAP: "configmap",
    EvidenceType.KUBERNETES_HPA: "hpa",
    EvidenceType.LOG_SIGNAL: "service",
    EvidenceType.METRIC_SIGNAL: "service",
    EvidenceType.DEPLOY_CHANGE: "deployment",
    EvidenceType.IMAGE_CHANGE: "deployment",
    EvidenceType.CONFIG_CHANGE: "configmap",
}


_PREFIX_LABEL = {
    "pod": "Pod", "deployment": "Deployment", "replicaset": "ReplicaSet",
    "node": "Node", "service": "Service", "configmap": "ConfigMap", "hpa": "HPA",
}


def _metric_flags(data: dict) -> dict:
    """Translate a metric evidence payload into the node-property flags the
    feature extractor reads — the same thresholds the CPU signal fold applies
    (rules_engine.py:337-350), so both backends see identical booleans.
    Thresholds read the series eval value via metric_eval (the family's
    windowed statistic), exactly like rca/signals._fold_metric."""
    from ..utils.metricseries import metric_eval
    flags: dict = {}
    query_name = data.get("query_name", "") or ""
    value = metric_eval(data)
    if "memory" in query_name and data.get("is_anomalous") and value > 90:
        flags["memory_usage_high"] = True
    if "hpa" in query_name and "max" in query_name and value >= 1:
        flags["hpa_at_max"] = True
    if "latency" in query_name and value > 1:
        flags["latency_high"] = True
    if "throttl" in query_name and value > 0.5:
        flags["cpu_throttling"] = True
    return flags


class GraphBuilder:
    """Folds incidents + collector output into an EvidenceGraphStore."""

    def __init__(self, store: EvidenceGraphStore | None = None) -> None:
        self.store = store or EvidenceGraphStore()

    def add_incident(self, incident: Incident) -> str:
        """Create the incident node (reference kubernetes_collector.py:90-102
        creates it inside the collector; here it is the builder's job)."""
        nid = ids.incident_id(str(incident.id))
        self.store.upsert_entity(GraphEntity(
            id=nid,
            type="Incident",
            properties={
                "title": incident.title,
                "severity": incident.severity.value,
                "status": incident.status.value,
                "namespace": incident.namespace,
                "service": incident.service or "",
                "fingerprint": incident.fingerprint,
                "started_at": incident.started_at.isoformat(),
            },
        ))
        return nid

    def ingest(self, incident: Incident, results: Iterable[CollectorResult]) -> dict:
        """Merge one incident's collector results into the graph."""
        inc_node = self.add_incident(incident)
        n_entities = n_relations = n_evidence = 0
        for result in results:
            if result.entities:
                n_entities += self.store.upsert_entities(result.entities)
            if result.relations:
                n_relations += self.store.upsert_relations(result.relations)
            for ev in result.evidence:
                self._apply_evidence(inc_node, ev)
                n_evidence += 1
        return {
            "incident_node": inc_node,
            "entities": n_entities,
            "relations": n_relations,
            "evidence": n_evidence,
        }

    def _apply_evidence(self, incident_node: str, ev: Evidence) -> None:
        """Attach an evidence payload to the node it describes, creating the
        node and an Incident-AFFECTS edge if the collector didn't emit one."""
        prefix = _TYPE_PREFIX.get(ev.evidence_type)
        if prefix is None:
            return  # events etc. carry no node-level features
        node_id = (
            f"{prefix}:{ev.entity_name}" if prefix == "node"
            else f"{prefix}:{ev.entity_namespace}:{ev.entity_name}"
        )
        props = {k: ev.data[k] for k in _MERGE_KEYS if k in ev.data}
        if ev.evidence_type == EvidenceType.METRIC_SIGNAL:
            props.update(_metric_flags(ev.data))
        props["signal_strength"] = max(
            float(ev.signal_strength),
            float((self.store.get_node(node_id) or {}).get("properties", {}).get("signal_strength", 0.0)),
        )
        if ev.is_anomaly:
            props["is_anomaly"] = True
        label = _PREFIX_LABEL[prefix]
        self.store.upsert_entities([GraphEntity(id=node_id, type=label, properties=props)])
        self.store.upsert_relations([GraphRelation(
            source_id=incident_node, target_id=node_id, relation_type="AFFECTS",
        )])
