"""Deploy-diff collector — recent rollout / image / config change evidence.

Parity with the reference DeployDiffCollector (deploy_diff_collector.py:49-458):
rollout recency vs a 30-minute window → DEPLOY_CHANGE (signal 0.95 when
recent), top-2 revision image comparison → IMAGE_CHANGE (0.85), configmap
changes inside the evidence window → CONFIG_CHANGE (0.6); recent changes
emit a ChangeEvent entity plus HAS_RECENT_CHANGE / CORRELATES_WITH
relations (:233-268).
"""
from __future__ import annotations

from datetime import timedelta

from ..graph import ids
from ..models import (
    CollectorResult,
    EvidenceSource,
    EvidenceType,
    GraphEntity,
    GraphRelation,
    Incident,
)
from ..rca.ruleset import RECENT_DEPLOY_WINDOW_MIN
from .base import BaseCollector


class DeployDiffCollector(BaseCollector):
    name = "deploy_diff"
    source = EvidenceSource.KUBERNETES_API

    def collect(self, incident: Incident) -> CollectorResult:
        result = CollectorResult(collector_name=self.name)
        ns = incident.namespace
        now = self.backend.now
        inc_node = ids.incident_id(str(incident.id))
        recent_cutoff = now - timedelta(minutes=RECENT_DEPLOY_WINDOW_MIN)

        for d in self.backend.list_deployments(ns, incident.service):
            history = self.backend.rollout_history(ns, d.name)
            if not history:
                continue
            head = history[0]
            changed_at = head.get("changed_at")
            is_recent = changed_at is not None and changed_at >= recent_cutoff
            data = {
                "deployment": d.name,
                "revision": head["revision"],
                "image": head["image"],
                "is_recent_change": is_recent,
                "changed_at": changed_at.isoformat() if changed_at else None,
            }
            result.evidence.append(self.make_evidence(
                incident, EvidenceType.DEPLOY_CHANGE, d.name, data,
                signal_strength=0.95 if is_recent else 0.2,  # :93-215
                is_anomaly=is_recent,
            ))
            if is_recent:
                change_node = ids.change_id(ns, d.name, head["revision"])
                dep_node = ids.deployment_id(ns, d.name)
                result.entities.append(GraphEntity(
                    id=change_node, type="ChangeEvent",
                    properties={
                        "namespace": ns, "deployment": d.name,
                        "revision": head["revision"],
                        "changed_at": changed_at.isoformat(),
                        "is_recent_change": True,
                    }))
                result.relations.append(GraphRelation(
                    source_id=dep_node, target_id=change_node,
                    relation_type="HAS_RECENT_CHANGE"))
                result.relations.append(GraphRelation(
                    source_id=inc_node, target_id=change_node,
                    relation_type="CORRELATES_WITH"))

            # image diff between top-2 revisions (:270-394)
            if len(history) >= 2 and history[0]["image"] != history[1]["image"]:
                result.evidence.append(self.make_evidence(
                    incident, EvidenceType.IMAGE_CHANGE, d.name,
                    {
                        "deployment": d.name,
                        "image_changed": True,
                        "old_image": history[1]["image"],
                        "new_image": history[0]["image"],
                    },
                    signal_strength=0.85, is_anomaly=True,
                ))

        # configmap changes within the evidence window (:396-458)
        window_start, _ = self.window(incident, now)
        for c in self.backend.list_configmaps(ns):
            if c.changed_at is not None and c.changed_at >= window_start:
                result.evidence.append(self.make_evidence(
                    incident, EvidenceType.CONFIG_CHANGE, c.name,
                    {
                        "configmap": c.name,
                        "config_changed": True,
                        "changed_at": c.changed_at.isoformat(),
                        "mounted_by": list(c.mounted_by),
                    },
                    signal_strength=0.6, is_anomaly=True,
                ))
        return result
