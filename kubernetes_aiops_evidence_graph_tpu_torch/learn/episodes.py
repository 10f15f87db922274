"""Episode builder — production verdicts into labeled training episodes.

The port of the JAX package's ``learn/episodes.py``. Label sources,
strongest first (a stronger source always overrides a weaker one for the
same incident):

1. **Operator feedback** (``hypothesis_feedback``, storage/sqlite.py):
   ``was_correct=True`` confirms the hypothesis' rule;
   ``was_correct=False`` with an ``actual_root_cause`` naming a rule (or
   ``unknown``) relabels the incident with the operator's truth.
2. **Verification outcomes** (``verification_results``): a remediation
   that verified successful confirms the hypothesis it acted on.
3. **Rule-confirmed verdicts** (fallback, ``settings.learn_weak_labels``):
   a rules-tier top-1 at high confidence is a weak label for incidents
   that never received feedback or a verification.

An episode is one snapshot of a tenant's evidence-graph store with the
labeled incidents' rows unmasked (``label_mask``) — the array batch
``rca/gnn.py`` trains on, carrying its ``rel_offsets`` and the snapshot.
Replayed windows dedup by a fingerprint over (incident, label) pairs so a
steady store does not re-enqueue the same episode every harvest cycle.
"""
from __future__ import annotations

import collections
import hashlib

import numpy as np

from ..observability import metrics as obs_metrics
from ..rca import gnn
from ..rca.ruleset import RULE_INDEX

UNKNOWN_CLASS = gnn.NUM_CLASSES - 1

# label-source precedence (higher wins)
_PRIORITY = {"weak_rule": 0, "verification": 1, "feedback": 2}


def _label_for_rule(rule_id: "str | None") -> "int | None":
    if rule_id is None:
        return None
    if rule_id == "unknown":
        return UNKNOWN_CLASS
    return RULE_INDEX.get(rule_id)


def harvest_labels(db, weak: bool = True,
                   weak_confidence: float = 0.9) -> dict[str, tuple[int, str]]:
    """``{incident_id: (class_index, source)}`` from the durable store.

    One SQL pass per source; precedence is feedback > verification >
    weak rule-confirmed (see module docstring). Incidents whose only
    signal is "the top hypothesis was wrong" with no stated truth are
    skipped — a pure negative is not a class label.
    """
    labels: dict[str, tuple[int, str]] = {}

    def put(inc_id, cls, source):
        if cls is None or inc_id is None:
            return
        cur = labels.get(inc_id)
        if cur is None or _PRIORITY[source] > _PRIORITY[cur[1]]:
            labels[str(inc_id)] = (int(cls), source)

    if weak:
        for r in db.query(
                "SELECT incident_id, rule_id, confidence FROM hypotheses"
                " WHERE rank=1 AND generated_by='rules_engine'"
                " AND confidence >= ?", (float(weak_confidence),)):
            put(r["incident_id"], _label_for_rule(r["rule_id"]),
                "weak_rule")
    for r in db.query(
            "SELECT v.success, h.incident_id, h.rule_id"
            " FROM verification_results v"
            " JOIN remediation_actions a ON a.id = v.action_id"
            " JOIN hypotheses h ON h.id = a.hypothesis_id"
            " WHERE v.success = 1"):
        put(r["incident_id"], _label_for_rule(r["rule_id"]), "verification")
    for r in db.query(
            "SELECT f.was_correct, f.actual_root_cause, h.incident_id,"
            " h.rule_id FROM hypothesis_feedback f"
            " JOIN hypotheses h ON h.id = f.hypothesis_id"):
        if r["was_correct"]:
            put(r["incident_id"], _label_for_rule(r["rule_id"]), "feedback")
        else:
            put(r["incident_id"], _label_for_rule(r["actual_root_cause"]),
                "feedback")
    return labels


def build_episode(store, labels: dict[str, tuple[int, str]], settings,
                  now_s: "float | None" = None,
                  tenant: str = "default") -> "dict | None":
    """One labeled episode from the CURRENT store window: tensorize the
    store (the ``build_snapshot`` contract serving uses) and unmask
    exactly the incident rows whose label is known. Returns None when no
    live incident carries a label.

    The returned batch is ``gnn.snapshot_batch`` plus ``label_mask``
    narrowed to labeled rows, ``snapshot``, ``tenant``, ``fingerprint``
    (sha256 over sorted (incident, label) pairs — the replay buffer's
    dedup key) and ``label_sources`` (per-source counts)."""
    from ..graph.snapshot import build_snapshot
    snap = build_snapshot(store, settings, now_s=now_s)
    row_labels = np.full(snap.padded_incidents, UNKNOWN_CLASS, np.int32)
    row_mask = np.zeros(snap.padded_incidents, np.float32)
    pairs: list[tuple[str, int]] = []
    sources: collections.Counter = collections.Counter()
    for r, inc_nid in enumerate(snap.incident_ids):
        # snapshot incident ids are node ids ("incident:<uuid>"); the db
        # keys label rows by the bare uuid
        bare = inc_nid.split(":", 1)[-1]
        hit = labels.get(bare)
        if hit is None:
            continue
        cls, source = hit
        row_labels[r] = cls
        row_mask[r] = 1.0
        pairs.append((inc_nid, cls))
        sources[source] += 1
    if not pairs:
        return None
    batch = gnn.snapshot_batch(snap)
    batch["labels"] = row_labels
    batch["label_mask"] = row_mask
    batch["snapshot"] = snap
    batch["tenant"] = tenant
    h = hashlib.sha256()
    for inc_nid, cls in sorted(pairs):
        h.update(f"{tenant}|{inc_nid}|{cls};".encode())
    batch["fingerprint"] = h.hexdigest()
    batch["label_sources"] = dict(sources)
    return batch


def build_replay_episode(db, labels: dict[str, tuple[int, str]], settings,
                         now_s: "float | None" = None,
                         tenant: str = "default",
                         max_incidents: int = 32) -> "dict | None":
    """Replay CLOSED incidents' windows from the durable store into one
    labeled episode. Labels usually land AFTER the workflow closed the
    incident, and a closed incident is gone from the live evidence graph;
    its evidence rows are not. One fresh GraphBuilder, every labeled
    incident re-ingested from its persisted evidence, then the live-window
    pipeline. Returns None when nothing is replayable."""
    from ..graph import GraphBuilder
    from ..models import CollectorResult, Evidence, Incident
    builder = GraphBuilder()
    replayed = 0
    for iid in sorted(labels):
        if replayed >= max_incidents:
            break
        row = db.get_incident(iid)
        if row is None:
            continue
        ev_rows = db.evidence_for(iid)
        if not ev_rows:
            continue
        inc = Incident.model_validate({k: v for k, v in row.items()
                                       if k in Incident.model_fields})
        evs = [Evidence.model_validate({k: v for k, v in e.items()
                                        if k in Evidence.model_fields})
               for e in ev_rows]
        builder.ingest(inc, [CollectorResult(collector_name="learn_replay",
                                             evidence=evs)])
        replayed += 1
    if not replayed:
        return None
    return build_episode(builder.store, labels, settings, now_s=now_s,
                         tenant=f"{tenant}#replay")


class ReplayBuffer:
    """Bounded, dedup'd FIFO of production episodes.

    Dedup is by episode fingerprint: a steady store re-harvested every
    cycle contributes ONE episode until its labeled set changes. Bounded
    eviction drops the oldest episode.
    """

    def __init__(self, cap: int = 64) -> None:
        self.cap = max(int(cap), 1)
        self._entries: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self.added = 0
        self.duplicates = 0
        self.evicted = 0

    def add(self, episode: dict) -> bool:
        fp = episode["fingerprint"]
        if fp in self._entries:
            self.duplicates += 1
            return False
        self._entries[fp] = episode
        self.added += 1
        while len(self._entries) > self.cap:
            self._entries.popitem(last=False)
            self.evicted += 1
        obs_metrics.LEARN_BUFFER_SIZE.set(float(len(self._entries)))
        for source, n in episode.get("label_sources", {}).items():
            obs_metrics.LEARN_EPISODES_HARVESTED.inc(float(n),
                                                     source=source)
        return True

    def __contains__(self, fingerprint: str) -> bool:
        return fingerprint in self._entries

    def episodes(self) -> list[dict]:
        return list(self._entries.values())

    def __len__(self) -> int:
        return len(self._entries)
