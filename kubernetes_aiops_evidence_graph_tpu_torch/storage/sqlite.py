"""Durable relational store — the Postgres layer reborn on SQLite.

Schema parity with the reference (scripts/init-db.sql:9-147): the same 7
tables — incidents, evidence, hypotheses, remediation_actions,
verification_results, audit_logs, runbooks — incl. the UNIQUE fingerprint
constraint on open incidents (init-db.sql:27) that backs dedup, plus the
updated_at trigger. In-process, thread-safe (one connection per thread via
threading.local), zero external services.

The port's copy of the JAX package's ``storage/sqlite.py``: the same
schema, statements and methods over the port's dataclass models (stdlib
``sqlite3``; no JAX, no pydantic), so a database written by either package
reads the same in the other.
"""
from __future__ import annotations

import json
import sqlite3
import threading
from datetime import datetime
from typing import Any, Optional
from uuid import UUID, uuid4

from ..models import (
    Hypothesis,
    Incident,
    IncidentStatus,
    RemediationAction,
    Runbook,
    VerificationResult,
)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS incidents (
    id TEXT PRIMARY KEY,
    fingerprint TEXT NOT NULL,
    title TEXT NOT NULL,
    description TEXT,
    severity TEXT NOT NULL,
    status TEXT NOT NULL DEFAULT 'open',
    source TEXT NOT NULL,
    cluster TEXT NOT NULL,
    namespace TEXT NOT NULL,
    service TEXT,
    labels TEXT NOT NULL DEFAULT '{}',
    annotations TEXT NOT NULL DEFAULT '{}',
    started_at TEXT NOT NULL,
    acknowledged_at TEXT,
    resolved_at TEXT,
    created_at TEXT NOT NULL DEFAULT (strftime('%Y-%m-%dT%H:%M:%fZ','now')),
    updated_at TEXT NOT NULL DEFAULT (strftime('%Y-%m-%dT%H:%M:%fZ','now'))
);
CREATE UNIQUE INDEX IF NOT EXISTS uq_incidents_fingerprint_open
    ON incidents(fingerprint) WHERE status NOT IN ('resolved','closed');
CREATE INDEX IF NOT EXISTS ix_incidents_status ON incidents(status);
CREATE INDEX IF NOT EXISTS ix_incidents_namespace ON incidents(namespace);
CREATE INDEX IF NOT EXISTS ix_incidents_started ON incidents(started_at);

CREATE TABLE IF NOT EXISTS evidence (
    id TEXT PRIMARY KEY,
    incident_id TEXT NOT NULL REFERENCES incidents(id),
    evidence_type TEXT NOT NULL,
    source TEXT NOT NULL,
    entity_name TEXT NOT NULL,
    entity_namespace TEXT NOT NULL,
    data TEXT NOT NULL DEFAULT '{}',
    summary TEXT,
    signal_strength REAL NOT NULL DEFAULT 0.5,
    is_anomaly INTEGER NOT NULL DEFAULT 0,
    collected_at TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_evidence_incident ON evidence(incident_id);
CREATE INDEX IF NOT EXISTS ix_evidence_type ON evidence(evidence_type);

CREATE TABLE IF NOT EXISTS hypotheses (
    id TEXT PRIMARY KEY,
    incident_id TEXT NOT NULL REFERENCES incidents(id),
    category TEXT NOT NULL,
    title TEXT NOT NULL,
    description TEXT,
    confidence REAL NOT NULL,
    rank INTEGER NOT NULL,
    final_score REAL NOT NULL DEFAULT 0,
    rule_id TEXT,
    backend TEXT NOT NULL DEFAULT 'cpu',
    supporting_evidence_ids TEXT NOT NULL DEFAULT '[]',
    recommended_actions TEXT NOT NULL DEFAULT '[]',
    generated_by TEXT NOT NULL,
    generated_at TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_hypotheses_incident ON hypotheses(incident_id);

CREATE TABLE IF NOT EXISTS remediation_actions (
    id TEXT PRIMARY KEY,
    incident_id TEXT NOT NULL REFERENCES incidents(id),
    hypothesis_id TEXT,
    idempotency_key TEXT NOT NULL UNIQUE,
    action_type TEXT NOT NULL,
    target_resource TEXT NOT NULL,
    target_namespace TEXT NOT NULL,
    parameters TEXT NOT NULL DEFAULT '{}',
    risk_level TEXT NOT NULL,
    blast_radius_score REAL NOT NULL DEFAULT 0,
    environment TEXT NOT NULL,
    status TEXT NOT NULL,
    status_reason TEXT,
    requires_approval INTEGER NOT NULL DEFAULT 1,
    approved_by TEXT,
    executed_at TEXT,
    completed_at TEXT,
    execution_result TEXT,
    error_message TEXT,
    created_at TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_actions_incident ON remediation_actions(incident_id);

CREATE TABLE IF NOT EXISTS verification_results (
    id TEXT PRIMARY KEY,
    action_id TEXT NOT NULL,
    incident_id TEXT NOT NULL,
    success INTEGER NOT NULL,
    metrics_improved INTEGER NOT NULL,
    details TEXT NOT NULL DEFAULT '{}',
    verified_at TEXT NOT NULL
);

CREATE TABLE IF NOT EXISTS audit_logs (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    incident_id TEXT,
    actor TEXT NOT NULL DEFAULT 'system',
    event TEXT NOT NULL,
    detail TEXT NOT NULL DEFAULT '{}',
    at TEXT NOT NULL DEFAULT (strftime('%Y-%m-%dT%H:%M:%fZ','now'))
);

CREATE TABLE IF NOT EXISTS runbooks (
    id TEXT PRIMARY KEY,
    incident_id TEXT NOT NULL,
    hypothesis_id TEXT,
    title TEXT NOT NULL,
    content TEXT NOT NULL DEFAULT '{}',
    generated_at TEXT NOT NULL
);

CREATE TABLE IF NOT EXISTS hypothesis_feedback (
    hypothesis_id TEXT NOT NULL,
    was_correct INTEGER NOT NULL,
    actual_root_cause TEXT,
    feedback_notes TEXT,
    submitted_by TEXT NOT NULL DEFAULT 'unknown',
    submitted_at TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_feedback_hypothesis
    ON hypothesis_feedback(hypothesis_id);

CREATE TABLE IF NOT EXISTS workflow_journal (
    workflow_id TEXT NOT NULL,
    step TEXT NOT NULL,
    status TEXT NOT NULL,
    result TEXT,
    attempts INTEGER NOT NULL DEFAULT 0,
    duration_s REAL,
    updated_at TEXT NOT NULL DEFAULT (strftime('%Y-%m-%dT%H:%M:%fZ','now')),
    lease_owner TEXT,
    lease_deadline REAL,
    lease_token INTEGER NOT NULL DEFAULT 0,
    PRIMARY KEY (workflow_id, step)
);

CREATE TABLE IF NOT EXISTS action_executions (
    idempotency_key TEXT NOT NULL,
    phase TEXT NOT NULL CHECK (phase IN ('intent','result')),
    action_id TEXT,
    incident_id TEXT,
    action_type TEXT,
    status TEXT,
    detail TEXT NOT NULL DEFAULT '{}',
    at TEXT NOT NULL DEFAULT (strftime('%Y-%m-%dT%H:%M:%fZ','now')),
    PRIMARY KEY (idempotency_key, phase)
);
CREATE INDEX IF NOT EXISTS ix_exec_incident ON action_executions(incident_id);

CREATE TRIGGER IF NOT EXISTS trg_incidents_updated
AFTER UPDATE ON incidents FOR EACH ROW
BEGIN
    UPDATE incidents SET updated_at = strftime('%Y-%m-%dT%H:%M:%fZ','now')
    WHERE id = NEW.id;
END;
"""


class DuplicateIncidentError(Exception):
    """Open incident with the same fingerprint already exists."""

    def __init__(self, fingerprint: str, existing_id: str):
        super().__init__(f"duplicate open incident for fingerprint {fingerprint}")
        self.fingerprint = fingerprint
        self.existing_id = existing_id


def _iso(dt: Optional[datetime]) -> Optional[str]:
    return dt.isoformat() if dt else None


# the dedicated journal row the workflow lease rides (filtered out of
# every step-level surface); wall clock because lease deadlines must be
# comparable ACROSS worker processes
_LEASE_STEP = "__lease__"


def _now() -> float:
    import time
    return time.time()  # graft-audit: allow[wall-clock] lease deadlines must be comparable ACROSS worker processes; monotonic clocks are per-process


class Database:
    """SQLite-backed durable store; pass ":memory:" for hermetic tests.

    Note: ":memory:" uses a shared cache URI so every thread sees one DB.
    """

    def __init__(self, path: str = ":memory:") -> None:
        self.path = path
        self._local = threading.local()
        self._lock = threading.RLock()
        # unique per instance: a fixed name would alias every ":memory:"
        # Database in the process onto one shared-cache DB (cross-instance
        # lock collisions; latent bug found via concurrent API tests). Not
        # id(self): a new instance can reuse a freed one's id while a
        # surviving cursor keeps that one's shared cache alive
        self._memory_uri = (
            f"file:kaeg_mem_{uuid4().hex}?mode=memory&cache=shared"
            if path == ":memory:" else None
        )
        # keep one anchoring connection so a shared in-memory DB survives
        self._anchor = self._connect()
        with self._lock:
            self._anchor.executescript(_SCHEMA)
            # migration: pre-round-5 DBs lack duration_s (CREATE TABLE IF
            # NOT EXISTS never alters an existing table). Probe first —
            # an unconditional ALTER takes a write lock on EVERY open,
            # which two contending worker processes can trip over
            cols = {r[1] for r in self._anchor.execute(
                "PRAGMA table_info(workflow_journal)")}
            for col, decl in (
                    ("duration_s", "duration_s REAL"),
                    # graft-saga lease/heartbeat columns: the lease rides
                    # a dedicated (workflow_id, '__lease__') row
                    ("lease_owner", "lease_owner TEXT"),
                    ("lease_deadline", "lease_deadline REAL"),
                    ("lease_token",
                     "lease_token INTEGER NOT NULL DEFAULT 0")):
                if col not in cols:
                    try:
                        self._anchor.execute(
                            f"ALTER TABLE workflow_journal ADD COLUMN {decl}")
                    except sqlite3.OperationalError:
                        pass  # a racing migrator added it first
            self._anchor.commit()

    def _connect(self) -> sqlite3.Connection:
        if self._memory_uri:
            conn = sqlite3.connect(self._memory_uri, uri=True, check_same_thread=False)
        else:
            conn = sqlite3.connect(self.path, check_same_thread=False,
                                   timeout=30.0)
        conn.row_factory = sqlite3.Row
        conn.execute("PRAGMA foreign_keys=ON")
        if not self._memory_uri:
            # multi-process mode (the Temporal-worker scale-out analog,
            # reference worker.py:31-73): WAL lets concurrent worker
            # processes interleave reads with one writer; writer collisions
            # block-retry for the connect(timeout=30) busy window instead
            # of raising "database is locked" (tests/test_multiprocess.py)
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=NORMAL")
        return conn

    @property
    def conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._local.conn = self._connect()
        return conn

    def execute(self, sql: str, params: tuple = ()) -> sqlite3.Cursor:
        with self._lock:
            cur = self.conn.execute(sql, params)
            self.conn.commit()
            return cur

    def query(self, sql: str, params: tuple = ()) -> list[sqlite3.Row]:
        with self._lock:
            return self.conn.execute(sql, params).fetchall()

    # -- incidents --------------------------------------------------------

    def create_incident(self, incident: Incident) -> Incident:
        """INSERT honoring the open-fingerprint uniqueness (dedup backstop,
        reference init-db.sql:27 + main.py:345-398)."""
        try:
            self.execute(
                "INSERT INTO incidents (id, fingerprint, title, description, severity,"
                " status, source, cluster, namespace, service, labels, annotations,"
                " started_at, created_at, updated_at)"
                " VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
                (str(incident.id), incident.fingerprint, incident.title,
                 incident.description, incident.severity.value, incident.status.value,
                 incident.source.value, incident.cluster, incident.namespace,
                 incident.service, json.dumps(incident.labels),
                 json.dumps(incident.annotations), _iso(incident.started_at),
                 _iso(incident.created_at), _iso(incident.updated_at)),
            )
        except sqlite3.IntegrityError:
            row = self.query(
                "SELECT id FROM incidents WHERE fingerprint=? AND status NOT IN"
                " ('resolved','closed') LIMIT 1", (incident.fingerprint,))
            if not row:  # some other constraint failed — not a dedup hit
                raise
            raise DuplicateIncidentError(incident.fingerprint, row[0]["id"])
        self.audit(str(incident.id), "incident_created",
                   {"severity": incident.severity.value})
        return incident

    def get_incident(self, incident_id: UUID | str) -> Optional[dict]:
        rows = self.query("SELECT * FROM incidents WHERE id=?", (str(incident_id),))
        return _incident_row(rows[0]) if rows else None

    def list_incidents(
        self,
        status: str | None = None,
        namespace: str | None = None,
        severity: str | None = None,
        limit: int = 100,
        offset: int = 0,
    ) -> list[dict]:
        sql = "SELECT * FROM incidents"
        conds, params = [], []
        for col, val in (("status", status), ("namespace", namespace), ("severity", severity)):
            if val is not None:
                conds.append(f"{col}=?")
                params.append(val)
        if conds:
            sql += " WHERE " + " AND ".join(conds)
        sql += " ORDER BY started_at DESC LIMIT ? OFFSET ?"
        params += [limit, offset]
        return [_incident_row(r) for r in self.query(sql, tuple(params))]

    def update_incident_status(self, incident_id: UUID | str, status: IncidentStatus,
                               resolved_at: datetime | None = None) -> None:
        self.execute(
            "UPDATE incidents SET status=?, resolved_at=COALESCE(?, resolved_at)"
            " WHERE id=?",
            (status.value, _iso(resolved_at), str(incident_id)))
        self.audit(str(incident_id), "status_change", {"status": status.value})

    def open_incident_ids(self) -> list[str]:
        return [r["id"] for r in self.query(
            "SELECT id FROM incidents WHERE status NOT IN ('resolved','closed')"
            " ORDER BY started_at")]

    # -- evidence / hypotheses -------------------------------------------

    def insert_evidence(self, items: list) -> int:
        with self._lock:
            self.conn.executemany(
                "INSERT OR REPLACE INTO evidence (id, incident_id, evidence_type,"
                " source, entity_name, entity_namespace, data, summary,"
                " signal_strength, is_anomaly, collected_at)"
                " VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                [(str(e.id), str(e.incident_id), e.evidence_type.value,
                  e.source.value, e.entity_name, e.entity_namespace,
                  json.dumps(e.data, default=str), e.summary, e.signal_strength,
                  int(e.is_anomaly), _iso(e.collected_at)) for e in items])
            self.conn.commit()
        return len(items)

    def evidence_for(self, incident_id: UUID | str) -> list[dict]:
        return [
            {**dict(r), "data": json.loads(r["data"]),
             "is_anomaly": bool(r["is_anomaly"])}
            for r in self.query(
                "SELECT * FROM evidence WHERE incident_id=? ORDER BY collected_at",
                (str(incident_id),))
        ]

    def insert_hypotheses(self, items: list[Hypothesis]) -> int:
        with self._lock:
            self.conn.execute(
                "DELETE FROM hypotheses WHERE incident_id=?",
                (str(items[0].incident_id),)) if items else None
            self.conn.executemany(
                "INSERT INTO hypotheses (id, incident_id, category, title,"
                " description, confidence, rank, final_score, rule_id, backend,"
                " supporting_evidence_ids, recommended_actions, generated_by,"
                " generated_at) VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
                [(str(h.id), str(h.incident_id), h.category.value, h.title,
                  h.description, h.confidence, h.rank, h.final_score, h.rule_id,
                  h.backend, json.dumps([str(x) for x in h.supporting_evidence_ids]),
                  json.dumps(h.recommended_actions), h.generated_by.value,
                  _iso(h.generated_at)) for h in items])
            self.conn.commit()
        return len(items)

    def hypotheses_for(self, incident_id: UUID | str) -> list[dict]:
        return [
            {**dict(r),
             "supporting_evidence_ids": json.loads(r["supporting_evidence_ids"]),
             "recommended_actions": json.loads(r["recommended_actions"])}
            for r in self.query(
                "SELECT * FROM hypotheses WHERE incident_id=? ORDER BY rank",
                (str(incident_id),))
        ]

    def insert_feedback(self, fb) -> bool:
        """Record operator feedback on a hypothesis (HypothesisFeedback —
        the model the reference defines but never persists,
        hypothesis.py:169-176). Existence check and insert are ONE
        statement: a separate check-then-act would race the worker thread's
        re-analysis (insert_hypotheses deletes + re-inserts rows with fresh
        ids) and leave orphan feedback. Returns False when the hypothesis
        is unknown."""
        with self._lock:
            cur = self.conn.execute(
                "INSERT INTO hypothesis_feedback (hypothesis_id, was_correct,"
                " actual_root_cause, feedback_notes, submitted_by,"
                " submitted_at) SELECT ?,?,?,?,?,? WHERE EXISTS"
                " (SELECT 1 FROM hypotheses WHERE id=?)",
                (str(fb.hypothesis_id), int(fb.was_correct),
                 fb.actual_root_cause, fb.feedback_notes, fb.submitted_by,
                 fb.submitted_at.isoformat(), str(fb.hypothesis_id)))
            self.conn.commit()
            return cur.rowcount > 0

    def feedback_for(self, hypothesis_id: UUID | str) -> list[dict]:
        return [dict(r) for r in self.query(
            "SELECT * FROM hypothesis_feedback WHERE hypothesis_id=?"
            " ORDER BY submitted_at", (str(hypothesis_id),))]

    # -- actions / verifications / runbooks ------------------------------

    def upsert_action(self, a: RemediationAction) -> None:
        self.execute(
            "INSERT INTO remediation_actions (id, incident_id, hypothesis_id,"
            " idempotency_key, action_type, target_resource, target_namespace,"
            " parameters, risk_level, blast_radius_score, environment, status,"
            " status_reason, requires_approval, approved_by, executed_at,"
            " completed_at, execution_result, error_message, created_at)"
            " VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)"
            " ON CONFLICT(idempotency_key) DO UPDATE SET status=excluded.status,"
            " status_reason=excluded.status_reason, approved_by=excluded.approved_by,"
            " executed_at=excluded.executed_at, completed_at=excluded.completed_at,"
            " execution_result=excluded.execution_result,"
            " error_message=excluded.error_message",
            (str(a.id), str(a.incident_id),
             str(a.hypothesis_id) if a.hypothesis_id else None,
             a.idempotency_key, a.action_type.value, a.target_resource,
             a.target_namespace, json.dumps(a.parameters, default=str),
             a.risk_level.value, a.blast_radius_score, a.environment.value,
             a.status.value, a.status_reason, int(a.requires_approval),
             a.approved_by, _iso(a.executed_at), _iso(a.completed_at),
             json.dumps(a.execution_result, default=str) if a.execution_result else None,
             a.error_message, _iso(a.created_at)))

    def actions_for(self, incident_id: UUID | str) -> list[dict]:
        return [dict(r) for r in self.query(
            "SELECT * FROM remediation_actions WHERE incident_id=? ORDER BY created_at",
            (str(incident_id),))]

    def insert_verification(self, v: VerificationResult) -> None:
        self.execute(
            "INSERT INTO verification_results (id, action_id, incident_id, success,"
            " metrics_improved, details, verified_at) VALUES (?,?,?,?,?,?,?)",
            (str(v.id), str(v.action_id), str(v.incident_id), int(v.success),
             int(v.metrics_improved),
             json.dumps(v.verification_details, default=str), _iso(v.verified_at)))

    def insert_runbook(self, r: Runbook) -> None:
        self.execute(
            "INSERT OR REPLACE INTO runbooks (id, incident_id, hypothesis_id, title,"
            " content, generated_at) VALUES (?,?,?,?,?,?)",
            (str(r.id), str(r.incident_id),
             str(r.hypothesis_id) if r.hypothesis_id else None,
             r.title, r.model_dump_json(), _iso(r.generated_at)))

    def runbook_for(self, incident_id: UUID | str) -> Optional[dict]:
        rows = self.query(
            "SELECT content FROM runbooks WHERE incident_id=?"
            " ORDER BY generated_at DESC LIMIT 1", (str(incident_id),))
        return json.loads(rows[0]["content"]) if rows else None

    # -- audit / journal --------------------------------------------------

    def audit(self, incident_id: str | None, event: str,
              detail: dict[str, Any] | None = None) -> None:
        self.execute(
            "INSERT INTO audit_logs (incident_id, event, detail) VALUES (?,?,?)",
            (incident_id, event, json.dumps(detail or {}, default=str)))

    def audit_for(self, incident_id: UUID | str) -> list[dict]:
        return [dict(r) for r in self.query(
            "SELECT * FROM audit_logs WHERE incident_id=? ORDER BY id",
            (str(incident_id),))]

    def journal_get(self, workflow_id: str) -> dict[str, dict]:
        return {
            r["step"]: {"status": r["status"],
                        "result": json.loads(r["result"]) if r["result"] else None,
                        "attempts": r["attempts"],
                        "duration_s": r["duration_s"],
                        "updated_at": r["updated_at"]}
            for r in self.query(
                "SELECT * FROM workflow_journal WHERE workflow_id=?"
                f" AND step != '{_LEASE_STEP}'", (workflow_id,))
        }

    def journal_put(self, workflow_id: str, step: str, status: str,
                    result: Any = None, attempts: int = 0,
                    duration_s: float | None = None) -> None:
        self.execute(
            "INSERT INTO workflow_journal (workflow_id, step, status, result,"
            " attempts, duration_s)"
            " VALUES (?,?,?,?,?,?)"
            " ON CONFLICT(workflow_id, step) DO UPDATE SET status=excluded.status,"
            " result=excluded.result, attempts=excluded.attempts,"
            " duration_s=COALESCE(excluded.duration_s, duration_s),"
            " updated_at=strftime('%Y-%m-%dT%H:%M:%fZ','now')",
            (workflow_id, step, status,
             json.dumps(result, default=str) if result is not None else None,
             attempts, duration_s))

    @staticmethod
    def rollup_state(failed: int, running: int, completed: int) -> str:
        """Single encoding of the workflow state precedence (failed >
        running > completed > pending) — shared by the listing SQL rollup,
        the API timeline, and engine.status (code-review r5)."""
        return ("failed" if failed else "running" if running
                else "completed" if completed else "pending")

    def journal_workflows(self, limit: int = 200) -> list[dict]:
        """Workflow listing for the inspection surface (the Temporal-UI
        analog, VERDICT r4 item 8): one row per workflow with step-status
        rollup, ordered most-recently-active first."""
        rows = self.query(
            "SELECT workflow_id,"
            " COUNT(*) AS steps,"
            " SUM(status='completed') AS completed,"
            " SUM(status='failed') AS failed,"
            " SUM(status='running') AS running,"
            " SUM(status='skipped') AS skipped,"
            " SUM(COALESCE(duration_s, 0)) AS total_duration_s,"
            " MIN(updated_at) AS first_update,"
            " MAX(updated_at) AS last_update"
            f" FROM workflow_journal WHERE step != '{_LEASE_STEP}'"
            " GROUP BY workflow_id"
            " ORDER BY last_update DESC LIMIT ?", (limit,))
        out = []
        for r in rows:
            d = dict(r)
            d["state"] = self.rollup_state(d["failed"], d["running"],
                                           d["completed"])
            out.append(d)
        return out

    # -- workflow leases (graft-saga) -------------------------------------
    # The lease rides a dedicated (workflow_id, '__lease__') journal row
    # using the lease_* columns: lease_owner/lease_deadline are the live
    # claim, lease_token is a fencing token that increments on every
    # acquisition (so it doubles as the resume count). All comparisons
    # use wall-clock time.time() — the only clock two worker PROCESSES
    # share.

    def lease_acquire(self, workflow_id: str, owner: str, ttl_s: float,
                      now: float | None = None) -> Optional[int]:
        """Atomically claim the workflow lease. Returns the fencing token
        when acquired, None while another owner's lease is live."""
        now = _now() if now is None else now
        with self._lock:
            self.conn.execute(
                "INSERT INTO workflow_journal (workflow_id, step, status,"
                " lease_owner, lease_deadline, lease_token)"
                " VALUES (?,?, 'lease', ?, ?, 1)"
                " ON CONFLICT(workflow_id, step) DO UPDATE SET"
                " lease_owner=excluded.lease_owner,"
                " lease_deadline=excluded.lease_deadline,"
                " lease_token=workflow_journal.lease_token+1,"
                " updated_at=strftime('%Y-%m-%dT%H:%M:%fZ','now')"
                " WHERE workflow_journal.lease_deadline IS NULL"
                "    OR workflow_journal.lease_deadline < ?",
                (workflow_id, _LEASE_STEP, owner, now + ttl_s, now))
            self.conn.commit()
            row = self.conn.execute(
                "SELECT lease_owner, lease_token FROM workflow_journal"
                " WHERE workflow_id=? AND step=?",
                (workflow_id, _LEASE_STEP)).fetchone()
        if row is not None and row["lease_owner"] == owner:
            return int(row["lease_token"])
        return None

    def lease_heartbeat(self, workflow_id: str, owner: str, token: int,
                        ttl_s: float, now: float | None = None) -> bool:
        """Extend the lease iff (owner, token) still hold it — False means
        the caller has been FENCED (the lease expired and someone else
        reclaimed it) and must stop driving the workflow."""
        now = _now() if now is None else now
        cur = self.execute(
            "UPDATE workflow_journal SET lease_deadline=?"
            " WHERE workflow_id=? AND step=? AND lease_owner=?"
            " AND lease_token=?",
            (now + ttl_s, workflow_id, _LEASE_STEP, owner, token))
        return cur.rowcount > 0

    def lease_release(self, workflow_id: str, owner: str, token: int) -> bool:
        """Clear the claim (owner/deadline NULL); the token stays as the
        monotonic acquisition count. Owner+token matched, so a fenced
        zombie releasing late is a no-op."""
        cur = self.execute(
            "UPDATE workflow_journal SET lease_owner=NULL,"
            " lease_deadline=NULL"
            " WHERE workflow_id=? AND step=? AND lease_owner=?"
            " AND lease_token=?",
            (workflow_id, _LEASE_STEP, owner, token))
        return cur.rowcount > 0

    def lease_view(self, workflow_id: str) -> Optional[dict]:
        rows = self.query(
            "SELECT lease_owner, lease_deadline, lease_token, updated_at"
            " FROM workflow_journal WHERE workflow_id=? AND step=?",
            (workflow_id, _LEASE_STEP))
        if not rows:
            return None
        r = rows[0]
        return {"owner": r["lease_owner"], "deadline": r["lease_deadline"],
                "token": r["lease_token"], "updated_at": r["updated_at"]}

    def orphaned_incidents(self, max_resumes: int = 5,
                           now: float | None = None) -> list[dict]:
        """Open incidents whose workflow lease EXPIRED (worker died
        mid-run: the deadline is non-NULL and past) with no failed steps
        and resume budget left — the resumer sweep re-enters these
        through the journal-replay path. A clean release NULLs the
        deadline, so legitimately finished or failed runs never match."""
        now = _now() if now is None else now
        return [{**_incident_row(r), "resumes": r["resumes"]}
                for r in self.query(
            "SELECT i.*, l.lease_token AS resumes FROM incidents i"
            " JOIN workflow_journal l ON l.workflow_id = 'incident-' || i.id"
            f" AND l.step = '{_LEASE_STEP}'"
            " WHERE i.status IN ('investigating','remediating')"
            " AND l.lease_deadline IS NOT NULL AND l.lease_deadline < ?"
            " AND l.lease_token < ?"
            " AND NOT EXISTS (SELECT 1 FROM workflow_journal f"
            "  WHERE f.workflow_id = l.workflow_id AND f.status='failed')",
            (now, max_resumes))]

    def stalled_workflows(self, max_resumes: int = 5,
                          now: float | None = None) -> list[dict]:
        """Workflows an operator must look at: the incident is still open
        but the journal carries a failed step, or the resume budget is
        exhausted. Surfaced by GET /api/v1/workflows and stamped into the
        aiops_workflow_stalled gauge."""
        now = _now() if now is None else now
        rows = self.query(
            "SELECT DISTINCT j.workflow_id, i.id AS incident_id,"
            " CASE WHEN EXISTS (SELECT 1 FROM workflow_journal f"
            "   WHERE f.workflow_id = j.workflow_id AND f.status='failed')"
            "  THEN 'step_failed' ELSE 'resume_budget' END AS reason"
            " FROM workflow_journal j"
            " JOIN incidents i ON j.workflow_id = 'incident-' || i.id"
            " WHERE i.status NOT IN ('resolved','closed')"
            " AND (EXISTS (SELECT 1 FROM workflow_journal f"
            "   WHERE f.workflow_id = j.workflow_id AND f.status='failed')"
            f"  OR (j.step = '{_LEASE_STEP}' AND j.lease_token >= ?"
            "   AND j.lease_deadline IS NOT NULL AND j.lease_deadline < ?))",
            (max_resumes, now))
        return [dict(r) for r in rows]

    # -- action execution ledger (graft-saga two-phase execute) -----------

    def execution_intent(self, idempotency_key: str, action_id: str,
                         incident_id: str, action_type: str,
                         detail: dict | None = None) -> bool:
        """Journal the INTENT to mutate the cluster — written (and
        fsync'd by SQLite) BEFORE the dispatch. Returns False when an
        intent already exists (resume path). The detail carries whatever
        reconciliation will need: the pre-action probe and the captured
        verification baseline."""
        with self._lock:
            cur = self.conn.execute(
                "INSERT OR IGNORE INTO action_executions (idempotency_key,"
                " phase, action_id, incident_id, action_type, detail)"
                " VALUES (?, 'intent', ?, ?, ?, ?)",
                (idempotency_key, action_id, incident_id, action_type,
                 json.dumps(detail or {}, default=str)))
            self.conn.commit()
            return cur.rowcount > 0

    def execution_result(self, idempotency_key: str, status: str,
                         detail: dict | None = None) -> None:
        """Journal the outcome of a dispatched (or reconciled) execution;
        idempotent upsert so a replayed commit is harmless."""
        self.execute(
            "INSERT INTO action_executions (idempotency_key, phase, status,"
            " detail) VALUES (?, 'result', ?, ?)"
            " ON CONFLICT(idempotency_key, phase) DO UPDATE SET"
            " status=excluded.status, detail=excluded.detail",
            (idempotency_key, status, json.dumps(detail or {}, default=str)))

    def execution_state(self, idempotency_key: str) -> dict:
        """{'intent': row|None, 'result': row|None} — intent without
        result == IN-DOUBT (crashed between mutation and commit): the
        caller must reconcile against cluster state, never re-fire."""
        out: dict[str, Any] = {"intent": None, "result": None}
        for r in self.query(
                "SELECT * FROM action_executions WHERE idempotency_key=?",
                (idempotency_key,)):
            out[r["phase"]] = {**dict(r), "detail": json.loads(r["detail"])}
        return out

    def in_doubt_executions(self) -> list[dict]:
        return [
            {**dict(r), "detail": json.loads(r["detail"])}
            for r in self.query(
                "SELECT * FROM action_executions i WHERE phase='intent'"
                " AND NOT EXISTS (SELECT 1 FROM action_executions r"
                "  WHERE r.idempotency_key = i.idempotency_key"
                "  AND r.phase='result')")]

    def close(self) -> None:
        with self._lock:
            conn = getattr(self._local, "conn", None)
            if conn is not None:
                conn.close()
                self._local.conn = None
            self._anchor.close()


def _incident_row(r: sqlite3.Row) -> dict:
    d = dict(r)
    d["labels"] = json.loads(d.get("labels") or "{}")
    d["annotations"] = json.loads(d.get("annotations") or "{}")
    return d
