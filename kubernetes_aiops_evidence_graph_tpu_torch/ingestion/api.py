"""HTTP API — webhooks, incidents, graph, approvals, health, metrics.

Route parity with the reference FastAPI app (ingestion/main.py:65-425):
POST /api/v1/webhooks/{alertmanager,grafana}, incident CRUD + listing with
filters, the incident graph endpoint (depth-limited subgraph), /health,
/health/ready and /metrics — plus the approvals endpoints the reference
lacked (its Slack approval flow had no response path, SURVEY.md §3.6
item 8). Built on the stdlib ThreadingHTTPServer: no FastAPI/uvicorn in
this image, and the ingestion edge is not the hot path — the scorer on
the card is. The served entrypoint is
`python -m kubernetes_aiops_evidence_graph_tpu_torch.serve`.

The port's copy of the JAX package's API: the same routes, bodies and
status codes. Request bodies are checked by the dataclass models' own
validation (a ``TypeError``/``ValueError`` answers 400 where pydantic's
``ValidationError`` did), and the blast map runs on the app's device.
"""
from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable
from urllib.parse import parse_qs, urlparse

from ..models import IncidentStatus
from ..observability import (
    ALERTS_DEDUPLICATED,
    ALERTS_RECEIVED,
    INCIDENTS_CREATED,
    REGISTRY,
    TRACER,
    WEBHOOK_LATENCY,
    get_logger,
)
from ..observability.scope import FLIGHT_RECORDER, SCOPE
from ..storage import DuplicateIncidentError

log = get_logger("api")

_ROUTES: list[tuple[str, re.Pattern, str]] = []  # (method, pattern, handler name)


def route(method: str, pattern: str):
    def deco(fn):
        _ROUTES.append((method, re.compile(f"^{pattern}$"), fn.__name__))
        return fn
    return deco


class ApiHandler(BaseHTTPRequestHandler):
    app: "Any" = None  # set by make_server

    # -- plumbing ---------------------------------------------------------

    def log_message(self, fmt, *args):  # silence default stderr spam
        pass

    def _json(self, status: int, payload: Any,
              headers: "dict[str, str] | None" = None) -> None:
        body = json.dumps(payload, default=str).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _text(self, status: int, text: str, content_type="text/plain") -> None:
        body = text.encode()
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        if not length:
            return {}
        try:
            return json.loads(self.rfile.read(length))
        except json.JSONDecodeError:
            return {}

    def _dispatch(self, method: str) -> None:
        parsed = urlparse(self.path)
        self.query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        for m, pattern, name in _ROUTES:
            if m != method:
                continue
            match = pattern.match(parsed.path)
            if match:
                try:
                    getattr(self, name)(**match.groupdict())
                except Exception as exc:  # graft-audit: allow[broad-except] HTTP boundary: handler errors become a 500, server stays up
                    log.error("handler_error", path=parsed.path, error=str(exc))
                    self._json(500, {"error": str(exc)})
                return
        self._json(404, {"error": f"no route {method} {parsed.path}"})

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_PATCH(self):
        self._dispatch("PATCH")

    # -- health & metrics (main.py:83-112) --------------------------------

    @route("GET", "/health")
    def health(self):
        self._json(200, {"status": "healthy", "service": self.app.settings.app_name})

    @route("GET", "/health/ready")
    def ready(self):
        ok = self.app.ready()
        self._json(200 if ok else 503, {"ready": ok})

    @route("GET", "/metrics")
    def metrics(self):
        self._text(200, REGISTRY.expose(), "text/plain; version=0.0.4")

    # -- webhooks (main.py:116-254) ---------------------------------------
    #
    # graft-intake: with settings.ingest_columnar the batch rides the
    # vectorized columnar pipeline (ingestion/columnar.py — one payload
    # transpose, array-op normalize, batch dedup probe, pydantic only for
    # survivors; malformed rows masked + counted, never a 500). The
    # per-row dict path below each handler is the behavioral oracle.

    def _columnar_webhook(self, source: str, normalize, t_parse: float):
        """Shared columnar handler tail: normalize → batch ingest →
        per-stage aiops_ingest_* accounting. ``t_parse`` is the JSON
        parse wall already spent in ``_body``. Returns the
        :class:`~..app.IngestBatchResult` — the caller renders the
        response (200 with shed accounting, or a full-shed 429 with
        Retry-After)."""
        from ..observability.metrics import (
            INGEST_BATCH_FILL, INGEST_MALFORMED_ROWS, INGEST_ROWS,
            INGEST_ROWS_PER_SEC, INGEST_STAGE_SECONDS)
        t1 = time.perf_counter()
        cols = normalize()
        t2 = time.perf_counter()
        res = self.app.ingest_batch(cols)
        t3 = time.perf_counter()
        n = len(cols)
        ALERTS_RECEIVED.inc(float(n), source=source)
        for iid, ns in res.created:
            SCOPE.webhook_received(iid, tenant=ns or "default")
        INGEST_STAGE_SECONDS.observe(t_parse, stage="parse", source=source)
        INGEST_STAGE_SECONDS.observe(t2 - t1, stage="normalize",
                                     source=source)
        # dedup probe + admission gate + spec construction + DB insert
        # ride ingest_batch; the probe/gate are a handful of vectorized
        # compares, so the window is reported as one "persist" stage with
        # dedup hits / sheds counted separately
        INGEST_STAGE_SECONDS.observe(t3 - t2, stage="persist",
                                     source=source)
        if n:
            eligible = int(cols.eligible.sum())
            INGEST_ROWS.inc(float(len(res.created)), source=source,
                            outcome="created")
            INGEST_ROWS.inc(float(res.duplicates), source=source,
                            outcome="duplicate")
            INGEST_ROWS.inc(float(n - cols.malformed - eligible),
                            source=source, outcome="not_firing")
            for outcome, count in (("shed", res.shed),
                                   ("storm_sampled", res.sampled),
                                   ("spilled", res.spilled)):
                if count:
                    INGEST_ROWS.inc(float(count), source=source,
                                    outcome=outcome)
            if cols.malformed:
                INGEST_ROWS.inc(float(cols.malformed), source=source,
                                outcome="malformed")
                INGEST_MALFORMED_ROWS.inc(float(cols.malformed),
                                          source=source)
            INGEST_BATCH_FILL.set(eligible / n, site="webhook")
            wall = t_parse + (t3 - t1)
            if wall > 0:
                INGEST_ROWS_PER_SEC.set(n / wall, source=source)
        return res

    def _rate_limited(self) -> None:
        """Legacy fixed-window 429 — now with Retry-After (time to the
        next window), the header the reference limiter never sent."""
        retry = self.app.rate_limiter.retry_after_s()
        self._json(429, {"error": "rate limit exceeded",
                         "retry_after_s": round(retry, 1)},
                   headers={"Retry-After": str(max(int(retry + 0.5), 1))})

    def _columnar_response(self, res, endpoint: str, t0: float) -> None:
        """Render one columnar ingest result. A batch whose every
        admission-eligible row was shed answers 429 + Retry-After
        (token-bucket refill time); partial sheds answer 200 with exact
        accounting plus the advisory Retry-After header."""
        WEBHOOK_LATENCY.observe(time.perf_counter() - t0,
                                endpoint=endpoint)
        headers = {}
        if res.retry_after_s > 0:
            headers["Retry-After"] = str(max(int(res.retry_after_s + 0.5),
                                             1))
        body = {"created": [iid for iid, _ns in res.created],
                "duplicates": res.duplicates}
        for k in ("shed", "sampled", "spilled"):
            if getattr(res, k):
                body[k] = getattr(res, k)
        if res.shed and not res.created and not res.duplicates \
                and not res.sampled:
            self._json(429, {"error": "admission shed", **body},
                       headers=headers)
            return
        self._json(200, body, headers=headers)

    @route("POST", "/api/v1/webhooks/alertmanager")
    def webhook_alertmanager(self):
        from .normalizer import AlertNormalizer
        t0 = time.perf_counter()
        client = self.client_address[0] if self.client_address else "unknown"
        # graft-storm: the columnar path is gated by the severity-aware
        # per-tenant admission controller inside ingest_batch — the
        # per-client fixed window only guards the dict-path oracle
        if getattr(self.app, "admission", None) is None and \
                not self.app.rate_limiter.check_rate_limit(client):
            self._rate_limited()
            return
        payload = self._body()
        t_parse = time.perf_counter() - t0
        alerts = payload.get("alerts", []) or []
        if not isinstance(alerts, list):
            self._json(400, {"error": "alerts must be a list of alert objects"})
            return
        # graft-scope: the webhook span is the ROOT of the incident's
        # trace — ServeScope carries its context to the async workflow
        # (workflow/engine.py parents every step span under it) and
        # stamps the arrival time the webhook→verdict SLO measures from
        if getattr(self.app.settings, "ingest_columnar", False):
            from .columnar import normalize_alertmanager_batch
            with TRACER.span("webhook.alertmanager", alerts=len(alerts)):
                res = self._columnar_webhook(
                    "alertmanager",
                    lambda: normalize_alertmanager_batch(alerts), t_parse)
            self._columnar_response(res, "alertmanager", t0)
            return
        if any(not isinstance(a, dict) for a in alerts):
            self._json(400, {"error": "alerts must be a list of alert objects"})
            return
        created, duplicates = [], 0
        with TRACER.span("webhook.alertmanager", alerts=len(alerts)):
            for alert in alerts:
                ALERTS_RECEIVED.inc(source="alertmanager")
                if alert.get("status") != "firing":   # main.py:146-147
                    continue
                spec = AlertNormalizer.normalize_alertmanager(alert)
                incident_id = self.app.ingest(spec)
                if incident_id is None:
                    duplicates += 1
                else:
                    created.append(incident_id)
                    SCOPE.webhook_received(
                        incident_id, tenant=spec.namespace or "default")
        WEBHOOK_LATENCY.observe(time.perf_counter() - t0, endpoint="alertmanager")
        self._json(200, {"created": created, "duplicates": duplicates})

    @route("POST", "/api/v1/webhooks/grafana")
    def webhook_grafana(self):
        from .normalizer import AlertNormalizer
        t0 = time.perf_counter()
        client = self.client_address[0] if self.client_address else "unknown"
        if getattr(self.app, "admission", None) is None and \
                not self.app.rate_limiter.check_rate_limit(client):
            self._rate_limited()
            return
        payload = self._body()
        t_parse = time.perf_counter() - t0
        if getattr(self.app.settings, "ingest_columnar", False):
            from .columnar import normalize_grafana_batch
            with TRACER.span("webhook.grafana"):
                res = self._columnar_webhook(
                    "grafana",
                    lambda: normalize_grafana_batch(payload), t_parse)
            self._columnar_response(res, "grafana", t0)
            return
        created, duplicates = [], 0
        with TRACER.span("webhook.grafana"):
            for spec in AlertNormalizer.normalize_grafana(payload):
                ALERTS_RECEIVED.inc(source="grafana")
                incident_id = self.app.ingest(spec)
                if incident_id is None:
                    duplicates += 1
                else:
                    created.append(incident_id)
                    SCOPE.webhook_received(
                        incident_id, tenant=spec.namespace or "default")
        WEBHOOK_LATENCY.observe(time.perf_counter() - t0, endpoint="grafana")
        self._json(200, {"created": created, "duplicates": duplicates})

    # -- incidents (main.py:256-342) --------------------------------------

    @route("GET", "/api/v1/incidents")
    def list_incidents(self):
        try:
            limit = int(self.query.get("limit", 100))
            offset = int(self.query.get("offset", 0))
        except ValueError:
            self._json(400, {"error": "limit/offset must be integers"})
            return
        rows = self.app.db.list_incidents(
            status=self.query.get("status"),
            namespace=self.query.get("namespace"),
            severity=self.query.get("severity"),
            limit=limit,
            offset=offset,
        )
        self._json(200, {"incidents": rows, "count": len(rows)})

    @route("GET", r"/api/v1/incidents/(?P<incident_id>[0-9a-f-]+)")
    def get_incident(self, incident_id: str):
        row = self.app.db.get_incident(incident_id)
        if row is None:
            self._json(404, {"error": "incident not found"})
        else:
            self._json(200, row)

    @route("PATCH", r"/api/v1/incidents/(?P<incident_id>[0-9a-f-]+)")
    def patch_incident(self, incident_id: str):
        body = self._body()
        status = body.get("status")
        if status not in {s.value for s in IncidentStatus}:
            self._json(400, {"error": f"invalid status {status!r}"})
            return
        from ..utils.timeutils import utcnow
        resolved_at = (utcnow() if status in ("resolved", "closed") else None)
        self.app.db.update_incident_status(
            incident_id, IncidentStatus(status), resolved_at=resolved_at)
        self._json(200, self.app.db.get_incident(incident_id))

    @route("GET", r"/api/v1/incidents/(?P<incident_id>[0-9a-f-]+)/graph")
    def incident_graph(self, incident_id: str):
        depth = int(self.query.get("depth", 3))  # main.py:303 default depth=3
        self._json(200, self.app.store.get_incident_subgraph(incident_id, depth=depth))

    @route("GET", r"/api/v1/incidents/(?P<incident_id>[0-9a-f-]+)/blast-propagation")
    def incident_blast_propagation(self, incident_id: str):
        """Device-computed blast map: k-hop reach bound + label-propagation
        ranking over the tensorized graph (rca/blast.py), on the app's
        device."""
        from ..rca.blast import blast_propagation
        out = blast_propagation(
            self.app.store, incident_id,
            settings=self.app.settings,
            hops=int(self.query.get("hops", 3)),
            iterations=int(self.query.get("iterations", 3)),
            top_k=int(self.query.get("top_k", 25)),
            device=self.app.device,
        )
        if out is None:
            self._json(404, {"error": "incident not in graph",
                             "incident_id": incident_id})
            return
        self._json(200, out)

    @route("GET", r"/api/v1/incidents/(?P<incident_id>[0-9a-f-]+)/evidence")
    def incident_evidence(self, incident_id: str):
        self._json(200, {"evidence": self.app.db.evidence_for(incident_id)})

    @route("GET", r"/api/v1/incidents/(?P<incident_id>[0-9a-f-]+)/hypotheses")
    def incident_hypotheses(self, incident_id: str):
        self._json(200, {"hypotheses": self.app.db.hypotheses_for(incident_id)})

    @route("GET", r"/api/v1/incidents/(?P<incident_id>[0-9a-f-]+)/runbook")
    def incident_runbook(self, incident_id: str):
        rb = self.app.db.runbook_for(incident_id)
        if rb is None:
            self._json(404, {"error": "no runbook"})
        else:
            self._json(200, rb)

    @route("GET", r"/api/v1/incidents/(?P<incident_id>[0-9a-f-]+)/actions")
    def incident_actions(self, incident_id: str):
        self._json(200, {"actions": self.app.db.actions_for(incident_id)})

    @route("GET", r"/api/v1/incidents/(?P<incident_id>[0-9a-f-]+)/status")
    def incident_workflow_status(self, incident_id: str):
        self._json(200, self.app.workflow_status(incident_id))

    # -- approvals (new; closes the reference's approval gap) -------------

    @route("GET", "/api/v1/approvals")
    def list_approvals(self):
        from ..integrations import BROKER
        self._json(200, {"pending": [r.model_dump(mode="json")
                                     for r in BROKER.pending()]})

    @route("POST", r"/api/v1/approvals/(?P<action_id>[0-9a-f-]+)")
    def resolve_approval(self, action_id: str):
        from ..integrations import BROKER
        body = self._body()
        ok = BROKER.resolve(
            action_id,
            approved=bool(body.get("approved")),
            responder=body.get("responder", "api"),
            notes=body.get("notes"),
        )
        self._json(200 if ok else 404,
                   {"resolved": ok, "action_id": action_id})

    # -- hypothesis feedback (the reference defines HypothesisFeedback but
    #    never persists or accepts it — hypothesis.py:169-176) -------------

    @route("POST", r"/api/v1/hypotheses/(?P<hypothesis_id>[0-9a-f-]+)/feedback")
    def submit_feedback(self, hypothesis_id: str):
        from ..models import HypothesisFeedback
        body = self._body()
        try:
            fb = HypothesisFeedback.from_request(
                hypothesis_id=hypothesis_id, **body)
        except (TypeError, ValueError) as exc:
            # bad request body: a field's validation, or non-str kwargs
            self._json(400, {"error": str(exc)})
            return
        if not self.app.db.insert_feedback(fb):
            self._json(404, {"error": "unknown hypothesis",
                             "hypothesis_id": str(fb.hypothesis_id)})
            return
        self._json(201, {"recorded": True,
                         "hypothesis_id": str(fb.hypothesis_id)})

    @route("GET", r"/api/v1/hypotheses/(?P<hypothesis_id>[0-9a-f-]+)/feedback")
    def list_feedback(self, hypothesis_id: str):
        self._json(200, {"feedback": self.app.db.feedback_for(hypothesis_id)})

    # -- online learning (graft-evolve, learn/) ----------------------------
    # The operator surface of the loop: POST /api/v1/feedback feeds it
    # (the flat-body twin of the per-hypothesis route above — the
    # hypothesis id rides in the body, which is what operator tooling
    # posting from an alert annotation wants), GET /api/v1/learning
    # observes it (buffer occupancy, last gate eval, swap generation).

    @route("POST", "/api/v1/feedback")
    def submit_feedback_body(self):
        from ..models import HypothesisFeedback
        body = self._body()
        try:
            fb = HypothesisFeedback.from_request(**body)
        except (TypeError, ValueError) as exc:
            self._json(400, {"error": str(exc)})
            return
        # orphan rejection rides the storage layer's atomic
        # existence-check-and-insert (insert_feedback's False path):
        # feedback for a hypothesis re-analysis deleted must 404, not
        # silently poison the learning loop's label harvest
        if not self.app.db.insert_feedback(fb):
            self._json(404, {"error": "unknown hypothesis",
                             "hypothesis_id": str(fb.hypothesis_id)})
            return
        self._json(201, {"recorded": True,
                         "hypothesis_id": str(fb.hypothesis_id)})

    @route("GET", "/api/v1/learning")
    def learning_status(self):
        self._json(200, self.app.learning_status())

    # -- elastic fleet (graft-swell) ---------------------------------------

    @route("GET", "/api/v1/fleet")
    def fleet_status(self):
        """Per-mesh tenant placement, per-tenant admitted-rows/s load
        estimates, and the scale/migration history ring — the operator
        surface of the elastic fleet (rca/surge.SurgeServer)."""
        surge = getattr(self.app, "surge", None)
        if surge is None:
            self._json(200, {"enabled": False, "packs": {},
                             "placement": {}, "loads": {},
                             "history": [], "generation": 0,
                             "migrations": 0})
            return
        self._json(200, {"enabled": True, **surge.fleet()})

    # -- traces (observability; new) --------------------------------------

    @route("GET", "/api/v1/traces")
    def traces(self):
        self._json(200, {"spans": TRACER.export(self.query.get("trace_id"))})

    @route("GET", "/api/v1/flight-recorder")
    def flight_recorder(self):
        """graft-scope forensics: the live per-tick flight ring plus the
        last on-disk dump the shield froze (tier transition / recovery)."""
        self._json(200, {
            "records": FLIGHT_RECORDER.snapshot(),
            "dumps": FLIGHT_RECORDER.dumps,
            "last_dump_path": FLIGHT_RECORDER.last_dump_path,
        })

    # -- workflow inspection (the Temporal-UI analog; reference
    # docker-compose.yml:80-92 ships Temporal UI so a human can watch an
    # incident's steps — here the journal IS the history, VERDICT r4 item 8)

    @route("GET", "/api/v1/workflows")
    def list_workflows(self):
        # graft-saga: surface STALLED workflows (failed step / exhausted
        # resume budget on an open incident) so the resumer's blind spot
        # is an operator's first glance, and stamp the gauge while here
        from ..observability import metrics as obs_metrics
        max_resumes = int(getattr(self.app.settings,
                                  "workflow_max_resumes", 5))
        stalled = self.app.db.stalled_workflows(max_resumes=max_resumes)
        obs_metrics.WORKFLOW_STALLED.set(float(len(stalled)))
        stalled_ids = {s["workflow_id"]: s["reason"] for s in stalled}
        workflows = self.app.db.journal_workflows()
        for w in workflows:
            w["stalled"] = w["workflow_id"] in stalled_ids
            if w["stalled"]:
                w["stalled_reason"] = stalled_ids[w["workflow_id"]]
        self._json(200, {"workflows": workflows,
                         "stalled": stalled})

    @route("GET", r"/api/v1/workflows/(?P<workflow_id>[A-Za-z0-9_.:-]+)")
    def workflow_timeline(self, workflow_id: str):
        from ..workflow.incident_workflow import STEP_NAMES
        journal = self.app.db.journal_get(workflow_id)
        if not journal:
            return self._json(404, {"error": f"no journal for {workflow_id}"})
        order = [s for s in STEP_NAMES if s in journal] + \
                [s for s in journal if s not in STEP_NAMES]
        steps = [{"step": s, **journal[s]} for s in order]
        failed = [s["step"] for s in steps if s["status"] == "failed"]
        running = [s["step"] for s in steps if s["status"] == "running"]
        done = [s["step"] for s in steps if s["status"] == "completed"]
        self._json(200, {
            "workflow_id": workflow_id,
            # the ONE shared precedence encoding — do not inline it here
            # (it drifted once; ADVICE r5)
            "state": self.app.db.rollup_state(
                len(failed), len(running), len(done)),
            "total_duration_s": sum(s["duration_s"] or 0.0 for s in steps),
            "steps": steps,
        })

    @route("GET", "/workflows")
    def workflows_page(self):
        self._text(200, _WORKFLOWS_HTML, "text/html; charset=utf-8")


# One static self-contained page over the two JSON endpoints above: list on
# the left, per-step timeline (status, attempts, duration bar) on the right.
_WORKFLOWS_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>Workflows</title>
<style>
 body{font:14px/1.45 system-ui,sans-serif;margin:0;display:flex;height:100vh}
 #list{width:340px;overflow:auto;border-right:1px solid #ddd;padding:12px}
 #detail{flex:1;overflow:auto;padding:16px 24px}
 h1{font-size:16px;margin:0 0 10px}
 .wf{padding:8px 10px;border-radius:6px;cursor:pointer;margin-bottom:4px}
 .wf:hover{background:#f2f4f7}.wf.sel{background:#e8eefb}
 .wf .id{font-family:ui-monospace,monospace;font-size:12px;word-break:break-all}
 .badge{display:inline-block;padding:1px 8px;border-radius:10px;font-size:11px;
        color:#fff;margin-left:6px;vertical-align:middle}
 .completed{background:#2e7d32}.failed{background:#c62828}
 .running{background:#1565c0}.pending{background:#757575}
 .skipped{background:#9e9e9e}
 table{border-collapse:collapse;width:100%;margin-top:10px}
 td,th{text-align:left;padding:6px 10px;border-bottom:1px solid #eee;
       vertical-align:top}
 .bar{height:8px;background:#1565c0;border-radius:4px;min-width:2px}
 .dur{font-variant-numeric:tabular-nums;white-space:nowrap}
 pre{background:#f6f8fa;padding:8px;border-radius:6px;max-height:160px;
     overflow:auto;font-size:11px;margin:4px 0 0}
 .muted{color:#888}
</style></head><body>
<div id="list"><h1>Workflows</h1><div id="rows" class="muted">loading…</div></div>
<div id="detail"><h1 id="dt">Select a workflow</h1><div id="steps"></div></div>
<script>
const esc = s => String(s).replace(/[&<>"]/g,
  c => ({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;'}[c]));
let selected = null;
async function refreshList(){
  const r = await fetch('/api/v1/workflows'); const d = await r.json();
  const rows = document.getElementById('rows'); rows.innerHTML = '';
  if(!d.workflows.length){rows.textContent = 'no workflows yet'; return;}
  for(const w of d.workflows){
    const el = document.createElement('div');
    el.className = 'wf' + (w.workflow_id === selected ? ' sel' : '');
    el.innerHTML = `<span class="id">${esc(w.workflow_id)}</span>` +
      `<span class="badge ${esc(w.state)}">${esc(w.state)}</span>` +
      `<div class="muted">${w.completed}/${w.steps} steps · ` +
      `${(w.total_duration_s||0).toFixed(2)}s · ${esc(w.last_update)}</div>`;
    el.onclick = () => { selected = w.workflow_id; show(w.workflow_id);
                         refreshList(); };
    rows.appendChild(el);
  }
}
async function show(id){
  const r = await fetch('/api/v1/workflows/' + encodeURIComponent(id));
  const d = await r.json();
  document.getElementById('dt').innerHTML = `${esc(id)}` +
    ` <span class="badge ${esc(d.state)}">${esc(d.state)}</span>` +
    ` <span class="muted dur">${d.total_duration_s.toFixed(2)}s total</span>`;
  const max = Math.max(...d.steps.map(s => s.duration_s || 0), 1e-9);
  let html = '<table><tr><th>step</th><th>status</th><th>attempts</th>' +
             '<th style="width:40%">duration</th><th>updated</th></tr>';
  for(const s of d.steps){
    const w = Math.round(100 * (s.duration_s || 0) / max);
    html += `<tr><td>${esc(s.step)}</td>` +
      `<td><span class="badge ${esc(s.status)}">${esc(s.status)}</span></td>` +
      `<td>${s.attempts}</td>` +
      `<td><div class="bar" style="width:${w}%"></div>` +
      `<span class="muted dur">${s.duration_s == null ? '—'
        : s.duration_s.toFixed(3) + 's'}</span>` +
      (s.result ? `<pre>${esc(JSON.stringify(s.result, null, 1))}</pre>` : '') +
      `</td><td class="muted dur">${esc(s.updated_at || '')}</td></tr>`;
  }
  document.getElementById('steps').innerHTML = html + '</table>';
}
refreshList(); setInterval(() => { refreshList();
  if(selected) show(selected); }, 3000);
</script></body></html>
"""


def make_server(app, host: str = "127.0.0.1", port: int = 0) -> ThreadingHTTPServer:
    handler = type("BoundApiHandler", (ApiHandler,), {"app": app})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    return server
