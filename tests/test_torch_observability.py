"""The port's observability layer against the JAX package's: the metric
families that ``/metrics`` exposes (same names and types), the span tree
and the webhook→verdict sample one webhook leaves through each app, the
tick-span stage splits, the flight recorder's ring, dumps and retention,
the retrospective stage spans, the OTLP encoding sent to a localhost
collector, and the logger's lines. The patterns are
tests/test_observability.py and tests/test_scope.py."""
from __future__ import annotations

import json
import re
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

from kubernetes_aiops_evidence_graph_tpu import observability as j_obs
from kubernetes_aiops_evidence_graph_tpu.observability import logging as j_logging
from kubernetes_aiops_evidence_graph_tpu.observability import metrics as j_metrics
from kubernetes_aiops_evidence_graph_tpu.observability import otlp as j_otlp
from kubernetes_aiops_evidence_graph_tpu.observability import scope as j_scope
from kubernetes_aiops_evidence_graph_tpu_torch import observability as t_obs
from kubernetes_aiops_evidence_graph_tpu_torch.observability import logging as t_logging
from kubernetes_aiops_evidence_graph_tpu_torch.observability import metrics as t_metrics
from kubernetes_aiops_evidence_graph_tpu_torch.observability import otlp as t_otlp
from kubernetes_aiops_evidence_graph_tpu_torch.observability import scope as t_scope

JAX_OBS = Path(j_obs.__file__).parent


def _families(registry) -> dict:
    """name -> type of every family the registry exposes."""
    return dict(re.findall(r"^# TYPE (\S+) (\S+)$", registry.expose(), re.M))


def test_metric_families_match_jax():
    """Every family the port exposes is the JAX package's, with its type,
    and every family the JAX observability modules declare is exposed by
    the port (other JAX modules register their own, e.g. the shield's)."""
    got, want = _families(t_metrics.REGISTRY), _families(j_metrics.REGISTRY)
    for name, kind in got.items():
        assert want.get(name) == kind, name
    declared = set(re.findall(r'"(aiops_[a-z0-9_]+)"', "".join(
        p.read_text() for p in JAX_OBS.glob("*.py"))))
    assert declared and declared <= set(got), declared - set(got)
    assert len(got) >= 80


def test_histogram_percentiles_and_exposition_match_jax():
    for reg in (j_metrics, t_metrics):
        h = reg.Histogram("aiops_test_lat_seconds", "t", buckets=(0.1, 1, 10))
        for v in (0.05, 0.2, 0.3, 2.0, 5.0, 20.0):
            h.observe(v, route="a")
    hj = j_metrics.Histogram("aiops_x", "t", buckets=(0.1, 1, 10))
    ht = t_metrics.Histogram("aiops_x", "t", buckets=(0.1, 1, 10))
    for v in np.random.default_rng(0).exponential(1.0, 200):
        hj.observe(float(v), route="a")
        ht.observe(float(v), route="a")
    for q in (0.5, 0.95, 0.99):
        assert ht.percentile(q, route="a") == hj.percentile(q, route="a")
    assert list(ht.expose()) == list(hj.expose())


# -- one webhook through each app: spans and the SLO sample -----------------

def _trace_names(tracer, root: str) -> list[str]:
    spans = tracer.export()
    webhook = [s for s in spans if s["name"] == root]
    assert webhook, [s["name"] for s in spans]
    tid = webhook[-1]["trace_id"]
    return sorted({s["name"] for s in tracer.export(tid)})


def _one_webhook(app_cls, settings, simulator, **kw):
    cluster = simulator.generate_cluster(num_pods=96, seed=5)
    key = sorted(cluster.deployments)[0]
    simulator.inject(cluster, "crashloop_deploy", key,
                     np.random.default_rng(5))
    app = app_cls(cluster, settings, **kw)
    port = app.start(host="127.0.0.1")
    try:
        ns, svc = key.split("/", 1)
        alert = {"alerts": [{"status": "firing", "labels": {
            "alertname": "KubePodCrashLooping", "namespace": ns,
            "service": svc, "severity": "critical"}}]}
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/api/v1/webhooks/alertmanager",
            data=json.dumps(alert).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as r:
            iid = json.loads(r.read())["created"][0]
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            st = app.workflow_status(iid)
            if "close_incident" in st["completed"]:
                break
            time.sleep(0.05)
        assert "close_incident" in st["completed"]
    finally:
        app.stop()
    return iid


def test_one_webhook_leaves_the_same_spans_and_slo_sample():
    """The webhook span roots the incident's trace and the workflow steps
    up to the verdict join it (serving the verdict closes the arrival
    record that carries the trace), in both apps; each closes one
    webhook→verdict sample. The JAX scorer's own tick spans
    (``serve.tick``, ``tick.*``) are left out: the port's scorers do not
    emit them yet (ROADMAP item 8)."""
    from kubernetes_aiops_evidence_graph_tpu import simulator as j_sim
    from kubernetes_aiops_evidence_graph_tpu.app import AiopsApp as JApp
    from kubernetes_aiops_evidence_graph_tpu.config import load_settings as js
    from kubernetes_aiops_evidence_graph_tpu_torch import simulator as t_sim
    from kubernetes_aiops_evidence_graph_tpu_torch.app import AiopsApp as TApp
    from kubernetes_aiops_evidence_graph_tpu_torch.config import load_settings as ts
    small = dict(api_port=0, db_path=":memory:", remediation_dry_run=False,
                 verification_wait_seconds=0, rca_backend="tpu",
                 node_bucket_sizes=(512, 2048), incident_bucket_sizes=(8, 32))
    names = {}
    for key, (App, S, sim, kw, obs, scope, met) in {
            "jax": (JApp, js(edge_bucket_sizes=(2048, 8192), **small), j_sim,
                    {}, j_obs, j_scope, j_metrics),
            "port": (TApp, ts(**small), t_sim, {"device": "cpu"}, t_obs,
                     t_scope, t_metrics)}.items():
        obs.TRACER.clear()
        lat = met.WEBHOOK_VERDICT_LATENCY
        before = sum(lat._totals.values())
        _one_webhook(App, S, sim, **kw)
        assert sum(lat._totals.values()) == before + 1
        assert scope.SCOPE.pending() == 0
        names[key] = [n for n in _trace_names(obs.TRACER,
                                              "webhook.alertmanager")
                      if n != "serve.tick" and not n.startswith("tick.")]
    assert names["port"] == names["jax"] == [
        "webhook.alertmanager", "workflow.build_graph",
        "workflow.collect_evidence", "workflow.generate_hypotheses"]


# -- the scope primitives -----------------------------------------------------

def test_tick_span_stages_and_record_match_jax():
    spans = [m.TickSpan(7, "rules", 2, "steady", 0.25) for m in (j_scope,
                                                                t_scope)]
    for s in spans:
        s.t0 = 0.0
        for stage, t in zip(("staging", "dispatch", "execute", "fetch"),
                            (0.125, 0.25, 0.375, 0.5)):
            s.marks.append((stage, t))
    for s in spans:
        s.flag("storm")
        s.flag("storm")
    rj, rt = (s.to_record() for s in spans)
    rj.pop("t_epoch_s"), rt.pop("t_epoch_s")   # each module's own anchor
    assert rt == rj
    assert list(rt["stages_ms"]) == ["queue_wait", "staging", "dispatch",
                                     "execute", "fetch"]
    assert rt["flags"] == ["storm"]


def test_flight_recorder_ring_dump_and_retention_match_jax(tmp_path):
    out = {}
    for key, m in (("jax", j_scope), ("port", t_scope)):
        fr = m.FlightRecorder(capacity=4, retention=2)
        for i in range(6):
            fr.record({"tick": i})
        span = m.TickSpan(9, "gnn", 1, "fused", 0.0)
        span.mark("dispatch")
        fr.record(span)
        fr.note_event("storm_mode", active=True)
        d = tmp_path / key
        paths = [fr.dump(f"tier:{i}", directory=str(d)) for i in range(3)]
        assert all(paths)
        snap = fr.snapshot()
        out[key] = ([sorted(r) for r in snap], [r.get("tick") for r in snap],
                    sorted(p.name for p in d.iterdir()), fr.dumps, fr.pruned,
                    sorted(fr.last_dump), len(fr.last_dump["records"]))
    assert out["port"] == out["jax"]
    assert out["port"][2] == ["flight_0002_tier_1.json",
                              "flight_0003_tier_2.json"]


def test_serve_scope_and_stage_spans_match_jax():
    out = {}
    for key, m, obs in (("jax", j_scope, j_obs), ("port", t_scope, t_obs)):
        sc = m.ServeScope()
        obs.TRACER.clear()
        with obs.TRACER.span("webhook.test") as root:
            sc.webhook_received("abc", tenant="ns-1")
            m.emit_stage_span("rca.pass", [("prep", 0.01), ("device", 0.02),
                                           ("fetch", 0.005)], backend="tpu")
        parent = sc.trace_parent("incident-abc")
        lat = sc.verdict_served("abc", backend="rules")
        again = sc.verdict_served("abc", backend="rules")
        spans = obs.TRACER.export(root.trace_id)
        out[key] = (parent == (root.trace_id, root.span_id), lat is not None,
                    again, sorted(s["name"] for s in spans), sc.pending())
    assert out["port"] == out["jax"]
    assert out["port"][0] and out["port"][1]
    assert "rca.pass.device" in out["port"][3]


class _Collector:
    def __init__(self):
        bodies = self.bodies = []

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                bodies.append((self.path, json.loads(self.rfile.read(n))))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()


def test_otlp_export_matches_jax():
    col = _Collector()
    try:
        for m, obs in ((j_otlp, j_obs), (t_otlp, t_obs)):
            ex = m.OtlpExporter(col.url, "kaeg-test")
            tracer = obs.Tracer()
            tracer.on_end = ex.enqueue
            with tracer.span("webhook.alertmanager", alerts=2):
                with tracer.span("workflow.collect_evidence", n=1.5):
                    pass
            assert ex.flush() == 2
            ex.close()
        assert len(col.bodies) == 2
        (pj, bj), (pt, bt) = col.bodies
        strip = re.compile(r'"(traceId|spanId|parentSpanId|'
                           r'startTimeUnixNano|endTimeUnixNano)": "[^"]*"')
        assert pt == pj == "/v1/traces"
        assert strip.sub("", json.dumps(bt)) == strip.sub("", json.dumps(bj))
    finally:
        col.server.shutdown()


def test_logger_lines_match_jax():
    import io
    lines = []
    for m in (j_logging, t_logging):
        buf = io.StringIO()
        m.configure("INFO", stream=buf, as_json=True)
        m.get_logger("probe", tenant="t1").bind(step="x").info(
            "event_one", n=3)
        lines.append(json.loads(buf.getvalue().strip().splitlines()[-1]))
    for line in lines:
        line.pop("ts", None)
    assert lines[1] == lines[0] and lines[0]["event"] == "event_one"
    t_logging.configure("INFO")


def test_tick_scope_begin_and_finalize_match_jax():
    """``TickScope`` (the per-scorer front end the port's scorers take up
    in ROADMAP item 8) folds a tick into the flight ring, the stage
    histogram and, under a trace, ``serve.tick`` spans, as the JAX one."""
    from types import SimpleNamespace
    from kubernetes_aiops_evidence_graph_tpu.config import load_settings as js
    from kubernetes_aiops_evidence_graph_tpu_torch.config import load_settings as ts
    out = {}
    for key, m, obs, met, S in (("jax", j_scope, j_obs, j_metrics, js),
                                ("port", t_scope, t_obs, t_metrics, ts)):
        sc = m.TickScope("probe", settings=S(scope_flight_records=16))
        sc.note_queue_wait(0.002)
        sc.note_coalesced(5)
        obs.TRACER.clear()
        with obs.TRACER.span("workflow.generate_hypotheses") as root:
            span = sc.begin(SimpleNamespace(pipeline_depth=2,
                                            _scope_tier="steady"))
            for stage in ("staging", "dispatch", "fetch"):
                span.mark(stage)
            sc.finalize(span, fetched=True)
        rec = m.FLIGHT_RECORDER.snapshot()[-2:]
        for r in rec:
            r.pop("t_epoch_s")
            r.pop("stages_ms", None)
        hist = met.TICK_STAGE_SECONDS
        counts = {dict(k)["stage"]: hist._totals[k] for k in hist._totals
                  if dict(k).get("backend") == "probe"}
        out[key] = (rec, counts, sorted(s["name"] for s in
                                        obs.TRACER.export(root.trace_id)))
    assert out["port"] == out["jax"]
    assert out["port"][1] == {"queue_wait": 1, "staging": 1, "dispatch": 1,
                              "fetch": 1}
    assert "tick.fetch" in out["port"][2] and "serve.tick" in out["port"][2]
