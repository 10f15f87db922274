"""The port's ``AiopsApp`` over real HTTP on 127.0.0.1, on the CPU
(``device="cpu"``): webhook to resolved incident for both scorers, dedup,
concurrent webhooks, the feedback round trip, the workflow inspection
surface and ``/metrics``; a table of bad requests answered with the JAX
app's status codes (the JAX app on ``rca_backend="cpu"``); the blast route's
contract (a map bounded by the hops, ranked by propagated score, 404 for
an unknown incident); and the app, CLI, blast and live phases of
``chip_smoke.py`` rehearsed at a small size. The patterns are
tests/test_app.py and scripts/smoke_e2e.py."""
from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
import uuid

import numpy as np
import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu.app import AiopsApp as JaxApp
from kubernetes_aiops_evidence_graph_tpu.config import load_settings as j_settings
from kubernetes_aiops_evidence_graph_tpu_torch.app import AiopsApp
from kubernetes_aiops_evidence_graph_tpu_torch.config import load_settings
from kubernetes_aiops_evidence_graph_tpu_torch.simulator import (
    SCENARIOS, generate_cluster, inject)

SMALL = dict(api_port=0, db_path=":memory:", app_env="development",
             remediation_dry_run=False, verification_wait_seconds=0,
             slack_webhook_url="", jira_url="", llm_provider="none",
             node_bucket_sizes=(512, 2048), incident_bucket_sizes=(8, 32))


def _serve(backend: str, seed: int = 0):
    cluster = generate_cluster(num_pods=96, seed=seed)
    keys = sorted(cluster.deployments)
    rng = np.random.default_rng(seed)
    for i, name in enumerate(("crashloop_deploy", "oom", "hpa_maxed",
                              "network")):
        inject(cluster, name, keys[i], rng)
    app = AiopsApp(cluster, load_settings(rca_backend=backend, **SMALL),
                   device="cpu")
    port = app.start(host="127.0.0.1")
    return app, f"http://127.0.0.1:{port}", keys


@pytest.fixture(scope="module")
def rules_app():
    app, base, keys = _serve("tpu")
    yield app, base, keys
    app.stop()


@pytest.fixture(scope="module")
def learned_app():
    app, base, keys = _serve("gnn", seed=1)
    yield app, base, keys
    app.stop()


def _call(base, path, payload=None, method=None):
    """(status, decoded body) of one request; error statuses included."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            status, body = r.status, r.read()
    except urllib.error.HTTPError as err:
        status, body = err.code, err.read()
    try:
        return status, json.loads(body)
    except ValueError:
        return status, body.decode()


def _alert(key: str, scenario: str, alertname: str | None = None) -> dict:
    ns, svc = key.split("/", 1)
    sc = SCENARIOS[scenario]
    return {"status": "firing",
            "labels": {"alertname": alertname or sc.alertname,
                       "namespace": ns, "service": svc,
                       "severity": sc.severity.value},
            "annotations": {"summary": f"{scenario} on {svc}"}}


def _wait(base, iid, timeout_s=120.0) -> dict:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        st = _call(base, f"/api/v1/incidents/{iid}/status")[1]
        # "completed" alone also reads between two steps
        if st["failed"] or "close_incident" in st["completed"]:
            return st
        time.sleep(0.05)
    raise AssertionError(f"{iid} did not complete")


@pytest.mark.parametrize("which", ["rules_app", "learned_app"])
def test_webhook_to_resolution_over_http(which, request):
    app, base, keys = request.getfixturevalue(which)
    assert _call(base, "/health")[1]["status"] == "healthy"
    assert _call(base, "/health/ready")[1]["ready"] is True
    status, out = _call(base, "/api/v1/webhooks/alertmanager",
                        {"alerts": [_alert(keys[0], "crashloop_deploy")]})
    assert status == 200 and len(out["created"]) == 1
    iid = out["created"][0]
    st = _wait(base, iid)
    assert st["state"] == "completed" and not st["failed"]
    gen = st["steps"]["generate_hypotheses"]["result"]
    assert gen["mode"] == "streaming"
    assert gen["backend"] == app.settings.rca_backend
    hyps = _call(base, f"/api/v1/incidents/{iid}/hypotheses")[1]["hypotheses"]
    assert hyps[0]["rule_id"] == "crashloop_recent_deploy"
    assert hyps[0]["backend"] == app.settings.rca_backend
    assert _call(base, f"/api/v1/incidents/{iid}/runbook")[1]["steps"]
    actions = _call(base, f"/api/v1/incidents/{iid}/actions")[1]["actions"]
    assert actions[0]["action_type"] == "rollback_deployment"
    assert _call(base, f"/api/v1/incidents/{iid}")[1]["status"] == "resolved"
    graph = _call(base, f"/api/v1/incidents/{iid}/graph?depth=3")[1]
    assert len(graph["nodes"]) > 1
    assert app.worker.scorer.device.type == "cpu"


def test_duplicate_and_concurrent_webhooks(rules_app):
    app, base, keys = rules_app
    alert = _alert(keys[1], "oom", alertname="PodOOMDup")
    first = _call(base, "/api/v1/webhooks/alertmanager", {"alerts": [alert]})
    again = _call(base, "/api/v1/webhooks/alertmanager", {"alerts": [alert]})
    assert len(first[1]["created"]) == 1
    assert again[1] == {"created": [], "duplicates": 1}
    created, errors = [], []

    def post(i):
        try:
            out = _call(base, "/api/v1/webhooks/alertmanager", {"alerts": [
                _alert(keys[(i + 2) % len(keys)], "hpa_maxed",
                       alertname=f"Concurrent{i}")]})[1]
            created.extend(out["created"])
        except Exception as exc:  # surfaced by the assert below
            errors.append(exc)
    threads = [threading.Thread(target=post, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(created) == 6
    for iid in created + first[1]["created"]:
        assert _wait(base, iid)["state"] == "completed"


def test_feedback_round_trip_and_inspection_surface(rules_app):
    app, base, keys = rules_app
    out = _call(base, "/api/v1/webhooks/alertmanager",
                {"alerts": [_alert(keys[3], "network")]})[1]
    iid = out["created"][0]
    _wait(base, iid)
    hid = _call(base, f"/api/v1/incidents/{iid}/hypotheses"
                )[1]["hypotheses"][0]["id"]
    status, body = _call(base, f"/api/v1/hypotheses/{hid}/feedback",
                         {"was_correct": "yes", "submitted_by": "sre",
                          "ignored_key": 1})
    assert status == 201 and body["recorded"] is True
    assert _call(base, "/api/v1/feedback",
                 {"hypothesis_id": hid, "was_correct": False,
                  "actual_root_cause": "dns"})[0] == 201
    fb = _call(base, f"/api/v1/hypotheses/{hid}/feedback")[1]["feedback"]
    assert sorted(bool(f["was_correct"]) for f in fb) == [False, True]
    assert _call(base, "/api/v1/learning")[1] == {"enabled": False,
                                                  "running": False}
    wfs = _call(base, "/api/v1/workflows")[1]
    mine = [w for w in wfs["workflows"] if w["workflow_id"] == f"incident-{iid}"]
    assert mine and mine[0]["state"] == "completed" and not mine[0]["stalled"]
    tl = _call(base, f"/api/v1/workflows/incident-{iid}")[1]
    assert [s["step"] for s in tl["steps"]][:3] == [
        "collect_evidence", "build_graph", "generate_hypotheses"]
    assert tl["state"] == "completed"
    status, page = _call(base, "/workflows")
    assert status == 200 and "<title>Workflows</title>" in page
    assert _call(base, "/api/v1/fleet")[1]["enabled"] is False
    assert _call(base, "/api/v1/flight-recorder")[0] == 200
    metrics = _call(base, "/metrics")[1]
    for name in ("aiops_incidents_created_total",
                 "aiops_incidents_resolved_total",
                 "aiops_webhook_verdict_latency_seconds_count",
                 "aiops_workflow_step_duration_seconds_count",
                 "aiops_hypotheses_generated_total"):
        assert name in metrics, name


def test_blast_propagation_endpoint(rules_app):
    """The contract of tests/test_app.py's blast case on the port's app:
    the reached set is bounded by the hops, scores come from label
    propagation and rank closer entities higher, an unknown id is 404."""
    app, base, keys = rules_app
    out = _call(base, "/api/v1/webhooks/alertmanager", {"alerts": [
        _alert(keys[2], "crashloop_deploy", alertname="BlastCase")]})[1]
    iid = out["created"][0]
    _wait(base, iid)
    status, out = _call(base, f"/api/v1/incidents/{iid}/blast-propagation"
                              "?hops=3")
    assert status == 200 and out["incident"] == f"incident:{iid}"
    assert out["hops"] == 3 and out["iterations"] == 3
    assert out["reached_nodes"] >= len(out["blast"]) > 0
    scores = [b["score"] for b in out["blast"]]
    assert scores == sorted(scores, reverse=True) and all(s > 0 for s in scores)
    one_hop = _call(base, f"/api/v1/incidents/{iid}/blast-propagation"
                          "?hops=1&top_k=5")[1]
    assert one_hop["reached_nodes"] <= out["reached_nodes"]
    assert len(one_hop["blast"]) <= 5
    g = _call(base, f"/api/v1/incidents/{iid}/graph?depth=1")[1]
    direct = {n["id"] for n in g["nodes"]} - {f"incident:{iid}"}
    assert direct and (out["blast"][0]["id"] in direct
                       or one_hop["blast"][0]["id"] in direct)
    status, body = _call(base, f"/api/v1/incidents/{uuid.uuid4()}"
                               "/blast-propagation")
    assert status == 404 and body["error"] == "incident not in graph"


# -- bad requests: the JAX app's status codes ------------------------------------

@pytest.fixture(scope="module")
def jax_app():
    cluster = generate_cluster(num_pods=96, seed=2)
    settings = j_settings(rca_backend="cpu", edge_bucket_sizes=(2048, 8192),
                          **SMALL)
    from kubernetes_aiops_evidence_graph_tpu.simulator import (
        generate_cluster as jgen)
    app = JaxApp(jgen(num_pods=96, seed=2), settings)
    port = app.start(host="127.0.0.1")
    yield app, f"http://127.0.0.1:{port}"
    app.stop()


_U = "0f8fad5b-d9cb-469f-a165-70867728950e"
BAD = [
    ("POST", f"/api/v1/hypotheses/{_U}/feedback", {"was_correct": True}),
    ("POST", f"/api/v1/hypotheses/{_U}/feedback", {"was_correct": "maybe"}),
    ("POST", f"/api/v1/hypotheses/{_U}/feedback", {"was_correct": 2}),
    ("POST", f"/api/v1/hypotheses/{_U}/feedback", {"was_correct": None}),
    ("POST", f"/api/v1/hypotheses/{_U}/feedback", {}),
    ("POST", f"/api/v1/hypotheses/{_U}/feedback",
     {"was_correct": True, "unknown_key": 1}),
    ("POST", f"/api/v1/hypotheses/{_U}/feedback",
     {"was_correct": True, "submitted_by": 5}),
    ("POST", f"/api/v1/hypotheses/{_U}/feedback",
     {"was_correct": True, "actual_root_cause": ["x"]}),
    ("POST", f"/api/v1/hypotheses/{_U}/feedback",
     {"was_correct": True, "hypothesis_id": _U}),
    ("POST", f"/api/v1/hypotheses/{_U}/feedback", [1, 2]),
    ("POST", f"/api/v1/hypotheses/{_U}/feedback",
     {"was_correct": "t", "submitted_at": "2026-07-29T08:00:00Z"}),
    ("POST", f"/api/v1/hypotheses/{_U}/feedback",
     {"was_correct": 1, "submitted_at": "yesterday"}),
    ("POST", "/api/v1/feedback", {"hypothesis_id": "nope",
                                  "was_correct": True}),
    ("POST", "/api/v1/feedback", {"hypothesis_id": 7, "was_correct": True}),
    ("POST", "/api/v1/feedback", {"hypothesis_id": _U, "was_correct": True}),
    ("POST", "/api/v1/feedback", {"hypothesis_id": _U.replace("-", ""),
                                  "was_correct": "off",
                                  "submitted_at": 1700000000}),
    ("POST", "/api/v1/feedback", {"was_correct": True}),
    ("GET", f"/api/v1/incidents/{_U}", None),
    ("GET", f"/api/v1/incidents/{_U}/runbook", None),
    ("GET", "/api/v1/incidents?limit=abc", None),
    ("PATCH", f"/api/v1/incidents/{_U}", {"status": "bogus"}),
    ("POST", "/api/v1/webhooks/alertmanager", {"alerts": "not a list"}),
    ("POST", f"/api/v1/approvals/{_U}", {"approved": True}),
    ("GET", "/api/v1/workflows/incident-nope", None),
    ("GET", "/api/v1/no-such-route", None),
    ("POST", "/api/v1/no-such-route", {}),
    ("DELETE", f"/api/v1/incidents/{_U}", None),
]


@pytest.mark.parametrize("method,path,body", BAD,
                         ids=[f"{m} {p.split('/api/v1/')[-1][:40]} {i}"
                              for i, (m, p, _b) in enumerate(BAD)])
def test_bad_requests_get_the_jax_apps_status(method, path, body, rules_app,
                                              jax_app):
    want = _call(jax_app[1], path, body, method=method)[0]
    got = _call(rules_app[1], path, body, method=method)[0]
    assert got == want and want >= 400


# -- chip_smoke.py's app phase, rehearsed on the CPU --------------------------------

@pytest.mark.parametrize("backend", ["tpu", "gnn"])
@pytest.mark.parametrize("verify", [False, True], ids=["timed", "verify"])
def test_chip_smoke_app_phase_rehearsal(backend, verify):
    import chip_smoke
    res = chip_smoke.run_app(backend, torch.device("cpu"), num_pods=96,
                             num_incidents=8, batch=3, verify=verify,
                             node_bucket_sizes=(512, 2048),
                             incident_bucket_sizes=(8, 32))
    assert res["incidents"] == 8 and res["scorer"] in (
        "StreamingScorer", "GnnStreamingScorer")
    assert res["webhook_to_verdict_s"]["samples"] == 8
    assert res["backend_builds"] == 1 and res["backend_names"] == [backend]
    assert res["checkpoint_loads"] == (2 if backend == "gnn" else 0)
    assert res["coalesced_ticks_metrics"] == res["coalesced_ticks"]
    if verify:
        assert res["checked_serves"] >= 8


def test_chip_smoke_blast_phase_rehearsal():
    import chip_smoke
    res = chip_smoke.run_app(
        "tpu", torch.device("cpu"), num_pods=96, num_incidents=6, batch=3,
        node_bucket_sizes=(512, 2048), incident_bucket_sizes=(8, 32),
        after=lambda app, base: chip_smoke.blast_phase(app, base, num=4))
    blast = res["after"]
    assert blast["route_calls"] == 16 and blast["incidents"] == 4
    assert blast["scores_bit_equal_cpu"] is True
    assert blast["khop_propagate_device_ms_hops3"] is None
    assert 0 < blast["reached_nodes"][1][0] <= blast["reached_nodes"][3][1]


def test_chip_smoke_cli_phase_rehearsal():
    import chip_smoke
    res = chip_smoke.run_cli(torch.device("cpu"), num_pods=200)
    assert res["incidents"] == len(SCENARIOS) and res["pods"] == 200
    assert res["graph"]["nodes"] > 0 and res["b1_device_ms"] is None
    assert res["top1_equals_expected_rule"] >= 8


@pytest.mark.parametrize("backend", ["gnn", "tpu"])
def test_learn_enabled_starts_the_ports_online_learner(backend):
    """``learn_enabled`` starts the port's ``OnlineLearner`` on the
    worker's resident learned scorer, off the serving path; a backend
    without a swappable scorer leaves learning off."""
    from kubernetes_aiops_evidence_graph_tpu_torch.learn import OnlineLearner
    cluster = generate_cluster(num_pods=96, seed=3)
    app = AiopsApp(cluster, load_settings(rca_backend=backend,
                                          learn_enabled=True,
                                          learn_interval_s=3600.0, **SMALL),
                   device="cpu")
    app.start(host="127.0.0.1")
    try:
        app._learner_thread.join(timeout=60)
        status = app.learning_status()
        if backend == "gnn":
            assert isinstance(app.learner, OnlineLearner)
            assert app.learner.targets == [app.worker.scorer]
            assert status["enabled"] is True
        else:
            assert app.learner is None
            assert status == {"enabled": True, "running": False}
    finally:
        app.stop()
