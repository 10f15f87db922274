"""The port's live-cluster backend (``collectors/live.py``) and fault
injector (``simulator/live_faults.py``) against the JAX package's, both
pointed at one canned server: the permissive K8s/Prometheus/Loki handler
of tests/test_live_backend.py and the strict recorded-fixture server of
tests/test_live_fixtures.py. Every read returns equal values (the state
dataclasses compared field by field), every write sends the same
requests; pagination, the 410 relist, 401, the HTML failure and selector
encoding behave alike; the collectors give the JAX evidence; ``app.main()``
builds the live backend for ``cluster_backend="kubernetes"``; and one
webhook through each package's app on the canned server ends with the
same hypotheses, actions and workflow status."""
from __future__ import annotations

import dataclasses
import importlib
import json
import threading
import time
import urllib.error
import urllib.request
from datetime import datetime, timezone
from http.server import ThreadingHTTPServer

import pytest
import torch

from tests import test_live_backend as canned
from tests import test_live_fixtures as strict_fx

JAX_PKG = "kubernetes_aiops_evidence_graph_tpu"
PORT_PKG = "kubernetes_aiops_evidence_graph_tpu_torch"
PKGS = (JAX_PKG, PORT_PKG)
NOW = datetime(2026, 7, 29, 12, 0, tzinfo=timezone.utc)

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def frozen_clock(monkeypatch):
    """One wall clock for both packages' live backends (pod not-ready
    seconds, the restartedAt annotation, evidence windows)."""
    for pkg in PKGS:
        monkeypatch.setattr(_mod(pkg, "collectors.live"), "utcnow",
                            lambda: NOW)


def _serve(handler):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def server():
    srv, base = _serve(canned._Handler)
    yield base
    srv.shutdown()
    srv.server_close()


def _backends(base, token="test-token"):
    return {pkg: _mod(pkg, "collectors.live").LiveClusterBackend(
        _mod(pkg, "config").load_settings(), k8s_url=base, k8s_token=token,
        prometheus_url=base, loki_url=base) for pkg in PKGS}


def _plain(value):
    """States as dicts (both packages' are dataclasses); lists and tuples
    element by element."""
    if dataclasses.is_dataclass(value):
        return dataclasses.asdict(value)
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return value


SINCE = datetime(2026, 7, 29, 11, 0, tzinfo=timezone.utc)
READS = {
    "list_pods service": ("list_pods", ("payments", "checkout")),
    "list_pods namespace": ("list_pods", ("payments",)),
    "list_deployments": ("list_deployments", ("payments", "checkout")),
    "list_nodes": ("list_nodes", ()),
    "list_hpas": ("list_hpas", ("payments", "checkout")),
    "list_configmaps": ("list_configmaps", ("payments",)),
    "list_events": ("list_events", ("payments", SINCE)),
    "rollout_history": ("rollout_history", ("payments", "checkout")),
    "query_logs": ("query_logs", ("payments", "checkout")),
    "query_metric": ("query_metric", ("payments", "checkout",
                                      "memory_usage_pct")),
    "query_metric unknown": ("query_metric", ("payments", "checkout",
                                              "nonexistent_query")),
    "query_metric_range": ("query_metric_range", (
        "payments", "checkout", "memory_usage_pct", 1753790000.0,
        1753790400.0)),
    "now": ("now", None),
}


@pytest.mark.parametrize("what", sorted(READS))
def test_reads_equal_jax(what, server):
    method, args = READS[what]
    out = {}
    for pkg, b in _backends(server).items():
        canned.RANGE_PARAMS.clear()
        out[pkg] = (_plain(getattr(b, method) if args is None
                           else getattr(b, method)(*args)),
                    list(canned.RANGE_PARAMS))
    assert out[PORT_PKG] == out[JAX_PKG]
    assert out[PORT_PKG][0] not in (None, [], {}) or what.endswith(
        "unknown") or method in ("list_hpas", "list_configmaps")


WRITES = (("delete_pod", ("payments", "checkout-abc12-x1")),
          ("restart_deployment", ("payments", "checkout")),
          ("rollback_deployment", ("payments", "checkout")),
          ("scale_deployment", ("payments", "checkout", 5)),
          ("cordon_node", ("node-1",)),
          ("uncordon_node", ("node-1",)))


def test_writes_send_the_jax_requests(server):
    sent = {}
    for pkg, b in _backends(server).items():
        canned.WRITES.clear()
        oks = [getattr(b, m)(*args) for m, args in WRITES]
        sent[pkg] = (oks, list(canned.WRITES))
    assert sent[PORT_PKG] == sent[JAX_PKG]
    assert all(sent[PORT_PKG][0]) and len(sent[PORT_PKG][1]) == len(WRITES)


def test_fault_injector_sends_the_jax_requests(server):
    out = {}
    for pkg, b in _backends(server).items():
        lf = _mod(pkg, "simulator.live_faults")
        canned.WRITES.clear()
        inj = lf.LiveFaultInjector(b)
        res = [inj.create(s, namespace="payments")
               for s in ("crashloop", "oom", "imagepull", "slowapp")]
        res += [inj.cleanup("payments"), inj.list_injected("payments")]
        out[pkg] = (res, list(canned.WRITES),
                    [lf.manifests(s, "default") for s in (
                        "crashloop", "oom", "imagepull", "slowapp")],
                    (lf.LABEL_KEY, lf.LABEL_VALUE))
        with pytest.raises(ValueError, match="unknown live scenario"):
            lf.manifests("bogus", "default")
    assert out[PORT_PKG] == out[JAX_PKG]
    assert out[PORT_PKG][0][0] == ["Deployment/kaeg-sim-crashloop"]
    assert [m for m, _p, _b in out[PORT_PKG][1][:2]] == ["DELETE", "POST"]


@pytest.fixture()
def strict():
    """The strict server of tests/test_live_fixtures.py, one per package
    (its state records each package's requests apart)."""
    made = {}
    for pkg in PKGS:
        state = strict_fx.StrictState()
        handler = type("H", (strict_fx._StrictHandler,), {"state": state})
        srv, base = _serve(handler)
        made[pkg] = (srv, base, state)
    yield {pkg: (base, state) for pkg, (_s, base, state) in made.items()}
    for srv, _b, _s in made.values():
        srv.shutdown()
        srv.server_close()


def _strict_backend(pkg, base, token=strict_fx.TOKEN):
    return _mod(pkg, "collectors.live").LiveClusterBackend(
        _mod(pkg, "config").load_settings(), k8s_url=base, k8s_token=token,
        prometheus_url=base, loki_url=base)


def _outcome(fn):
    """A call's value, or its exception's type, HTTP code and message."""
    try:
        return ("ok", _plain(fn()))
    except urllib.error.HTTPError as exc:
        return ("http", exc.code)
    except ValueError as exc:
        return ("value", type(exc).__name__, str(exc).split(" from ")[0])


STRICT = {
    "pagination": lambda b, s: b.list_pods("shop"),
    "selector encoding": lambda b, s: b.list_pods("shop", "checkout"),
    "410 relist": lambda b, s: (setattr(s, "expire_continue_once", True),
                                b.list_pods("shop"))[1],
    "stale token": lambda b, s: b._k8s_list(
        "/api/v1/namespaces/shop/pods", {"continue": "bogus-token"}),
    "html": lambda b, s: (s.serve_html_for.add(
        "/api/v1/namespaces/shop/pods"), b.list_pods("shop"))[1],
    "loki": lambda b, s: b.query_logs("shop", "checkout", limit=500),
    "prometheus": lambda b, s: b.query_metric_range(
        "shop", "checkout", "memory_usage_pct", 1753790000.0, 1753790400.0),
}


@pytest.mark.parametrize("what", sorted(STRICT) + ["401"])
def test_strict_wire_protocol_equals_jax(what, strict):
    out = {}
    for pkg, (base, state) in strict.items():
        if what == "401":
            b = _strict_backend(pkg, base, token=None)
            got = _outcome(lambda: b.list_pods("shop"))
        else:
            b = _strict_backend(pkg, base)
            got = _outcome(lambda: STRICT[what](b, state))
        out[pkg] = (got, state.requests, state.raw_queries)
    assert out[PORT_PKG] == out[JAX_PKG]
    want = {"401": ("http", 401), "stale token": ("http", 410)}
    if what in want:
        assert out[PORT_PKG][0] == want[what]
    elif what == "html":
        assert out[PORT_PKG][0][0] == "value"
    else:
        assert out[PORT_PKG][0][0] == "ok" and out[PORT_PKG][0][1]


def test_collectors_through_the_port_backend_give_the_jax_evidence(server):
    dumps = {}
    for pkg, b in _backends(server).items():
        models = _mod(pkg, "models")
        col = _mod(pkg, "collectors")
        inc = models.Incident(
            title="crashloop", severity=models.Severity.CRITICAL,
            source="alertmanager", fingerprint="fp-live-1",
            namespace="payments", service="checkout",
            labels={"alertname": "PodCrashLooping"}, started_at=NOW)
        results = col.collect_all(inc, col.default_collectors(
            b, _mod(pkg, "config").load_settings()), parallel=False)
        dumps[pkg] = []
        for r in results:
            assert not r.errors, r.errors
            for ev in r.evidence:
                d = ev.model_dump(mode="json")
                for k in ("id", "incident_id", "collected_at"):
                    d.pop(k)
                dumps[pkg].append(d)
    assert dumps[PORT_PKG] == dumps[JAX_PKG]
    kinds = {d["evidence_type"] for d in dumps[PORT_PKG]}
    assert {"kubernetes_pod", "log_signal"} <= kinds


def test_main_builds_the_live_backend(monkeypatch):
    """``KAEG_CLUSTER_BACKEND=kubernetes``: ``app.main()`` serves the live
    backend (``start`` is stopped before it serves; the app is put on the
    CPU, as every test here runs)."""
    from kubernetes_aiops_evidence_graph_tpu_torch import app as t_app
    from kubernetes_aiops_evidence_graph_tpu_torch.collectors.live import (
        LiveClusterBackend)
    from kubernetes_aiops_evidence_graph_tpu_torch.config import settings as cs
    from kubernetes_aiops_evidence_graph_tpu_torch.device import resolve_device

    class Started(Exception):
        pass

    def start(self, *a, **kw):
        raise Started(self)

    monkeypatch.setenv("KAEG_CLUSTER_BACKEND", "kubernetes")
    monkeypatch.setenv("KAEG_PROMETHEUS_URL", "http://127.0.0.1:9")
    monkeypatch.setenv("KAEG_DB_PATH", ":memory:")
    monkeypatch.setattr(t_app, "resolve_device",
                        lambda device: resolve_device("cpu"))
    monkeypatch.setattr(t_app.AiopsApp, "start", start)
    cs.get_settings.cache_clear()
    try:
        with pytest.raises(Started) as got:
            t_app.main()
    finally:
        cs.get_settings.cache_clear()
    app = got.value.args[0]
    assert type(app.cluster) is LiveClusterBackend
    assert app.cluster.prometheus_url == "http://127.0.0.1:9"
    assert app.cluster.loki_url == "http://localhost:3100"
    assert app.worker.cluster is app.cluster
    app.db.close()


# -- one webhook through each package's app on the canned server ---------------

APP_SETTINGS = dict(api_port=0, db_path=":memory:", app_env="development",
                    remediation_dry_run=False, verification_wait_seconds=0,
                    slack_webhook_url="", jira_url="", llm_provider="none",
                    rca_backend="tpu", node_bucket_sizes=(512, 2048),
                    incident_bucket_sizes=(8, 32))
ALERT = {"alerts": [{"status": "firing",
                     "labels": {"alertname": "PodCrashLooping",
                                "namespace": "payments",
                                "service": "checkout",
                                "severity": "critical"},
                     "annotations": {"summary": "checkout crashlooping"}}]}


def _http(base, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _one_webhook(pkg, server) -> dict:
    settings = _mod(pkg, "config").load_settings(**(
        APP_SETTINGS if pkg == PORT_PKG
        else {**APP_SETTINGS, "edge_bucket_sizes": (2048, 8192)}))
    backend = _mod(pkg, "collectors.live").LiveClusterBackend(
        settings, k8s_url=server, k8s_token="test-token",
        prometheus_url=server, loki_url=server)
    kw = {"device": "cpu"} if pkg == PORT_PKG else {}
    app = _mod(pkg, "app").AiopsApp(backend, settings, **kw)
    base = f"http://127.0.0.1:{app.start(host='127.0.0.1')}"
    try:
        canned.WRITES.clear()
        iid = _http(base, "/api/v1/webhooks/alertmanager", ALERT)["created"][0]
        deadline = time.monotonic() + 180
        while True:
            st = _http(base, f"/api/v1/incidents/{iid}/status")
            if st["failed"] or "close_incident" in st["completed"]:
                break
            assert time.monotonic() < deadline, f"{pkg}: {st}"
            time.sleep(0.05)
        gen = st["steps"]["generate_hypotheses"]["result"]
        return {
            "state": st["state"], "completed": st["completed"],
            "failed": st["failed"], "mode": gen["mode"],
            "top_rule": gen["top_rule"],
            "hypotheses": [(h["rule_id"], h["category"], h["confidence"],
                            h["final_score"], h["backend"]) for h in _http(
                base, f"/api/v1/incidents/{iid}/hypotheses")["hypotheses"]],
            "actions": [(a["action_type"], a["status"]) for a in _http(
                base, f"/api/v1/incidents/{iid}/actions")["actions"]],
            "status": _http(base, f"/api/v1/incidents/{iid}")["status"],
            "writes": [(m, p) for m, p, _b in canned.WRITES],
        }
    finally:
        app.stop()


def test_one_webhook_through_both_apps_on_the_canned_server(server):
    want = _one_webhook(JAX_PKG, server)
    got = _one_webhook(PORT_PKG, server)
    assert got == want
    assert got["mode"] == "streaming" and got["hypotheses"]
    assert "close_incident" in got["completed"]


def test_chip_smoke_live_phase_rehearsal():
    """chip_smoke.py's live phase on the CPU, on its own copy of the
    canned server's answers, which stays equal to tests/test_live_backend's."""
    import chip_smoke
    assert chip_smoke.LIVE_TABLE == {
        "/api/v1/namespaces/payments/pods": canned.K8S_PODS,
        "/apis/apps/v1/namespaces/payments/deployments": canned.K8S_DEPLOYMENTS,
        "/apis/apps/v1/namespaces/payments/replicasets": canned.K8S_REPLICASETS,
        "/api/v1/nodes": canned.K8S_NODES,
        "/api/v1/namespaces/payments/events": canned.K8S_EVENTS,
        "/api/v1/namespaces/payments/configmaps": {"items": []},
        "/apis/autoscaling/v2/namespaces/payments/horizontalpodautoscalers":
            {"items": []},
        "/loki/api/v1/query_range": canned.LOKI,
        "/api/v1/query": canned.PROM,
        "/api/v1/query_range": canned.PROM_RANGE}
    res = chip_smoke.run_live(torch.device("cpu"), deadline_s=120.0)
    assert res["top_rule"] != "unknown" and res["hypotheses"] >= 1
    assert res["status"] in ("resolved", "closed")
