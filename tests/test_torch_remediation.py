"""The port's remediation back end against the JAX package's: the policy
engine's decisions on a table of actions, the orchestrator's blast radius
and proposals, the executor's two-phase intent/result ledger (fresh,
replayed and in-doubt), the compensator and the verifier on the same
seeded clusters, the runbook's steps, and the Slack, Jira and LLM clients
against a fake HTTP server on localhost. Ids and timestamps are left out
of every comparison. The patterns are tests/test_policy.py,
test_remediation.py, test_saga.py, test_integrations.py and test_llm.py."""
from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest

import kubernetes_aiops_evidence_graph_tpu as jpkg
import kubernetes_aiops_evidence_graph_tpu_torch as tpkg
from kubernetes_aiops_evidence_graph_tpu import collectors as j_collectors
from kubernetes_aiops_evidence_graph_tpu import integrations as j_integrations
from kubernetes_aiops_evidence_graph_tpu import models as j_models
from kubernetes_aiops_evidence_graph_tpu import policy as j_policy
from kubernetes_aiops_evidence_graph_tpu import remediation as j_remediation
from kubernetes_aiops_evidence_graph_tpu import runbook as j_runbook
from kubernetes_aiops_evidence_graph_tpu import simulator as j_simulator
from kubernetes_aiops_evidence_graph_tpu import storage as j_storage
from kubernetes_aiops_evidence_graph_tpu.config import load_settings as j_settings
from kubernetes_aiops_evidence_graph_tpu.rca import CpuRcaBackend as JCpu
from kubernetes_aiops_evidence_graph_tpu.rca import llm as j_llm
from kubernetes_aiops_evidence_graph_tpu_torch import collectors as t_collectors
from kubernetes_aiops_evidence_graph_tpu_torch import integrations as t_integrations
from kubernetes_aiops_evidence_graph_tpu_torch import models as t_models
from kubernetes_aiops_evidence_graph_tpu_torch import policy as t_policy
from kubernetes_aiops_evidence_graph_tpu_torch import remediation as t_remediation
from kubernetes_aiops_evidence_graph_tpu_torch import runbook as t_runbook
from kubernetes_aiops_evidence_graph_tpu_torch import simulator as t_simulator
from kubernetes_aiops_evidence_graph_tpu_torch import storage as t_storage
from kubernetes_aiops_evidence_graph_tpu_torch.config import load_settings as t_settings
from kubernetes_aiops_evidence_graph_tpu_torch.rca import CpuRcaBackend as TCpu
from kubernetes_aiops_evidence_graph_tpu_torch.rca import llm as t_llm

J = SimpleNamespace(settings=j_settings, sim=j_simulator, storage=j_storage,
                    rem=j_remediation, models=j_models, runbook=j_runbook,
                    collectors=j_collectors, cpu=JCpu, pkg=jpkg)
T = SimpleNamespace(settings=t_settings, sim=t_simulator, storage=t_storage,
                    rem=t_remediation, models=t_models, runbook=t_runbook,
                    collectors=t_collectors, cpu=TCpu, pkg=tpkg)
SAGA = dict(app_env="development", remediation_dry_run=False,
            verification_wait_seconds=0, rca_backend="cpu",
            slack_webhook_url="", jira_url="")

_UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                   r"[0-9a-f]{12}")
_VOLATILE = {"id", "incident_id", "hypothesis_id", "action_id",
             "created_at", "updated_at", "executed_at", "completed_at",
             "verified_at", "verification_started_at", "responded_at",
             "generated_at", "approved_at", "recorded_at", "at", "ts"}


def strip(x):
    """``x`` without ids and timestamps (UUIDs inside strings masked)."""
    if isinstance(x, dict):
        return {k: strip(v) for k, v in x.items() if k not in _VOLATILE}
    if isinstance(x, (list, tuple)):
        return [strip(v) for v in x]
    if isinstance(x, str):
        return _UUID.sub("<uuid>", x)
    return x


def dump(model) -> dict:
    return strip(model.model_dump(mode="json"))


_DBS: list = []
"""Every test database stays referenced: an in-memory database is named
after its object's id, which a later object may reuse once it is freed."""


def world(P, scenario="crashloop_deploy", seed=9, num_pods=60):
    cluster = P.sim.generate_cluster(num_pods=num_pods, seed=seed)
    target = sorted(cluster.deployments)[0]
    incident = P.sim.inject(cluster, scenario, target,
                            np.random.default_rng(seed))
    db = P.storage.Database(":memory:")
    _DBS.append(db)
    db.create_incident(incident)
    return cluster, target, incident, db


def cluster_state(cluster, target) -> dict:
    d = cluster.deployments[target]
    return {"deployment": (d.image, d.revision, d.replicas),
            "nodes": {n: dict(v.conditions) for n, v in
                      sorted(cluster.nodes.items())},
            "pods": sorted((p.name.split("-")[0], p.phase, p.ready,
                            p.restart_count)
                           for p in cluster.pods.values())}


# -- policy ------------------------------------------------------------------

ACTIONS = ("restart_pod", "delete_pod", "restart_deployment",
           "rollback_deployment", "scale_replicas", "cordon_node",
           "drain_node", "delete_pvc", "uncordon_node", "unknown_action")


@pytest.mark.parametrize("env", ["dev", "staging", "prod", "uat", "mystery"])
def test_policy_decisions_match_jax(env):
    n = 0
    for act in ACTIONS:
        for ns in ("default", "kube-system", "monitoring"):
            for blast in (0.0, 40.0, 60.0, 90.0):
                for rep in (1, 5):
                    for hour, weekend in ((12, False), (23, False),
                                          (12, True)):
                        kw = dict(action_type=act, environment=env,
                                  blast_radius_score=blast, namespace=ns,
                                  affected_replicas=rep, current_hour=hour,
                                  is_weekend=weekend)
                        want = j_policy.evaluate(j_policy.PolicyInput(**kw))
                        got = t_policy.evaluate(t_policy.PolicyInput(**kw))
                        assert (got.allow, got.requires_approval,
                                got.deny_reasons, got.reason) == (
                            want.allow, want.requires_approval,
                            want.deny_reasons, want.reason), kw
                        n += 1
    assert n == len(ACTIONS) * 3 * 4 * 2 * 3


def test_policy_facade_and_compensation_gate_match_jax():
    from datetime import datetime, timezone
    noon = datetime(2026, 7, 29, 12, 0, tzinfo=timezone.utc)
    je, te = j_policy.PolicyEngine(), t_policy.PolicyEngine()
    for env in ("development", "staging", "production", "uat"):
        for act in ACTIONS:
            for ns in ("default", "kube-system"):
                assert te.evaluate_remediation(act, env, 30.0, ns, now=noon) \
                    == je.evaluate_remediation(act, env, 30.0, ns, now=noon)
                assert te.evaluate_compensation(act, env, ns) == \
                    je.evaluate_compensation(act, env, ns)


# -- orchestrator, executor, verifier, compensator -----------------------------

@pytest.mark.parametrize("app_env", ["development", "staging", "production"])
@pytest.mark.parametrize("scenario,action", [
    ("crashloop_deploy", "rollback_deployment"), ("oom", "restart_deployment"),
    ("hpa_maxed", "scale_replicas"), ("crashloop_deploy", "no_such_action")])
def test_blast_radius_and_proposal_match_jax(app_env, scenario, action):
    out = []
    for P in (J, T):
        cluster, target, incident, _ = world(P, scenario)
        orch = P.rem.RemediationOrchestrator(
            cluster, P.settings(**{**SAGA, "app_env": app_env}))
        out.append((dump(orch.calculate_blast_radius(incident)),
                    dump(orch.propose_action(incident, action,
                                             incident.service))))
    assert out[1] == out[0]


@pytest.mark.parametrize("scenario,action", [
    ("crashloop_deploy", "rollback_deployment"), ("oom", "restart_deployment"),
    ("hpa_maxed", "scale_replicas"), ("crashloop_deploy", "cordon_node"),
    ("oom", "restart_pod")])
def test_executor_ledger_and_verifier_match_jax(scenario, action):
    """Fresh execution journals the intent before the mutation and the
    result after; the same key replays from the ledger without a second
    mutation; the verifier reads the same outcome."""
    out = []
    for P in (J, T):
        settings = P.settings(**SAGA)
        cluster, target, incident, db = world(P, scenario)
        orch = P.rem.RemediationOrchestrator(cluster, settings)
        tgt = (sorted(cluster.nodes)[0] if action == "cordon_node"
               else incident.service)
        act = orch.propose_action(incident, action, tgt)
        verifier = P.rem.RemediationVerifier(cluster)
        baseline = verifier.capture_baseline(incident)
        executed = P.rem.RemediationExecutor(cluster, settings, db=db
                                             ).execute(act, baseline=baseline)
        after = cluster_state(cluster, target)
        replay = P.rem.RemediationExecutor(cluster, settings, db=db
                                           ).execute(act)
        assert cluster_state(cluster, target) == after
        out.append((dump(executed), strip(db.execution_state(
            act.idempotency_key)), after, replay.status_reason,
            dump(verifier.verify(incident, executed, baseline))))
    assert out[1] == out[0]
    assert out[0][3] == "replayed from action ledger"


class _Crash(BaseException):
    """Stands for a worker dying between a mutation and its commit."""


def test_executor_in_doubt_intent_reconciles_like_jax():
    out = []
    for P in (J, T):
        settings = P.settings(**SAGA)
        cluster, target, incident, db = world(P)
        act = P.rem.RemediationOrchestrator(cluster, settings).propose_action(
            incident, "rollback_deployment", incident.service)

        def crash(stage):
            if stage == "wf_execute":
                raise _Crash(stage)
        with pytest.raises(_Crash):
            P.rem.RemediationExecutor(cluster, settings, db=db,
                                      fault_hook=crash).execute(act)
        in_doubt = len(db.in_doubt_executions())
        resumed = P.rem.RemediationExecutor(cluster, settings, db=db)
        done = resumed.execute(act)
        out.append((in_doubt, resumed.reconciliations, dump(done),
                    strip(db.execution_state(act.idempotency_key)),
                    cluster_state(cluster, target)))
    assert out[1] == out[0]
    assert out[0][0] == 1 and out[0][1] == 1


@pytest.mark.parametrize("scenario,action", [
    ("hpa_maxed", "scale_replicas"), ("crashloop_deploy", "cordon_node"),
    ("oom", "restart_deployment")])
def test_compensator_matches_jax(scenario, action):
    out = []
    for P in (J, T):
        settings = P.settings(**SAGA)
        cluster, target, incident, db = world(P, scenario)
        tgt = (sorted(cluster.nodes)[0] if action == "cordon_node"
               else incident.service)
        act = P.rem.RemediationOrchestrator(cluster, settings).propose_action(
            incident, action, tgt)
        executed = P.rem.RemediationExecutor(cluster, settings, db=db
                                             ).execute(act)
        comp = P.rem.RemediationCompensator(cluster, settings, db=db
                                            ).compensate(executed)
        rows = sorted((strip(r) for r in db.actions_for(incident.id)),
                      key=json.dumps)
        out.append((strip(comp), rows, cluster_state(cluster, target)))
    assert out[1] == out[0]


@pytest.mark.parametrize("scenario", ["crashloop_deploy", "oom", "hpa_maxed",
                                      "imagepull"])
def test_runbook_matches_jax(scenario):
    out = []
    for P in (J, T):
        settings = P.settings(**SAGA)
        cluster, target, incident, _ = world(P, scenario)
        results = P.collectors.collect_all(
            incident, P.collectors.default_collectors(cluster, settings),
            parallel=False)
        evidence = [e.model_dump(mode="json") for r in results
                    for e in r.evidence]
        top = P.cpu().score_incident(incident.id, evidence).top_hypothesis
        rb = P.runbook.RunbookGenerator().generate(incident, top,
                                                   evidence=evidence)
        out.append(dump(rb))
    assert out[1] == out[0]
    assert out[0]["steps"]


# -- Slack, Jira and the LLM against a fake server on localhost --------------

class _Fake:
    """A localhost HTTP server that records each POST and answers with a
    canned JSON body."""

    def __init__(self, reply: dict) -> None:
        calls = self.calls = []

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                calls.append((self.path, json.loads(self.rfile.read(n)),
                              self.headers.get("Authorization")))
                body = json.dumps(reply).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def _incident(M):
    return M.Incident(title="OOMKilled in api", fingerprint="fp-1",
                      severity=M.Severity.CRITICAL, namespace="prod-api",
                      service="api")


def _hypothesis(M, inc):
    return M.Hypothesis(
        incident_id=inc.id, category=M.HypothesisCategory.RESOURCE_EXHAUSTION,
        title="Container killed by OOM", description="memory limit too low",
        confidence=0.95, recommended_actions=["scale_deployment"],
        rule_id="oom_killed")


def test_slack_and_jira_post_like_jax():
    fake = _Fake({"key": "OPS-7"})
    try:
        got = []
        for M, I, S in ((j_models, j_integrations, j_settings),
                        (t_models, t_integrations, t_settings)):
            settings = S(slack_webhook_url=fake.url + "/hook",
                         jira_url=fake.url, jira_user="u", jira_token="t")
            inc = _incident(M)
            hyp = _hypothesis(M, inc)
            broker = I.ApprovalBroker()
            slack = I.SlackClient(settings, broker=broker)
            assert slack.notify("hello") is True
            req = M.ApprovalRequest(
                action_id=inc.id, incident_id=inc.id,
                incident_title=inc.title, hypothesis_summary="summary",
                action_type=M.ActionType.ROLLBACK_DEPLOYMENT,
                target_resource="api", target_namespace="prod-api",
                risk_level=M.ActionRisk.HIGH, blast_radius_score=42.0)
            threading.Timer(0.05, broker.resolve,
                            args=(str(req.action_id), True, "alice")).start()
            resp = slack.request_approval(req, timeout_s=5.0)
            ticket = I.JiraClient(settings).create_incident_ticket(
                inc, hyp, evidence=[])
            got.append((resp.approved, resp.responder, ticket))
        assert got[1] == got[0] == (True, "alice",
                                    {"created": True, "key": "OPS-7"})
        # both packages posted the same three bodies (ids masked)
        assert len(fake.calls) == 6
        assert strip(fake.calls[3:]) == strip(fake.calls[:3])
    finally:
        fake.close()


@pytest.mark.parametrize("provider", ["gemini", "openai", "ollama"])
def test_llm_enhancement_matches_jax(provider, monkeypatch):
    text = json.dumps({"reasoning": "memory grew after deploy",
                       "additional_steps": ["raise the limit"],
                       "alternatives": "a leak",
                       "enhanced_description": "OOM after the last deploy"})
    reply = {"gemini": {"candidates": [{"content": {"parts": [{"text": text}]}}]},
             "openai": {"choices": [{"message": {"content": text}}]},
             "ollama": {"response": text}}[provider]
    fake = _Fake(reply)
    try:
        got = []
        for M, L, S in ((j_models, j_llm, j_settings),
                        (t_models, t_llm, t_settings)):
            post = L.LLMSummarizer._post_json

            def local(self, url, payload, headers, post=post):
                # every provider's request goes to the fake, never out
                path = url.split("/", 3)[3] if "//" in url else url
                return post(self, f"{fake.url}/{path}", payload, headers)
            monkeypatch.setattr(L.LLMSummarizer, "_post_json", local)
            llm = L.LLMSummarizer(S(llm_provider=provider, llm_api_key="k"))
            inc = _incident(M)
            hyps = llm.enhance_hypotheses(inc, [_hypothesis(M, inc)],
                                          [{"type": "log", "source": "x",
                                            "data": {}}])
            got.append([dump(h) for h in hyps])
        assert got[1] == got[0]
        assert got[0][0]["generated_by"] == "hybrid"
        assert strip(fake.calls[1]) == strip(fake.calls[0])
    finally:
        fake.close()
