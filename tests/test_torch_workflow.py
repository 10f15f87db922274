"""The port's workflow against the JAX package's: the engine's retry,
replay and fence contracts; one fault scenario driven through JAX
``run_incident_workflow`` and the port's on the same seeded 96-pod
cluster, for ``rca_backend`` tpu and gnn, on the resident scorer and on
the snapshot path (hypotheses equal for tpu, within 1e-5 for gnn and in
the same order; runbook, actions and final status equal; ids and
timestamps left out); the worker's scorers; the settings the port does
not back yet; the counted rules fallback of a corrupt checkpoint; and the
scorer seams the workflow calls (``absorb``, ``serving_node_id``).
The patterns are tests/test_workflow.py and tests/test_saga.py."""
from __future__ import annotations

import asyncio
import time
from datetime import datetime, timezone
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu import graph as j_graph
from kubernetes_aiops_evidence_graph_tpu import simulator as j_simulator
from kubernetes_aiops_evidence_graph_tpu import storage as j_storage
from kubernetes_aiops_evidence_graph_tpu import workflow as j_workflow
from kubernetes_aiops_evidence_graph_tpu.config import load_settings as j_settings
from kubernetes_aiops_evidence_graph_tpu.graph import snapshot as j_snapshot
from kubernetes_aiops_evidence_graph_tpu.rca.gnn_streaming import (
    GnnStreamingScorer as JGnnScorer)
from kubernetes_aiops_evidence_graph_tpu.rca.streaming import (
    StreamingScorer as JScorer)
from kubernetes_aiops_evidence_graph_tpu_torch import app as t_app
from kubernetes_aiops_evidence_graph_tpu_torch import graph as t_graph
from kubernetes_aiops_evidence_graph_tpu_torch import simulator as t_simulator
from kubernetes_aiops_evidence_graph_tpu_torch import storage as t_storage
from kubernetes_aiops_evidence_graph_tpu_torch import workflow as t_workflow
from kubernetes_aiops_evidence_graph_tpu_torch.config import load_settings as t_settings
from kubernetes_aiops_evidence_graph_tpu_torch.graph import snapshot as t_snapshot
from kubernetes_aiops_evidence_graph_tpu_torch.observability import metrics as t_metrics
from kubernetes_aiops_evidence_graph_tpu_torch.rca.gnn_streaming import (
    GnnStreamingScorer as TGnnScorer)
from kubernetes_aiops_evidence_graph_tpu_torch.rca.streaming import (
    StreamingScorer as TScorer)
from kubernetes_aiops_evidence_graph_tpu_torch.workflow import worker as t_worker

BASE = dict(app_env="development", remediation_dry_run=False,
            verification_wait_seconds=0, db_path=":memory:",
            slack_webhook_url="", jira_url="", llm_provider="none",
            node_bucket_sizes=(512, 2048), incident_bucket_sizes=(8, 32))
J = SimpleNamespace(settings=lambda **kw: j_settings(
    edge_bucket_sizes=(2048, 8192), **{**BASE, **kw}), sim=j_simulator,
    storage=j_storage, wf=j_workflow, graph=j_graph, scorers=(JScorer,
                                                              JGnnScorer))
T = SimpleNamespace(settings=lambda **kw: t_settings(**{**BASE, **kw}),
                    sim=t_simulator, storage=t_storage, wf=t_workflow,
                    graph=t_graph, scorers=(TScorer, TGnnScorer))
NOW = datetime(2026, 7, 29, 8, 30, tzinfo=timezone.utc)
_DBS: list = []


def _run(coro):
    return asyncio.get_event_loop_policy().new_event_loop() \
        .run_until_complete(coro)


class Ctx:
    def __init__(self):
        self.results = {}


# -- the engine ----------------------------------------------------------------

@pytest.mark.parametrize("P", [J, T], ids=["jax", "port"])
def test_engine_retry_backoff_and_non_retryable(P):
    """Transient failures retry with the seeded backoff, a ValueError does
    not retry; both packages sleep the same delays."""
    db = P.storage.Database(":memory:")
    _DBS.append(db)
    sleeps = []

    async def fake_sleep(s):
        sleeps.append(s)

    engine = P.wf.WorkflowEngine(db, sleeper=fake_sleep)
    n = {"calls": 0}

    def flaky(c):
        n["calls"] += 1
        if n["calls"] < 3:
            raise RuntimeError("transient")
        return {"ok": True}

    out = _run(engine.run("wf-retry", [P.wf.Step("flaky", flaky)], Ctx()))
    assert out == {"flaky": {"ok": True}} and n["calls"] == 3
    want = [j_workflow.RetryPolicy().delay(a, key="wf-retry") for a in (1, 2)]
    assert sleeps == want

    def bad(c):
        raise ValueError("no retry")
    with pytest.raises(P.wf.StepFailed) as err:
        _run(engine.run("wf-nr", [P.wf.Step("bad", bad)], Ctx()))
    assert err.value.attempts == 1
    assert engine.status("wf-nr")["state"] == "failed"


@pytest.mark.parametrize("P", [J, T], ids=["jax", "port"])
def test_engine_replays_completed_steps(P):
    db = P.storage.Database(":memory:")
    _DBS.append(db)
    engine = P.wf.WorkflowEngine(db)
    runs = {"a": 0, "b": 0}

    def a(c):
        runs["a"] += 1
        return {"v": 1}

    def b_fail(c):
        runs["b"] += 1
        raise ValueError("boom")

    def b_ok(c):
        runs["b"] += 1
        return {"v": 2}

    with pytest.raises(P.wf.StepFailed):
        _run(engine.run("wf", [P.wf.Step("a", a), P.wf.Step("b", b_fail)],
                        Ctx()))
    out = _run(engine.run("wf", [P.wf.Step("a", a), P.wf.Step("b", b_ok)],
                          Ctx()))
    assert runs == {"a": 1, "b": 2}
    assert out == {"a": {"v": 1}, "b": {"v": 2}}
    assert engine.status("wf")["state"] == "completed"


@pytest.mark.parametrize("P", [J, T], ids=["jax", "port"])
def test_engine_fences_a_stolen_lease(P):
    db = P.storage.Database(":memory:")
    _DBS.append(db)
    tok = db.lease_acquire("wf-f", "loser", 30.0)
    db.lease_acquire("wf-f", "winner", 30.0, now=time.time() + 60)
    with pytest.raises(P.wf.WorkflowFenced):
        _run(P.wf.WorkflowEngine(db).run(
            "wf-f", [P.wf.Step("s1", lambda c: {"ok": 1})], Ctx(),
            lease=("loser", tok), lease_ttl_s=30.0))
    assert db.journal_get("wf-f") == {}


# -- one incident through both workflows -----------------------------------------

def _drive(P, backend: str, scenario: str, resident: bool, monkeypatch,
           seed: int = 9) -> dict:
    for mod in (j_snapshot, t_snapshot):   # one clock for both packages
        monkeypatch.setattr(mod, "utcnow", lambda: NOW)
    settings = P.settings(rca_backend=backend)
    cluster = P.sim.generate_cluster(num_pods=96, seed=seed)
    target = sorted(cluster.deployments)[0]
    incident = P.sim.inject(cluster, scenario, target,
                            np.random.default_rng(seed))
    db = P.storage.Database(":memory:")
    _DBS.append(db)
    db.create_incident(incident)
    builder = P.graph.GraphBuilder()
    kw = {} if P is J else {"device": "cpu"}
    scorer = None
    if resident:
        cls = P.scorers[backend == "gnn"]
        scorer = cls(builder.store, settings, **kw)
    res = _run(P.wf.run_incident_workflow(
        incident, cluster, db, builder=builder, settings=settings,
        scorer=scorer, **kw))
    hyps = db.hypotheses_for(incident.id)
    rb = db.runbook_for(incident.id)
    return {
        "results": res,
        "hyps": [(h["rule_id"], h["category"], h["confidence"],
                  h["final_score"], h["backend"]) for h in hyps],
        "runbook": (rb["title"], [(s["order"], s["title"], s["description"],
                                   s["commands"]) for s in rb["steps"]])
        if rb else None,
        "actions": [(a["action_type"], a["status"])
                    for a in db.actions_for(incident.id)],
        "status": db.get_incident(incident.id)["status"],
        "healed": all(p.ready for p in cluster.list_pods(
            incident.namespace, incident.service)),
    }


@pytest.mark.parametrize("backend,scenario,resident", [
    ("tpu", "crashloop_deploy", True), ("tpu", "crashloop_deploy", False),
    ("tpu", "imagepull", True), ("gnn", "crashloop_deploy", True),
    ("gnn", "oom", False)])
def test_workflow_matches_jax(backend, scenario, resident, monkeypatch):
    want = _drive(J, backend, scenario, resident, monkeypatch)
    got = _drive(T, backend, scenario, resident, monkeypatch)
    mode = "streaming" if resident else ("top" if backend == "tpu" else "gnn")
    for out in (want, got):
        gen = out["results"]["generate_hypotheses"]
        assert gen["backend"] == backend and gen["mode"] == mode
    if backend == "tpu":
        assert got["hyps"] == want["hyps"]
    else:
        assert [h[0] for h in got["hyps"]] == [h[0] for h in want["hyps"]]
        assert [h[1] for h in got["hyps"]] == [h[1] for h in want["hyps"]]
        for g, w in zip(got["hyps"], want["hyps"]):
            assert abs(g[2] - w[2]) <= 1e-5 and abs(g[3] - w[3]) <= 1e-5
    assert got["hyps"], "no hypotheses"
    for k in ("runbook", "actions", "status", "healed"):
        assert got[k] == want[k], k
    for step in ("evaluate_policy", "request_approval", "verify_remediation",
                 "close_incident"):
        assert got["results"][step] == want["results"][step], step
    if scenario == "crashloop_deploy":
        assert got["status"] == "resolved" and got["healed"]


# -- the worker and the app --------------------------------------------------------

def _cluster():
    return t_simulator.generate_cluster(num_pods=96, seed=9)


@pytest.mark.parametrize("backend,cls", [("tpu", TScorer),
                                         ("gnn", TGnnScorer), ("cpu", None)])
def test_worker_serving_scorer_is_the_ports(backend, cls):
    db = t_storage.Database(":memory:")
    _DBS.append(db)
    worker = t_workflow.IncidentWorker(_cluster(), db, settings=T.settings(
        rca_backend=backend), device="cpu")
    scorer = worker.serving_scorer()
    if cls is None:
        assert scorer is None
    else:
        assert type(scorer) is cls and scorer.device.type == "cpu"
        assert worker.serving_scorer() is scorer     # built once


@pytest.mark.parametrize("override,item", [
    (dict(shield_enabled=True, mesh_dp=2), "item 9"),
    (dict(mesh_dp=2), "item 9"),
    (dict(serve_graph_shards=2), "item 9"), ("surge", "item 7")])
def test_unported_settings_raise_and_name_their_item(override, item,
                                                     tmp_path):
    db = t_storage.Database(":memory:")
    _DBS.append(db)
    if override != "surge":
        # items 9a and 9c landed: the rules backend serves on a mesh of
        # the pool's positions (tests/test_torch_sharded_streaming.py),
        # shielded too (tests/test_torch_mesh_shield.py)
        from kubernetes_aiops_evidence_graph_tpu_torch.parallel import (
            mesh as pmesh)
        from kubernetes_aiops_evidence_graph_tpu_torch.rca.shield import (
            ShieldedScorer)
        settings = T.settings(shield_dir=str(tmp_path), **override)
        pool = dict(pmesh._HOST_POOL)
        pmesh._HOST_POOL.update(devices=2, committed=False)
        try:
            worker = t_workflow.IncidentWorker(
                _cluster(), db, settings=settings, device="cpu")
            scorer = worker.serving_scorer()
            assert scorer.mesh.size == 2
            assert isinstance(scorer, ShieldedScorer) == bool(
                settings.shield_enabled)
            worker.close()
            t_app.AiopsApp(_cluster(), settings, db=db, device="cpu")
        finally:
            pmesh._HOST_POOL.clear()
            pmesh._HOST_POOL.update(pool)
        return
    if override == "surge":
        # item 7 landed: a surge fleet is taken, not refused
        from kubernetes_aiops_evidence_graph_tpu_torch.rca.surge import (
            SurgeServer)
        srv = SurgeServer(T.settings(), device="cpu")
        worker = t_workflow.IncidentWorker(_cluster(), db,
                                           settings=T.settings(), surge=srv,
                                           tenant="w", device="cpu")
        app = t_app.AiopsApp(_cluster(), T.settings(), db=db, surge=srv,
                             device="cpu")
        assert worker.surge is srv and app.surge is srv
        assert sorted(srv.fleet()["placement"]) == ["default", "w"]
        return
    settings = T.settings(**override)
    surge = None
    with pytest.raises(NotImplementedError, match=item):
        t_workflow.IncidentWorker(_cluster(), db, settings=settings,
                                  surge=surge, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        t_app.AiopsApp(_cluster(), settings, db=db, surge=surge,
                       device="cpu")


@pytest.mark.parametrize("env,item", [
    ({"KAEG_NUM_PROCESSES": "2"}, "item 9")])
def test_main_refuses_what_is_not_ported(env, item, monkeypatch):
    """What ``main()`` refused as item 9 now serves: with
    ``KAEG_NUM_PROCESSES`` set it first forms the process group
    (``parallel.init_distributed``, JAX app.py:441), then builds and
    starts the app (stubbed here) and stops it on Ctrl-C."""
    from kubernetes_aiops_evidence_graph_tpu_torch import parallel as t_par
    from kubernetes_aiops_evidence_graph_tpu_torch.config import settings as cs
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []

    class App:
        def __init__(self, cluster, settings):
            calls.append(("app", settings.cluster_backend))

        def start(self):
            calls.append("start")
            return 0

        def stop(self):
            calls.append("stop")

    def interrupted():
        raise KeyboardInterrupt

    monkeypatch.setattr(t_par, "init_distributed",
                        lambda: calls.append("init") or True)
    monkeypatch.setattr(t_app, "AiopsApp", App)
    monkeypatch.setattr(t_app, "threading", SimpleNamespace(
        Event=lambda: SimpleNamespace(wait=interrupted)))
    cs.get_settings.cache_clear()
    try:
        t_app.main()
    finally:
        cs.get_settings.cache_clear()
    assert calls == ["init", ("app", "fake"), "start", "stop"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without CUDA: checks that the default device raises")
def test_entry_points_default_to_cuda_and_raise_without_it():
    db = t_storage.Database(":memory:")
    _DBS.append(db)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_app.AiopsApp(_cluster(), T.settings(), db=db)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_workflow.IncidentWorker(_cluster(), db, settings=T.settings())
    inc = t_simulator.inject(_cluster(), "oom", "default/svc-0",
                             np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run(t_workflow.run_incident_workflow(
            inc, _cluster(), db, settings=T.settings()))


def test_corrupt_checkpoint_serves_the_counted_rules_fallback(tmp_path):
    bad = tmp_path / "gnn.npz"
    bad.write_bytes(b"not a checkpoint")
    settings = T.settings(rca_backend="gnn", gnn_checkpoint=str(bad))
    cluster = _cluster()
    inc = t_simulator.inject(cluster, "crashloop_deploy",
                             sorted(cluster.deployments)[0],
                             np.random.default_rng(9))
    db = t_storage.Database(":memory:")
    _DBS.append(db)
    db.create_incident(inc)
    before = t_metrics.SHIELD_TIER_TRANSITIONS.value(tier="rules_fallback")
    worker = t_workflow.IncidentWorker(cluster, db, settings=settings,
                                       device="cpu")
    scorer = worker.serving_scorer()
    assert type(scorer) is TScorer
    assert t_metrics.SHIELD_TIER_TRANSITIONS.value(
        tier="rules_fallback") == before + 1
    res = _run(t_workflow.run_incident_workflow(
        inc, cluster, db, builder=worker.builder, settings=settings,
        scorer=scorer, device="cpu"))
    gen = res["generate_hypotheses"]
    assert gen["backend"] == "gnn" and gen["mode"] == "streaming"
    assert gen["top_rule"] == "crashloop_recent_deploy"
    assert {h["backend"] for h in db.hypotheses_for(inc.id)} == {"tpu"}


# -- C1: one backend per (name, device), as the JAX package's get_backend ---------

def test_get_backend_memoizes_one_backend_per_name_and_device(monkeypatch):
    from kubernetes_aiops_evidence_graph_tpu_torch import rca as t_rca
    monkeypatch.setattr(t_rca, "_INSTANCES", {})
    builds = t_rca.builds
    tpu = t_rca.get_backend("tpu", device="cpu")
    assert t_rca.get_backend("tpu", device=torch.device("cpu")) is tpu
    gnn = t_rca.get_backend("gnn", device="cpu")
    assert t_rca.get_backend("gnn", device="cpu") is gnn is not tpu
    cpu = t_rca.get_backend("cpu")
    assert t_rca.get_backend("cpu", device="cpu") is cpu
    assert (tpu.name, gnn.name) == ("tpu", "gnn")
    assert t_rca.builds == builds + 3
    with pytest.raises(KeyError, match="unknown rca backend"):
        t_rca.get_backend("nope")


def test_learned_workflow_loads_its_checkpoint_once(monkeypatch):
    """Several incidents through the worker on ``rca_backend="gnn"``: the
    resident scorer loads the checkpoint once and the verdict backend
    (``get_backend("gnn")``) once, where a backend built per incident
    loaded it once per verdict."""
    from kubernetes_aiops_evidence_graph_tpu_torch import rca as t_rca
    from kubernetes_aiops_evidence_graph_tpu_torch.rca import gnn_backend
    monkeypatch.setattr(t_rca, "_INSTANCES", {})
    loads = []
    real = gnn_backend.load_validated_checkpoint
    monkeypatch.setattr(gnn_backend, "load_validated_checkpoint",
                        lambda path: loads.append(path) or real(path))
    cluster = _cluster()
    keys = sorted(cluster.deployments)
    rng = np.random.default_rng(4)
    incidents = [t_simulator.inject(cluster, name, keys[i], rng)
                 for i, name in enumerate(("crashloop_deploy", "oom",
                                           "imagepull", "network"))]
    db = t_storage.Database(":memory:")
    _DBS.append(db)
    for inc in incidents:
        db.create_incident(inc)
    worker = t_workflow.IncidentWorker(cluster, db, settings=T.settings(
        rca_backend="gnn"), device="cpu")
    assert _run(worker.run_all(incidents)) == {"completed": 4, "failed": 0}
    assert type(worker.scorer) is TGnnScorer
    for inc in incidents:
        hyps = db.hypotheses_for(inc.id)
        assert hyps and {h["backend"] for h in hyps} == {"gnn"}
    assert len(loads) == 2
    assert [k[0] for k in t_rca._INSTANCES] == ["gnn"]


def test_incident_from_row_rehydrates_the_stored_incident():
    cluster = _cluster()
    inc = t_simulator.inject(cluster, "oom", sorted(cluster.deployments)[0],
                             np.random.default_rng(1))
    db = t_storage.Database(":memory:")
    _DBS.append(db)
    db.create_incident(inc)
    back = t_worker._incident_from_row(db.get_incident(inc.id))
    assert back.model_dump(mode="json") == inc.model_dump(mode="json")


# -- the scorer seams: absorb() and serving_node_id() ------------------------------

@pytest.mark.parametrize("cls", [TScorer, TGnnScorer], ids=["rules", "gnn"])
def test_absorb_submits_one_tick_or_yields_when_busy(cls):
    from kubernetes_aiops_evidence_graph_tpu_torch.collectors import (
        collect_all, default_collectors)
    settings = T.settings(ingest_max_journal_backlog=0)
    cluster = _cluster()
    builder = t_graph.GraphBuilder()
    scorer = cls(builder.store, settings, device="cpu")
    inc = t_simulator.inject(cluster, "oom", sorted(cluster.deployments)[0],
                             np.random.default_rng(2))
    builder.ingest(inc, collect_all(inc, default_collectors(cluster, settings),
                                    parallel=False))
    nid = f"incident:{inc.id}"
    assert scorer.serving_node_id(nid, tenant="t0") == nid
    out = scorer.absorb()
    assert out["dispatched"] and scorer.dispatches == 1
    assert scorer._journal_backlog() == 0
    served = scorer.serve(newest=True)
    assert served["newest_fetch"] and nid in served["incident_ids"]
    # busy: the serving lock is held; a backlog within the bound yields,
    # one past it drains synchronously once the lock frees
    more = t_simulator.inject(cluster, "crashloop_deploy",
                              sorted(cluster.deployments)[1],
                              np.random.default_rng(3))
    builder.ingest(more, collect_all(more, default_collectors(
        cluster, settings), parallel=False))
    scorer._max_journal_backlog = 10 ** 9
    with scorer.serve_lock:
        busy = scorer.absorb()
    assert busy["busy"] and busy["backlog"] > 0 and scorer.absorb_busy == 1
    scorer._max_journal_backlog = 0
    scorer.serve_lock.acquire()
    import threading
    threading.Timer(0.05, scorer.serve_lock.release).start()
    drained = scorer.absorb()
    assert drained["dispatched"] and scorer.absorb_sync_drains == 1
    assert scorer._journal_backlog() == 0
    fresh = cls(builder.store, settings, device="cpu").rescore()
    out = scorer.serve(newest=True)
    assert list(out["incident_ids"]) == list(fresh["incident_ids"])
    key = "probs" if cls is TGnnScorer else "scores"
    np.testing.assert_allclose(out[key], fresh[key], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("crash_after", ["collect_evidence",
                                         "request_approval"])
def test_resume_after_crash_matches_jax(crash_after, monkeypatch):
    """A worker dies after ``crash_after``; a fresh context resumes from the
    journal: build_graph re-ingests the persisted evidence and graph
    payload, the later steps rehydrate the hypotheses and the action from
    storage (``model_validate`` where the JAX package has pydantic coerce),
    and both packages finish the incident the same way."""
    for mod in (j_snapshot, t_snapshot):
        monkeypatch.setattr(mod, "utcnow", lambda: NOW)
    out = []
    for P in (J, T):
        settings = P.settings(rca_backend="tpu")
        cluster = P.sim.generate_cluster(num_pods=96, seed=9)
        incident = P.sim.inject(cluster, "crashloop_deploy",
                                sorted(cluster.deployments)[0],
                                np.random.default_rng(9))
        db = P.storage.Database(":memory:")
        _DBS.append(db)
        db.create_incident(incident)
        kw = {} if P is J else {"device": "cpu"}
        steps = P.wf.incident_steps(settings)
        upto = [s.name for s in steps].index(crash_after) + 1
        ctx = P.wf.IncidentContext(incident=incident, cluster=cluster, db=db,
                                   builder=P.graph.GraphBuilder(),
                                   settings=settings, **kw)
        engine = P.wf.WorkflowEngine(db)
        _run(engine.run(f"incident-{incident.id}", steps[:upto], ctx))
        res = _run(P.wf.run_incident_workflow(
            incident, cluster, db, builder=P.graph.GraphBuilder(),
            settings=settings, engine=engine, **kw))
        out.append(({k: v for k, v in res["build_graph"].items()}
                    if crash_after == "collect_evidence" else None,
                    res["generate_hypotheses"]["top_rule"],
                    res["execute_remediation"]["status"],
                    res["close_incident"]["status"],
                    [(a["action_type"], a["status"])
                     for a in db.actions_for(incident.id)]))
    assert out[1] == out[0]
    assert out[0][1:4] == ("crashloop_recent_deploy", "completed", "resolved")
