"""The port's ``SurgeServer`` fleet (``rca/surge.py``) against the JAX
package's: registration and lazy repack, greedy bin-packing across packs,
load-driven placement, ``GET /api/v1/fleet``, and the workflow workers
serving two tenants off one pack (``workflow/worker.py``'s surge path)."""
import asyncio
import json
import logging
import threading
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from kubernetes_aiops_evidence_graph_tpu_torch.ingestion.api import (
    make_server)
from kubernetes_aiops_evidence_graph_tpu_torch.observability import (
    metrics as obs_metrics)
from kubernetes_aiops_evidence_graph_tpu_torch.rca.surge import (
    MultiTenantScorer, SurgeServer)
from tests import torch_surge_world as W

def _get(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/v1/fleet",
                                timeout=30) as r:
        return json.loads(r.read())


def _serve_http(app):
    http = make_server(app, "127.0.0.1", 0)
    threading.Thread(target=http.serve_forever, daemon=True).start()
    return http, http.server_address[1]


def test_surge_server_registration_and_repack():
    """Late registration marks the pack stale; scorer() repacks over the
    full tenant set and bumps the generation; the same store again is a
    no-op, another store for a registered tenant is refused."""
    w0 = W.world(W.PORT_PKG, seed=60, incidents=1)[1].store
    w1 = W.world(W.PORT_PKG, seed=61, incidents=1)[1].store
    srv = W.server()
    srv.register("a", w0)
    sc1 = srv.scorer()
    assert srv.fresh() and sc1._tenant_count() == 1
    assert sc1.device.type == "cpu"
    srv.register("b", w1)
    assert not srv.fresh()
    sc2 = srv.scorer()
    assert sc2 is not sc1 and sc2._tenant_count() == 2
    assert srv.generation == 2 and srv.fresh()
    srv.register("a", w0)
    assert srv.fresh()
    with pytest.raises(ValueError):
        srv.register("a", w1)
    with pytest.raises(KeyError):
        srv.scorer("nobody")


def test_fleet_binpacks_tenants_across_packs():
    """3 tenants at pack_tenants=2 land as {pack0: t0 t1, pack1: t2}, as
    in the JAX fleet; scorer(tenant) resolves the owning pack and each
    pack's telemetry carries its own label."""
    srv, stores = W.fleet3()
    jsrv, _ = W.fleet3(W.JAX_PKG)
    p0, p2 = srv.scorer("t0"), srv.scorer("t2")
    assert srv.scorer("t1") is p0 and p0 is not p2
    assert srv.scorer() is p0
    assert (p0._scope_pack, p2._scope_pack) == ("0", "1")
    assert (p0.scope.pack, p2.scope.pack) == ("0", "1")
    jsrv.scorer("t0")
    jsrv.scorer("t2")
    fleet, jfleet = srv.fleet(), jsrv.fleet()
    assert fleet == jfleet
    assert fleet["packs"]["0"]["tenants"] == ["t0", "t1"]
    assert fleet["placement"] == {"t0": 0, "t1": 0, "t2": 1}
    assert obs_metrics.FLEET_PACKS.value() == 2.0 and srv.fresh()
    per = p0.tenant_rows(p0.serve())
    W.assert_snapshot_parity(p0, {t: stores[t] for t in ("t0", "t1")},
                             W.settings(), p0.serve())
    assert set(per) == {"t0", "t1"}


def test_fleet_places_new_tenant_on_least_loaded_pack():
    """With every pack at capacity a new tenant lands on the least-loaded
    one (admitted-rows/s EWMA from the store-journal cursors, injectable
    clock); the loads equal the JAX fleet's on the same journals."""
    loads = {}
    for pkg in (W.JAX_PKG, W.PORT_PKG):
        srv = W.server(pkg, swell_max_packs=2, swell_pack_tenants=1)
        c0, b0, _ = W.world(pkg, seed=3, incidents=2)
        srv.register("t0", b0.store)
        srv.register("t1", W.world(pkg, seed=14, incidents=2)[1].store)
        assert srv.fleet()["placement"] == {"t0": 0, "t1": 1}
        srv.sample_loads(now_s=0.0)
        W.inject_more(pkg, c0, b0, W.settings(pkg), seed=7, count=1)
        loads[pkg] = srv.sample_loads(now_s=1.0)
        assert loads[pkg]["t0"] > 0.0 and loads[pkg].get("t1", 0.0) == 0.0
        srv.register("t2", W.world(pkg, seed=25, incidents=2)[1].store)
        assert srv.fleet()["placement"]["t2"] == 1
    assert loads[W.PORT_PKG] == loads[W.JAX_PKG]


def test_fleet_api_renders_two_migrations_in_order():
    """GET /api/v1/fleet: placement, loads and the history ring with two
    migrations in order; a scale decision rides the same ring, a hold
    does not."""
    srv, _ = W.fleet3()
    http, port = _serve_http(SimpleNamespace(surge=srv))
    try:
        srv.scorer("t0")
        srv.scorer("t2")
        srv.sample_loads(now_s=0.0)
        srv.migrate("t1", 1)
        srv.migrate("t1", 0)
        fleet = _get(port)
        assert fleet["enabled"] is True and fleet["migrations"] == 2
        moves = [h for h in fleet["history"] if h["event"] == "migrate"]
        assert [(m["tenant"], m["src"], m["dst"]) for m in moves] == [
            ("t1", 0, 1), ("t1", 1, 0)]
        assert fleet["placement"]["t1"] == 0
        assert set(fleet["loads"]) <= {"t0", "t1", "t2"}
        srv.note_scale(0, {"action": "hold"})
        srv.note_scale(0, {"action": "scale_up", "plan": {"shards": 2}})
        history = _get(port)["history"]
        assert history[-1]["event"] == "scale_up" and len(history) == 3
    finally:
        http.shutdown()


def test_fleet_api_without_surge_reports_disabled():
    http, port = _serve_http(SimpleNamespace())
    try:
        assert _get(port) == {"enabled": False, "packs": {}, "placement": {},
                              "loads": {}, "history": [], "generation": 0,
                              "migrations": 0}
    finally:
        http.shutdown()


def _worker_settings(**over):
    return W.settings(**{"app_env": "development",
                         "remediation_dry_run": False,
                         "verification_wait_seconds": 0,
                         "node_bucket_sizes": (512, 2048), **over})


def test_workers_share_pack_and_serve_streaming_verdicts():
    """Two per-tenant workers on one SurgeServer serve off the SAME pack:
    every incident takes the streaming path with the scenario's rule, and
    build_graph records its absorb."""
    from kubernetes_aiops_evidence_graph_tpu_torch.simulator import (
        generate_cluster, inject)
    from kubernetes_aiops_evidence_graph_tpu_torch.storage import Database
    from kubernetes_aiops_evidence_graph_tpu_torch.workflow import (
        IncidentWorker)
    cfg = _worker_settings()
    srv = SurgeServer(cfg, device="cpu")
    setups = []
    for t in range(2):
        cluster = generate_cluster(num_pods=60, seed=70 + t)
        rng = np.random.default_rng(70 + t)
        keys = sorted(cluster.deployments)
        db = Database(":memory:")
        worker = IncidentWorker(cluster, db, settings=cfg, concurrency=2,
                                surge=srv, tenant=f"tenant-{t}",
                                device="cpu")
        incs = [inject(cluster, s, keys[i * 3], rng)
                for i, s in enumerate(["crashloop_deploy", "oom"])]
        for inc in incs:
            db.create_incident(inc)
        setups.append((worker, db, incs))

    async def go():
        return await asyncio.gather(
            *[w.run_all(incs) for w, _db, incs in setups])

    try:
        stats = asyncio.new_event_loop().run_until_complete(go())
        assert all(s == {"completed": 2, "failed": 0} for s in stats)
        w0, w1 = setups[0][0], setups[1][0]
        assert w0.scorer is w1.scorer
        assert type(w0.scorer) is MultiTenantScorer
        assert w0.scorer._tenant_count() == 2
        expect = {"crashloop_deploy": "crashloop_recent_deploy",
                  "oom": "oom_killed"}
        for worker, db, incs in setups:
            for inc, scen in zip(incs, ["crashloop_deploy", "oom"]):
                rows = db.hypotheses_for(inc.id)
                assert rows and rows[0]["rule_id"] == expect[scen]
                j = db.journal_get(f"incident-{inc.id}")
                assert j["generate_hypotheses"]["result"]["mode"] == \
                    "streaming"
                assert "absorbed" in j["build_graph"]["result"]
    finally:
        for _worker, db, _incs in setups:
            db.close()


def test_surge_worker_resolves_the_pack_once_and_warns_off_the_rules_path():
    """A surge worker resolves its pack once per slot (the fast path);
    under a learned backend the surge is dropped with the reference's
    warning and the worker keeps its own resident scorer; a shielded surge
    worker serves from the pack unshielded, with its warning."""
    from kubernetes_aiops_evidence_graph_tpu_torch.simulator import (
        generate_cluster, inject)
    from kubernetes_aiops_evidence_graph_tpu_torch.storage import Database
    from kubernetes_aiops_evidence_graph_tpu_torch.workflow import (
        IncidentWorker)
    cluster = generate_cluster(num_pods=80, seed=80)
    rng = np.random.default_rng(80)
    keys = sorted(cluster.deployments)
    incs = [inject(cluster, s, keys[i * 3], rng)
            for i, s in enumerate(["oom", "network", "hpa_maxed"])]
    cfg = _worker_settings(remediation_dry_run=True)
    srv = SurgeServer(cfg, device="cpu")
    db = Database(":memory:")
    events: list[str] = []
    warned = logging.Handler()
    warned.emit = lambda record: events.append(record.getMessage())
    try:
        for inc in incs:
            db.create_incident(inc)
        worker = IncidentWorker(cluster, db, settings=cfg, concurrency=1,
                                surge=srv, tenant="solo", device="cpu")
        loop = asyncio.new_event_loop()
        stats = loop.run_until_complete(worker.run_all(incs))
        assert stats == {"completed": 3, "failed": 0}
        assert worker.scorer_resolutions == 1
        assert worker.scorer is srv.scorer("solo")
        # a tenant registered later makes the fleet stale: the next
        # incident resolves the repacked pack (the reference's fast path)
        stale = worker.scorer
        srv.register("late", W.world(W.PORT_PKG, seed=81)[1].store)
        more = inject(cluster, "oom", keys[5], rng)
        db.create_incident(more)
        stats = loop.run_until_complete(worker.run_all([more]))
        assert stats == {"completed": 4, "failed": 0}
        assert worker.scorer_resolutions == 2
        assert worker.scorer is srv.scorer("solo") is not stale
        assert worker.scorer._tenant_count() == 2
        logging.getLogger("kaeg.worker").addHandler(warned)
        gnn = IncidentWorker(cluster, db, settings=_worker_settings(
            rca_backend="gnn"), surge=srv, tenant="g", device="cpu")
        shielded = IncidentWorker(
            cluster, db, builder=worker.builder, settings=_worker_settings(
                shield_enabled=True), surge=srv, tenant="solo",
            device="cpu")
        assert shielded.serving_scorer() is srv.scorer("solo")
        assert gnn.surge is None and "g" not in srv.fleet()["placement"]
        assert events == ["surge_requires_tpu_backend",
                          "surge_shield_unsupported"]
    finally:
        logging.getLogger("kaeg.worker").removeHandler(warned)
        db.close()
