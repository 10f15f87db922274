"""Live tenant migration in the port's ``SurgeServer`` fleet against the
JAX package's: a migration keeps the tenant's verdicts bit-identical and
its ownership exactly-once, also in the middle of a churn, and a crash at
any of the three handoff boundaries (the fault injector's ``migrate``
stage) recovers, through the fleet WAL, to exactly one owner."""
import os

import pytest

from kubernetes_aiops_evidence_graph_tpu_torch.rca.faults import (
    Fault, FaultInjector, InjectedFault)
from tests import torch_surge_world as W
from tests.torch_surge_world import FLEET, fleet3, server


def _verdicts(pack, tenant, values=False):
    return W.tenant_verdicts(pack, values=values).get(tenant, {})


def test_tenant_migration_live_parity_and_exactly_once():
    """migrate() moves a tenant between LIVE packs: the fleet WAL's intent
    before any mutation, the source's incremental repack, the
    destination's adopt; the verdicts are bit-identical across the
    handoff and the tenant has exactly one owner before and after."""
    srv, stores = fleet3()
    p0, p1 = srv.scorer("t0"), srv.scorer("t2")
    before = _verdicts(p0, "t1")
    gen0 = srv.generation
    res = srv.migrate("t1", 1)
    assert res["moved"] and srv.migrations == 1
    assert srv.generation == gen0 + 1
    assert srv.fleet()["placement"]["t1"] == 1
    assert "t1" not in p0.tenant_rows(p0.serve())
    dst = srv.scorer("t1")
    assert dst is p1 and _verdicts(dst, "t1") == before
    kinds = [r["kind"] for r in srv._fleet_journal.replay()]
    assert kinds == ["migrate_intent", "migrate_commit"]
    assert _verdicts(p0, "t0") == _verdicts(srv.scorer("t0"), "t0")
    assert srv.migrate("t1", 1) == {"tenant": "t1", "src": 1, "dst": 1,
                                    "moved": False}
    with pytest.raises(ValueError):
        srv.migrate("t1", 2)
    with pytest.raises(KeyError):
        srv.migrate("nobody", 0)
    W.assert_snapshot_parity(dst, {t: stores[t] for t in ("t1", "t2")},
                             W.settings())


@pytest.mark.parametrize("boundary", [0, 1, 2],
                         ids=["journal-append", "source-repack",
                              "destination-adopt"])
def test_crash_mid_migration_recovers_to_exactly_one_owner(boundary,
                                                           tmp_path):
    """A crash after the WAL intent, after the source repack or after the
    destination adopt: a fresh SurgeServer over the same WAL rolls the
    intent forward, the tenant has exactly one owner with the same bits,
    no tenant is lost or duplicated, and the placement equals the JAX
    fleet's after the same crash."""
    placements = {}
    for pkg in (W.JAX_PKG, W.PORT_PKG):
        path = os.path.join(tmp_path, f"{pkg}.jsonl")
        srv, stores = fleet3(pkg, journal_path=path)
        srv.scorer("t0")
        srv.scorer("t2")
        before = _verdicts(srv.scorer("t1"), "t1", values=True)
        faults = W.mod(pkg, "rca.faults")
        srv.fault_injector = faults.FaultInjector(
            [faults.Fault("migrate", at=boundary)])
        with pytest.raises(faults.InjectedFault):
            srv.migrate("t1", 1)
        srv2 = server(pkg, path, **FLEET)
        for t, store in stores.items():
            srv2.register(t, store)
        fleet = srv2.fleet()
        placements[pkg] = fleet["placement"]
        assert fleet["placement"]["t1"] == 1
        owners = [p for p, info in fleet["packs"].items()
                  if "t1" in info["tenants"]]
        assert owners == ["1"] and sorted(fleet["placement"]) == [
            "t0", "t1", "t2"]
        assert _verdicts(srv2.scorer("t1"), "t1", values=True) == before
        src = srv2.scorer("t0")
        assert "t1" not in src.tenant_rows(src.serve())
    assert placements[W.PORT_PKG] == placements[W.JAX_PKG]


def test_migration_mid_churn_keeps_parity_with_the_single_scorer():
    """A tenant migrated between two churn phases: before, during and
    after, its verdicts from its owning pack equal a single-tenant scorer
    on its store, bit for bit, and the JAX fleet serves the same values
    after the same steps."""
    out = {}
    for pkg in (W.JAX_PKG, W.PORT_PKG):
        stream = W.mod(pkg, "simulator.stream")
        cfg = W.settings(pkg, **FLEET)
        srv = server(pkg, **FLEET)
        worlds = {f"m{i}": W.world(pkg, seed=80 + i, incidents=3, pods=80,
                                   cfg=cfg) for i in range(3)}
        for t, (_c, b, _i) in worlds.items():
            srv.register(t, b.store)
        single = (W.single(pkg, worlds["m1"][1].store, cfg)
                  if pkg == W.PORT_PKG else None)
        streams = {t: list(stream.churn_events(
            c, 120, seed=90 + i,
            incident_ids=tuple(f"incident:{x.id}" for x in incs)))
            for i, (t, (c, _b, incs)) in enumerate(worlds.items())}
        seen = []
        for r in range(12):
            for t, (c, b, _i) in worlds.items():
                for ev in streams[t][r * 10:(r + 1) * 10]:
                    stream.store_step(c, b.store, ev)
            if r == 6:
                srv.migrate("m1", 1)
            owner = srv.scorer("m1")
            owner.sync()
            owner.tick_async()
            if r % 3 == 2:
                raw = owner.serve(newest=True)
                seen.append(W.tenant_verdicts(owner, raw, values=True)["m1"])
                if single is not None:
                    assert W.tenant_verdicts(owner, raw)["m1"] == W.by_id(
                        single.serve(newest=True)), r
        out[pkg] = (seen, srv.fleet()["placement"])
    assert out[W.PORT_PKG] == out[W.JAX_PKG]


def test_fault_stage_visits_three_boundaries_per_migration():
    """One ``migrate`` stage, three visits a migration: a fault at visit 3
    (the next migration's first boundary) leaves the first migration
    whole."""
    srv, _ = fleet3()
    srv.scorer("t0")
    srv.scorer("t2")
    srv.fault_injector = FaultInjector([Fault("migrate", at=3)])
    srv.migrate("t1", 1)
    assert srv.fault_injector.visits["migrate"] == 3
    with pytest.raises(InjectedFault):
        srv.migrate("t1", 0)
    kinds = [r["kind"] for r in srv._fleet_journal.replay()]
    assert kinds == ["migrate_intent", "migrate_commit", "migrate_intent"]
