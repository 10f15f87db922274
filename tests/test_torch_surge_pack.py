"""The port's ``MultiTenantScorer`` (``rca/surge.py``; on the CPU its tick
runs ``kernels/rules_fold``'s plain version) against the JAX package's on
the same tenant stores, against the port's single-tenant scorers and
against the snapshot path: the contracts of ``tests/test_surge.py``
(batched verdicts bit-identical at every rung of the incident ladder,
device passes bounded by the incident bucket, the incremental repack and
the drain of the regions it kept, the batch telemetry, the newest-tick
fetch), then a seeded churn over four
tenants checked after every serve, and ``chip_smoke.py``'s phase 17
rehearsed at a small size."""
import math

import numpy as np
import pytest
import torch

import chip_smoke
from kubernetes_aiops_evidence_graph_tpu_torch.observability.metrics import (
    SERVE_BATCH_INCIDENTS, SERVE_TENANT_QUEUE_DEPTH)
from kubernetes_aiops_evidence_graph_tpu_torch.observability.scope import (
    FLIGHT_RECORDER)
from kubernetes_aiops_evidence_graph_tpu_torch.utils.padding import bucket_for
from tests import torch_surge_world as W


def _twin(seeds, incidents, cfg_over=None, pods=36):
    """The same tenant worlds in both packages, packed."""
    out = {}
    for pkg in (W.JAX_PKG, W.PORT_PKG):
        cfg = W.settings(pkg, **(cfg_over or {}))
        worlds = {f"t{i}": W.world(pkg, seed=s, incidents=incidents,
                                   pods=pods, cfg=cfg)
                  for i, s in enumerate(seeds)}
        stores = {t: w[1].store for t, w in worlds.items()}
        out[pkg] = (W.pack(pkg, stores, cfg), worlds, stores, cfg)
    return out


@pytest.mark.parametrize("incidents", [2, 9])
def test_batched_verdicts_bit_parity_at_every_rung(incidents):
    """2 incidents a tenant land in the 8-rung, 9 in the 32-rung (4/3
    slack): every rung of the incident ladder. The pack's one-pass
    verdicts equal the JAX pack's, each tenant's own single-tenant
    scorer's and its snapshot path's, bit for bit."""
    twin = _twin(range(3), incidents)
    mt, _worlds, stores, cfg = twin[W.PORT_PKG]
    jmt = twin[W.JAX_PKG][0]
    rung = bucket_for(int(np.ceil(incidents * 4 / 3)),
                      cfg.incident_bucket_sizes)
    headroom = bucket_for(rung + 1, cfg.incident_bucket_sizes)
    assert [r.pi for r in mt._regions_order] == [headroom] * 3
    assert [(r.pn, r.pi) for r in mt._regions_order] == [
        (r.pn, r.pi) for r in jmt._regions_order]
    raw = mt.serve()
    got = W.assert_snapshot_parity(mt, stores, cfg, raw)
    assert W.tenant_verdicts(mt, raw, values=True) == W.tenant_verdicts(
        jmt, values=True)
    for t, store in stores.items():
        assert W.by_id(W.single(W.PORT_PKG, store, cfg).serve()) == got[t]
    assert mt.dispatches >= 1 and mt._tenant_count() == 3


def test_device_passes_bounded_by_incident_bucket():
    """A multi-tenant burst of I concurrent incidents costs at most
    ceil(I / bucket) verdict passes, and the whole burst fewer passes than
    one a incident."""
    cfg = W.settings()
    worlds = {f"t{t}": W.world(W.PORT_PKG, seed=30 + t, incidents=0)
              for t in range(3)}
    stores = {t: w[1].store for t, w in worlds.items()}
    mt = W.pack(W.PORT_PKG, stores, cfg)
    mt.serve()
    d0 = mt.dispatches
    total = 0
    for i, (t, (cluster, builder, _)) in enumerate(worlds.items()):
        W.inject_more(W.PORT_PKG, cluster, builder, cfg, seed=40 + i,
                      count=4)
        total += 4
        mt.absorb()
    absorb_passes = mt.dispatches - d0
    d1 = mt.dispatches
    out = mt.serve(newest=True)
    serve_passes = mt.dispatches - d1
    assert len(out["incident_ids"]) == total
    bucket = max(r.pi for r in mt._regions_order)
    assert serve_passes <= math.ceil(total / bucket)
    assert absorb_passes + serve_passes < total
    W.assert_snapshot_parity(mt, stores, cfg)


def test_region_overflow_repacks_incrementally(monkeypatch):
    """A tenant outgrowing its region repacks INCREMENTALLY: only it pays
    a store tensorize, the kept regions move by a row shift, and every
    tenant's verdicts stay bit-identical, also after more churn on a
    shifted region. The JAX pack makes the same moves."""
    import kubernetes_aiops_evidence_graph_tpu_torch.rca.surge as surge_mod
    twin = _twin([100, 101, 102], 1, {"incident_bucket_sizes": (4, 8)})
    for pkg, (mt, *_rest) in twin.items():
        mt.serve()
        assert all(r.pi == 8 for r in mt._regions_order), pkg
    mt, worlds, stores, cfg = twin[W.PORT_PKG]
    calls = []
    real = surge_mod.build_snapshot
    monkeypatch.setattr(surge_mod, "build_snapshot", lambda store, *a, **kw: (
        calls.append(id(store)) or real(store, *a, **kw)))
    for pkg, (pmt, pworlds, _s, pcfg) in twin.items():
        cluster, builder, _ = pworlds["t1"]
        W.inject_more(pkg, cluster, builder, pcfg, seed=101, count=9,
                      first=1)
        pmt.serve()
    monkeypatch.undo()
    jmt = twin[W.JAX_PKG][0]
    assert mt.rebuilds == 1 and mt.partial_repacks == 1
    assert calls == [id(stores["t1"])], "only the overflowing tenant"
    assert [(r.pn, r.pi) for r in mt._regions_order] == [
        (r.pn, r.pi) for r in jmt._regions_order]
    assert mt.regions["t1"].pi > 8
    W.assert_snapshot_parity(mt, stores, cfg)
    for pkg, (pmt, pworlds, _s, pcfg) in twin.items():
        cluster, builder, _ = pworlds["t0"]
        W.inject_more(pkg, cluster, builder, pcfg, seed=102, count=1,
                      first=5, start=300)
    raw = mt.serve()
    W.assert_snapshot_parity(mt, stores, cfg, raw)
    assert W.tenant_verdicts(mt, raw, values=True) == W.tenant_verdicts(
        jmt, values=True)


def test_a_repack_mid_sync_drains_the_kept_regions():
    """An earlier region's overflow repacks in the middle of a sync; a
    region the repack KEPT still drains its journal in that sync, so the
    serve holds a later tenant's new incident (its caller's own write),
    equal to snapshot scoring. The JAX pack returns at the repack and
    serves without it until the next sync (the port's departure); then
    the two agree."""
    twin = _twin([100, 101, 102], 1, {"incident_bucket_sizes": (4, 8)})
    raws = {}
    for pkg, (pmt, pworlds, _s, pcfg) in twin.items():
        pmt.serve()
        cluster, builder, _ = pworlds["t0"]
        W.inject_more(pkg, cluster, builder, pcfg, seed=100, count=9)
        cluster, builder, _ = pworlds["t2"]
        W.inject_more(pkg, cluster, builder, pcfg, seed=102, count=1,
                      start=200)
        raws[pkg] = pmt.serve()
        assert pmt.rebuilds == 1 and pmt.regions["t2"].pi == 8, pkg
    mt, _w, stores, cfg = twin[W.PORT_PKG]
    jmt = twin[W.JAX_PKG][0]
    W.assert_snapshot_parity(mt, stores, cfg, raws[W.PORT_PKG])
    new = "t2::incident:" + str(__import__("uuid").UUID(int=102 * 1000
                                                         + 200))
    assert new in raws[W.PORT_PKG]["incident_ids"]
    assert new not in raws[W.JAX_PKG]["incident_ids"]
    assert W.tenant_verdicts(mt, raws[W.PORT_PKG], values=True) == \
        W.tenant_verdicts(jmt, values=True)


def test_batch_metrics_and_flight_records():
    """The per-pass incident-batch histogram carries the tenant count,
    the per-tenant queue depth is stamped at sync, and batched passes show
    in the flight records (batch_incidents, tenants, pack)."""
    cfg = W.settings(scope_telemetry=True)
    worlds = {f"m{t}": W.world(W.PORT_PKG, seed=50 + t, incidents=2,
                               cfg=cfg) for t in range(3)}
    mt = W.pack(W.PORT_PKG, {t: w[1].store for t, w in worlds.items()},
                cfg)
    mt._scope_pack = mt.scope.pack = "7"
    key = tuple(sorted({"tenants": "3"}.items()))
    n0 = SERVE_BATCH_INCIDENTS._totals.get(key, 0)
    mt.serve()
    assert SERVE_BATCH_INCIDENTS._totals.get(key, 0) == n0 + 1
    for t in worlds:
        assert SERVE_TENANT_QUEUE_DEPTH.value(tenant=t) == 0.0
    recs = [r for r in FLIGHT_RECORDER.snapshot()
            if r.get("tenants") == 3 and r.get("batch_incidents") == 6]
    assert recs and recs[-1]["pack"] == "7"


def test_newest_fetch_matches_fresh_rescore():
    """The deferred newest-tick fetch equals a fresh dispatch over the
    same synced state, on the pack as on a single scorer."""
    worlds = {f"n{t}": W.world(W.PORT_PKG, seed=90 + t, incidents=3)
              for t in range(2)}
    mt = W.pack(W.PORT_PKG, {t: w[1].store for t, w in worlds.items()},
                W.settings())
    mt.absorb()
    newest = mt.serve(newest=True)
    assert newest["newest_fetch"] is True
    fresh = mt.serve()
    assert fresh["newest_fetch"] is False
    assert W.by_id(newest) == W.by_id(fresh)
    assert newest["incident_ids"] == fresh["incident_ids"]


def test_pack_churn_equals_singles_and_jax_after_every_serve():
    """Four tenants under seeded full-mix churn drained through their
    journals (``store_step``), one pack tick a round: at every serve each
    tenant's verdicts equal its single-tenant scorer's bit for bit and the
    JAX pack's by value; the resident state never rebuilt the whole pack."""
    cfgs = {pkg: W.settings(pkg, node_bucket_sizes=(512, 1024, 2048))
            for pkg in (W.JAX_PKG, W.PORT_PKG)}
    runs = {}
    for pkg, cfg in cfgs.items():
        stream = W.mod(pkg, "simulator.stream")
        worlds = {f"c{t}": W.world(pkg, seed=60 + t, incidents=3, pods=120,
                                   cfg=cfg) for t in range(4)}
        stores = {t: w[1].store for t, w in worlds.items()}
        mt = W.pack(pkg, stores, cfg)
        singles = ({t: W.single(pkg, s, cfg) for t, s in stores.items()}
                   if pkg == W.PORT_PKG else {})
        streams = {t: list(stream.churn_events(
            c, 160, seed=70 + i,
            incident_ids=tuple(f"incident:{x.id}" for x in incs)))
            for i, (t, (c, _b, incs)) in enumerate(worlds.items())}
        serves = []
        for r in range(16):
            for t, (c, b, _i) in worlds.items():
                for ev in streams[t][r * 10:(r + 1) * 10]:
                    stream.store_step(c, b.store, ev)
            mt.sync()
            mt.tick_async()
            if r % 4 == 3:
                raw = mt.serve(newest=True)
                serves.append(W.tenant_verdicts(mt, raw, values=True))
                for t, sc in singles.items():
                    assert W.tenant_verdicts(mt, raw)[t] == W.by_id(
                        sc.serve(newest=True)), (r, t)
        runs[pkg] = (mt, serves)
    mt, serves = runs[W.PORT_PKG]
    assert serves == runs[W.JAX_PKG][1]
    assert mt.dispatches == runs[W.JAX_PKG][0].dispatches
    assert mt.quarantines == 0


def test_chip_smoke_surge_phase_rehearsed_on_the_cpu():
    """``chip_smoke.run_surge`` (phase 17) at a small size on the CPU:
    pack parity, quarantine and heal, the fleet's migration and crash
    recovery, the elastic decision and the two-tenant app."""
    res = chip_smoke.run_surge(torch.device("cpu"), num_pods=150,
                               num_incidents=6, events=200, per_round=10,
                               app_pods=96, app_incidents=3)
    assert res["tenants"] == 4 and res["checked_serves"] == 4
    assert res["rules_fold"]["device_passes_ratio"] == pytest.approx(
        0.25, abs=0.02)
    assert res["migration"]["moved"] and res["fleet"]["migrations"] == 1
    assert res["fleet_recovered"]["placement"]["t3"] == 0
    assert res["elastic"]["action"] == "hold"
    assert res["app"]["incidents"] == {"default": 3, "tenant-b": 3}
    assert res["app"]["fleet"]["enabled"] is True
