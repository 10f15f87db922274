"""Per-tenant failure isolation of the port's ``MultiTenantScorer``
against the JAX package's: a poisoned staged row quarantines only its
tenant and the next serve heals it from its store; a truncated journal
does the same; tenants join and leave a running pack by the incremental
repack, the others' verdicts untouched."""
import numpy as np
import pytest

from kubernetes_aiops_evidence_graph_tpu_torch.observability.metrics import (
    SERVE_TENANT_QUARANTINES, SERVE_TENANT_REBUILDS)
from kubernetes_aiops_evidence_graph_tpu_torch.observability.scope import (
    FLIGHT_RECORDER)
from kubernetes_aiops_evidence_graph_tpu_torch.rca.surge import (
    split_tenant_id)
from tests import torch_surge_world as W


def _packs(seeds, incidents=1, **over):
    out = {}
    for pkg in (W.JAX_PKG, W.PORT_PKG):
        cfg = W.settings(pkg, **over)
        worlds = {f"q{i}": W.world(pkg, seed=s, incidents=incidents, cfg=cfg)
                  for i, s in enumerate(seeds)}
        stores = {t: w[1].store for t, w in worlds.items()}
        out[pkg] = (W.pack(pkg, stores, cfg), worlds, stores, cfg)
    return out


def _poison(mt, tenant, offset=3):
    reg = mt.regions[tenant]
    mt._pending_feat[reg.node_base + offset] = np.full(
        mt.snapshot.features.shape[1], np.nan, np.float32)


def test_tenant_quarantine_isolates_poison_and_heals():
    """One tenant's non-finite staged row quarantines ONLY that tenant:
    the shared tick proceeds, the poison never reaches the resident state,
    the next serve heals the region from store truth, and the healed
    verdicts equal the snapshot path's and the JAX pack's after the same
    steps."""
    packs = _packs([40, 41])
    outs = {}
    for pkg, (mt, _w, _s, _c) in packs.items():
        mt.finite_delta_guard = True
        mt.serve()
        _poison(mt, "q1")
        outs[pkg] = [mt.serve()]
    mt, _worlds, stores, cfg = packs[W.PORT_PKG]
    assert mt.regions["q1"].quarantined and not mt.regions["q0"].quarantined
    assert any(split_tenant_id(i)[0] == "q0"
               for i in outs[W.PORT_PKG][0]["incident_ids"])
    assert np.isfinite(mt._features_dev.numpy()).all()
    events = [r for r in FLIGHT_RECORDER.snapshot()
              if r.get("event") == "tenant_quarantined"
              and r.get("tenant") == "q1"]
    assert events and events[-1]["reason"] == "nonfinite_delta"
    q0 = SERVE_TENANT_QUARANTINES.value(tenant="q1")
    r0 = SERVE_TENANT_REBUILDS.value(tenant="q1")
    for pkg, (pmt, *_rest) in packs.items():
        outs[pkg].append(pmt.serve())
    assert not mt.regions["q1"].quarantined and mt.tenant_rebuilds == 1
    assert SERVE_TENANT_REBUILDS.value(tenant="q1") == r0 + 1
    assert SERVE_TENANT_QUARANTINES.value(tenant="q1") == q0
    W.assert_snapshot_parity(mt, stores, cfg, outs[W.PORT_PKG][-1])
    jmt = packs[W.JAX_PKG][0]
    for a, b in zip(outs[W.PORT_PKG], outs[W.JAX_PKG]):
        assert W.tenant_verdicts(mt, a, values=True) == W.tenant_verdicts(
            jmt, b, values=True)


def test_quarantine_scrubs_only_its_region():
    """Quarantine drops the tenant's staged feature rows and dirty
    incident rows, and nothing of the other tenants'."""
    mt = _packs([42, 43, 44])[W.PORT_PKG][0]
    mt.serve()
    dim = mt.snapshot.features.shape[1]
    regs = mt._regions_order
    for reg in regs:
        mt._pending_feat[reg.node_base + 1] = np.ones(dim, np.float32)
        mt._pending_feat[reg.node_base + 2] = np.ones(dim, np.float32)
        mt._dirty_rows.add(reg.inc_base)
    mt.quarantine("q1", "test")
    kept = mt._pending_feat.keys()
    assert kept == [regs[0].node_base + 1, regs[0].node_base + 2,
                    regs[2].node_base + 1, regs[2].node_base + 2]
    assert mt._dirty_rows == {regs[0].inc_base, regs[2].inc_base}
    assert mt.regions["q1"].heal_pending and mt.quarantines == 1
    mt.quarantine("q1", "again")          # idempotent: counted once
    assert mt.quarantines == 1 and mt.regions["q1"].quarantines == 1


def test_truncated_journal_quarantines_and_heals_only_its_tenant():
    """A tenant whose journal evicted unseen records is quarantined and
    healed from its store at that sync; the others drain as usual."""
    packs = _packs([45, 46])
    for pkg, (mt, worlds, _stores, cfg) in packs.items():
        mt.serve()
        cluster, builder, _ = worlds["q0"]
        W.inject_more(pkg, cluster, builder, cfg, seed=47, count=1)
        store = builder.store
        # evict every record the pack has not drained yet
        seq = store.journal_seq
        store._journal.clear()
        store._jrec("node~", "nobody")
        assert store.journal_since(mt.regions["q0"].synced_seq)[2]
        assert seq < store.journal_seq
    mt, _worlds, stores, cfg = packs[W.PORT_PKG]
    res = mt.sync()
    packs[W.JAX_PKG][0].sync()
    assert res["healed"] == 1 and mt.tenant_rebuilds == 1
    assert mt.regions["q0"].quarantines == 1
    assert mt.regions["q1"].quarantines == 0
    raw = mt.serve()
    W.assert_snapshot_parity(mt, stores, cfg, raw)
    assert W.tenant_verdicts(mt, raw, values=True) == W.tenant_verdicts(
        packs[W.JAX_PKG][0], values=True)


def test_add_and_remove_tenant_keep_the_others_bits():
    """A tenant leaves (its region drops out, its staged rows with it)
    and another joins (only it is tensorized): every remaining tenant's
    verdicts equal the snapshot path's and the JAX pack's after the same
    moves; the last tenant cannot leave."""
    packs = _packs([48, 49, 50], incidents=2)
    extra = {pkg: W.world(pkg, seed=51, incidents=2)[1].store
             for pkg in packs}
    for pkg, (mt, *_rest) in packs.items():
        mt.serve()
        reg = mt.regions["q1"]
        mt._pending_feat[reg.node_base + 1] = np.ones(
            mt.snapshot.features.shape[1], np.float32)
        assert mt.remove_tenant("q1") is packs[pkg][2]["q1"]
        mt.add_tenant("new", extra[pkg])
    mt, _worlds, stores, cfg = packs[W.PORT_PKG]
    assert len(mt._pending_feat) == 0
    assert [r.name for r in mt._regions_order] == ["q0", "q2", "new"]
    assert mt.partial_repacks == 2
    raw = mt.serve()
    W.assert_snapshot_parity(mt, {"q0": stores["q0"], "q2": stores["q2"],
                                  "new": extra[W.PORT_PKG]}, cfg, raw)
    assert W.tenant_verdicts(mt, raw, values=True) == W.tenant_verdicts(
        packs[W.JAX_PKG][0], values=True)
    with pytest.raises(ValueError):
        mt.add_tenant("new", extra[W.PORT_PKG])
    with pytest.raises(KeyError):
        mt.remove_tenant("q1")
    for t in ("q0", "q2"):
        mt.remove_tenant(t)
    with pytest.raises(ValueError, match="last tenant"):
        mt.remove_tenant("new")


def test_graph_sharded_pack_delta_names_item_9():
    """Item 9a landed: a graph-sharded pack's routed ``[G, pk]`` delta
    (shard-local indices) is screened as JAX rca/surge.py:628-660 screens
    it: the poisoned row dropped to the shard's sentinel and zeroed, its
    tenant quarantined, the other shard's rows kept."""
    packs = _packs([52, 53])
    mt, jmt = packs[W.PORT_PKG][0], packs[W.JAX_PKG][0]
    rows = np.zeros((2, 4, mt.snapshot.features.shape[1]), np.float32)
    rows[1, 2, 0] = np.inf
    nps = mt.snapshot.padded_nodes // 2
    idx = np.full((2, 4), nps, np.int32)
    idx[0, 0], idx[1, 2] = 3, 5
    for m in (mt, jmt):
        m.finite_delta_guard = True
    s_idx, s_rows = mt._screen_delta(idx, rows, None)
    j_idx, j_rows = jmt._screen_delta(idx, rows, None)
    np.testing.assert_array_equal(s_idx, j_idx)
    np.testing.assert_array_equal(s_rows, j_rows)
    assert s_idx[0, 0] == 3 and s_idx[1, 2] == nps
    assert np.isfinite(s_rows).all() and not s_rows[1, 2].any()
    owner = mt._region_of_node_row(nps + 5).name
    assert mt.regions[owner].quarantined
    assert [r.name for r in mt._regions_order if r.quarantined] == [
        r.name for r in jmt._regions_order if r.quarantined] == [owner]
    assert mt._graph_size() == 1