"""The single-tenant scorer's slot-space seams (the allocation, store and
id hooks ``rca/surge.MultiTenantScorer`` overrides), ``FeatureStage
.discard_range`` and the ``_screen_delta`` signature, against the JAX
package.

Routing the base scorer's allocation through the seams must leave it
exactly as it was: over a seeded full-mix churn drained through the store
journal, its verdicts, its resident tensors and its free lists equal the
JAX ``StreamingScorer``'s (whose allocation runs through the same seams)
at every caller boundary, and its last serve equals a fresh rebuild."""
import numpy as np
import pytest

from kubernetes_aiops_evidence_graph_tpu_torch.observability.metrics import (
    SERVE_BATCH_INCIDENTS)
from kubernetes_aiops_evidence_graph_tpu_torch.rca import streaming as st
from tests import torch_surge_world as W

RESIDENT = ("_features_dev", "_ev_idx_dev", "_ev_cnt_dev", "_pair_dev")


def _churned(pkg, events=300, batch=25, seed=21):
    """A 120-pod world drained through the journal (store_step + sync) in
    ticks of ``batch`` events; returns the scorer, its serves and the
    store."""
    cfg = W.settings(pkg, node_bucket_sizes=(256, 512, 1024),
                     incident_bucket_sizes=(4, 8, 32))
    stream_mod = W.mod(pkg, "simulator.stream")
    cluster, builder, incs = W.world(pkg, seed, incidents=3, pods=120,
                                     cfg=cfg)
    sc = W.single(pkg, builder.store, cfg, now_s=cluster.now.timestamp())
    outs = [sc.serve()]
    stream = list(stream_mod.churn_events(
        cluster, events, seed=seed + 1,
        incident_ids=tuple(f"incident:{i.id}" for i in incs)))
    for n, i in enumerate(range(0, len(stream), batch)):
        for ev in stream[i:i + batch]:
            stream_mod.store_step(cluster, builder.store, ev)
        sc.sync()
        sc.tick_async()
        if n % 4 == 3:
            outs.append(sc.serve(newest=True))
    outs.append(sc.serve())
    return sc, outs, builder.store, cfg, cluster.now.timestamp()


def test_single_scorer_through_the_seams_equals_jax_and_a_rebuild():
    jax_sc, jax_outs, *_ = _churned(W.JAX_PKG)
    sc, outs, store, cfg, now_s = _churned(W.PORT_PKG)
    assert sc.rebuilds == jax_sc.rebuilds
    assert len(outs) == len(jax_outs) > 3
    for a, b in zip(outs, jax_outs):
        assert W.by_id(a, values=True) == W.by_id(b, values=True)
    for name in RESIDENT:
        np.testing.assert_array_equal(
            getattr(sc, name).numpy(), np.asarray(getattr(jax_sc, name)),
            err_msg=name)
    assert sc._free_node_rows == jax_sc._free_node_rows
    assert sc._free_inc_rows == jax_sc._free_inc_rows
    assert (sc.width, sc.pair_width) == (jax_sc.width, jax_sc.pair_width)
    fresh = W.single(W.PORT_PKG, store, cfg, now_s=now_s).serve()
    assert W.by_id(outs[-1]) == W.by_id(fresh)


def test_seam_defaults_serve_one_store():
    _, builder, incs = W.world(W.PORT_PKG, seed=3, incidents=1)
    sc = W.single(W.PORT_PKG, builder.store, W.settings())
    bare = str(incs[0].id)
    nid = f"incident:{bare}"
    assert sc._graph_size() == 1 and sc._tenant_count() == 1
    assert sc.serving_node_id(nid, tenant="t9") == nid
    assert sc._canon_incident_id(bare) == nid == sc._canon_incident_id(nid)
    assert sc._store_node(nid) is builder.store._nodes[nid]
    assert sc._store_node("nope") is None
    free = list(sc._free_node_rows)
    assert sc._node_row_available("any")
    row = sc._take_node_row("any")
    assert row == free[-1]
    sc._put_node_row(row)
    assert sc._free_node_rows == free
    r = sc._take_inc_row("any")
    sc._put_inc_row(r)
    assert sc._inc_row_available("any") and sc._free_inc_rows[-1] == r


def _staged(pkg, dim=5, rows=(9, 3, 40, 3, 17, 0, 63, 22)):
    stage = W.mod(pkg, "rca.streaming").FeatureStage(dim, capacity=2)
    for j, row in enumerate(rows):
        stage[row] = np.full(dim, j, np.float32) + row / 100
    return stage


@pytest.mark.parametrize("lo,hi", [(100, 200), (10, 41), (0, 64)])
def test_discard_range_matches_jax_feature_stage(lo, hi):
    mine, ref = _staged(W.PORT_PKG), _staged(W.JAX_PKG)
    assert mine.discard_range(lo, hi) == ref.discard_range(lo, hi)
    assert mine.keys() == ref.keys() and len(mine) == len(ref)
    mine[5] = np.ones(5, np.float32)      # a surviving slot map still works
    ref[5] = np.ones(5, np.float32)
    for stage in (mine, ref):
        if len(stage) > 1:
            stage[stage.keys()[0]] = np.zeros(5, np.float32)
    outs = []
    for stage in (mine, ref):
        idx, rows = np.empty(16, np.int32), np.empty((16, 5), np.float32)
        outs.append((stage.drain_into(idx, rows, 99), idx, rows))
    assert outs[0][0] == outs[1][0]
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    np.testing.assert_array_equal(outs[0][2], outs[1][2])


def test_base_screen_delta_raises_nonfinite_and_passes_finite_through():
    _, builder, _ = W.world(W.PORT_PKG, seed=4, incidents=1)
    sc = W.single(W.PORT_PKG, builder.store, W.settings())
    f_idx = np.array([3, 7, 256, 256], np.int32)
    rows = np.zeros((4, 48), np.float32)
    assert sc._screen_delta(f_idx, rows, None) == (f_idx, rows)
    rows[1, 2] = np.nan
    got = sc._screen_delta(f_idx, rows, None)      # guard off: untouched
    assert got[0] is f_idx and got[1] is rows
    sc.finite_delta_guard = True
    with pytest.raises(st.NonFiniteDelta, match="1 non-finite"):
        sc._screen_delta(f_idx, rows, None)
    rows[1, 2] = 0.0
    got = sc._screen_delta(f_idx, rows, None)
    assert got[0] is f_idx and got[1] is rows


def test_guarded_dispatch_still_raises_on_a_poisoned_row():
    _, builder, _ = W.world(W.PORT_PKG, seed=5, incidents=1)
    sc = W.single(W.PORT_PKG, builder.store, W.settings())
    sc.serve()
    sc.finite_delta_guard = True
    sc._pending_feat[2] = np.full(sc.snapshot.features.shape[1], np.inf,
                                  np.float32)
    with pytest.raises(st.NonFiniteDelta):
        sc.rescore()
    assert np.isfinite(sc._features_dev.numpy()).all()


def test_compact_delta_keeps_the_live_prefix_in_order():
    s_idx = np.array([4, 9, 9, 2, 9, 9], np.int32)     # 9: the sentinel
    s_rows = np.arange(12, dtype=np.float32).reshape(6, 2)
    idx = np.full(6, -1, np.int32)
    rows = np.full((6, 2), -1.0, np.float32)
    assert st._compact_delta(s_idx, s_rows, idx, rows, 9) == 2
    assert idx.tolist() == [4, 2, 9, 9, 9, 9]
    assert rows.tolist() == [[0, 1], [6, 7], [0, 0], [0, 0], [0, 0], [0, 0]]


def test_batch_histogram_labels_the_tenant_count():
    _, builder, _ = W.world(W.PORT_PKG, seed=6, incidents=2)
    sc = W.single(W.PORT_PKG, builder.store, W.settings())
    key = tuple(sorted({"tenants": "1"}.items()))
    n0 = SERVE_BATCH_INCIDENTS._totals.get(key, 0)
    sc.serve()
    assert SERVE_BATCH_INCIDENTS._totals.get(key, 0) == n0 + 1
