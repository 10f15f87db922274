"""Load-driven scaling on a mesh (tests/test_swell.py): the shield's
``scale_mesh`` round trip 1 → 2 → 1 mid-churn, bit-equal to a scorer
that never scaled and to fresh builds, with the JAX package's verdicts;
its journal replay after a kill; the targets it refuses; and the elastic
controller stepping a real shielded scorer 1 → 2 → 4 → 2 over a pool of
positions under a forced signal, its ladder shrinking with the
exclusions."""
from __future__ import annotations

import pytest

from kubernetes_aiops_evidence_graph_tpu_torch.parallel.compat import Sharded
from kubernetes_aiops_evidence_graph_tpu_torch.rca.elastic import (
    ElasticController)
from kubernetes_aiops_evidence_graph_tpu_torch.simulator.stream import (
    store_step)
from tests import torch_mesh_world as M

# node buckets of powers of two: over a pool of four the divisor ladder
# is (1, 2, 4)
POW2 = dict(node_bucket_sizes=(512, 2048), incident_bucket_sizes=(8, 32))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The never-scaled port run at D = 1, held to the JAX package's
    depth-1 run over the same world and script."""
    ref = M.run(tmp_path_factory.mktemp("d1"), shards=1)
    M.assert_equal_jax(ref.out, M.jax_fresh(tmp_path_factory, 1),
                       "D=1 vs the JAX package")
    return ref


def test_scale_round_trip_bit_identical(reference, tmp_path):
    """Scale up to (1 x 2) after tick 1 and back to one device after tick
    3: every scale journals its record before it applies and moves the
    home shard count, and the verdicts equal the never-scaled run's and a
    fresh D = 2 build's on the final store."""
    plans = []

    def during(i, shield):
        if i in (1, 3):
            plans.append(shield.scale_mesh(2 if i == 1 else 1))
            if i == 1:
                assert isinstance(shield.scorer._features_dev, Sharded)
    got = M.run(tmp_path, shards=1, during=during)
    sh = got.shield
    assert [(p["from_shards"], p["shards"], p["direction"], p["heal_gen"])
            for p in plans] == [(1, 2, "up", 1), (2, 1, "down", 2)]
    assert sh.scale_events == 2 and sh._mesh_home == 1
    assert sh.scorer.mesh is None
    M.assert_same(got.out, reference.out, "scaled 1-2-1 vs never scaled")
    M.assert_same(got.out, M.fresh(M.PORT_PKG, got, 2), "vs fresh D=2")


def test_scale_replays_from_the_journal_after_a_kill(reference, tmp_path):
    """A scale to D = 2 journaled after the last snapshot, then more
    churn, then a kill: a fresh D = 1 scorer and shield recover onto the
    journaled shard count and home, replaying the later deltas onto it."""
    got = M.run(tmp_path, shards=1, close=False, ticks=3)
    sh = got.shield
    cluster, builder, cfg, _ = got.world
    sh.scale_mesh(2)
    for ev in got.stream[3 * M.BATCH:]:
        store_step(cluster, builder.store, ev)
    sh.sync()
    sh.close()
    fresh = M.make_scorer(M.PORT_PKG, builder.store, cfg,
                          cluster.now.timestamp())
    shield2 = M.shield_of(M.PORT_PKG, fresh, cfg, tmp_path)
    try:
        res = shield2.recover()
        assert res["replayed"] > 0
        assert fresh._graph_size() == 2 and shield2._mesh_home == 2
        out = shield2.rescore()
    finally:
        shield2.close()
    M.assert_same(out, reference.out, "recovered onto the scaled mesh")


def test_scale_mesh_rejects_bad_targets(tmp_path):
    """A target the node bucket does not divide (or below one) is a
    ValueError, one the non-excluded pool cannot carry a RuntimeError,
    the current count a no-op; nothing of them reaches the journal."""
    got = M.run(tmp_path, shards=4, close=False, events=40)
    sh = got.shield
    try:
        pn = sh.scorer.snapshot.padded_nodes
        assert pn == 384
        for bad in (5, 0, -2):
            with pytest.raises(ValueError, match="does not divide"):
                sh.scale_mesh(bad)
        with pytest.raises(RuntimeError, match="exceeds 8"):
            sh.scale_mesh(12)
        assert sh.scale_mesh(4) is None
        sh.mesh_heal(exclude_devices=(5, 6))
        assert sh.scorer._graph_size() == 3
        with pytest.raises(RuntimeError, match="exceeds 6"):
            sh.scale_mesh(8)
        assert sh._heal_gen == 1 and sh.scale_events == 0
        plan = sh.scale_mesh(6)
        assert plan["shards"] == 6 and sh._mesh_excluded == (5, 6)
        assert sh.scorer.mesh.pool_index.ravel().tolist() == [0, 1, 2, 3,
                                                              4, 7]
    finally:
        sh.close()


def test_elastic_controller_steps_a_shielded_scorer(reference, tmp_path):
    """The controller over a real shield on a pool of four positions and
    a forced signal: hot steps 1 → 2 → 4 (then holds at the top), cold
    steps 4 → 2, each through ``scale_mesh`` after ``prewarm`` built the
    target mesh; the scorer keeps serving the never-scaled verdicts. An
    exclusion shrinks the ladder."""
    cfg = M.settings(shards=1, elastic_enabled=True, elastic_dwell_s=0.0,
                     elastic_cooldown_s=0.0, **POW2)
    got = M.run(tmp_path, shards=1, cfg=cfg, close=False)
    sh = got.shield
    try:
        sh._pool = M.POOL[:4]
        ec = ElasticController(sh, cfg)
        assert ec.ladder() == (1, 2, 4)
        hot = {"occupancy": 1.0, "stall_delta_s": 0.0, "shed_ewma": 0.0,
               "roofline_drift": 0.0}
        cold = dict(hot, occupancy=0.0)
        seen = []
        for sig in (hot, hot, hot, cold):
            ec.signals = lambda sig=sig: dict(
                sig, shards=sh.scorer._graph_size())
            dec = ec.observe()
            seen.append((dec["action"], sh.scorer._graph_size()))
        assert seen == [("scale_up", 2), ("scale_up", 4), ("hold", 4),
                        ("scale_down", 2)]
        assert ec.stats()["scale_ups"] == 2 and sh.scale_events == 3
        M.assert_same(sh.rescore(), reference.out, "elastic 1-2-4-2")
        sh.mesh_heal(positions=(0,))
        assert ec.ladder() == (1, 2) and sh.scorer._graph_size() == 1
        with pytest.raises(RuntimeError, match="cannot carry"):
            ec.prewarm(4)
        assert ec.prewarm(2).pool_index.ravel().tolist() == [1, 2]
    finally:
        sh.close()
