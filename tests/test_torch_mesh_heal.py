"""Shard-loss survival on a graph-sharded mesh: the port's reshard plan,
survivor mesh and shard classifier against the JAX package's
(``rca/heal.py``), and the shield's ``mesh_heal`` rung
(tests/test_heal.py).

A persistent loss of one position heals a D = 4 rules scorer onto a
survivor mesh at D' = 3, bit-equal to a fresh port D' = 3 build on the
same store and to a scorer that never failed, with the JAX package's
verdicts; a transient fault never reshards; a heal with no survivor
escalates. The learned scorer heals from D = 2 to one device, bit-equal
to a fresh port build and within 1e-5 of the JAX package's."""
from __future__ import annotations

import pytest

from kubernetes_aiops_evidence_graph_tpu.rca import heal as j_heal
from kubernetes_aiops_evidence_graph_tpu_torch.observability import (
    metrics as t_metrics)
from kubernetes_aiops_evidence_graph_tpu_torch.parallel.compat import Sharded
from kubernetes_aiops_evidence_graph_tpu_torch.rca import heal as t_heal
from kubernetes_aiops_evidence_graph_tpu_torch.rca.gnn_backend import (
    SHIPPED_CHECKPOINT, load_validated_checkpoint)
from tests import torch_mesh_world as M
from tests.test_torch_gnn_streaming import _assert_probs


@pytest.fixture(scope="module")
def baselines(tmp_path_factory):
    """The never-failed port run at D = 4, a fresh port D' = 3 build on
    its final store, and the JAX package's depth-1 run at D' = 3 over
    the same world and script."""
    ref = M.run(tmp_path_factory.mktemp("d4"), shards=4)
    assert ref.shield.heals == 0 and ref.shield.recoveries == 0
    s = ref.shield.scorer
    assert isinstance(s._features_dev, Sharded) and s._graph_size() == 4
    fresh3 = M.fresh(M.PORT_PKG, ref, 3)
    M.assert_same(ref.out, fresh3, "fresh D'=3 vs D=4")
    jax3 = M.jax_fresh(tmp_path_factory, 3)
    M.assert_equal_jax(ref.out, jax3, "D=4 vs the JAX package at D'=3")
    return {"ref": ref, "fresh3": fresh3, "jax3": jax3}


def test_plan_reshard_equals_jax():
    cases = [(384, 4, 7), (384, 4, 2), (1024, 4, 7), (1021, 4, 7),
             (384, 2, 7), (65_536, 4, 3), (65_536, 4, 1), (12, 4, 0)]
    for pn, d, survivors in cases:
        assert t_heal.plan_reshard(pn, d, survivors) == \
            j_heal.plan_reshard(pn, d, survivors), (pn, d, survivors)
    assert t_heal.plan_reshard(65_536, 4, 3) == 2
    assert t_heal.plan_reshard(384, 4, 7) == 3


def test_survivor_mesh_keys_on_the_pool_not_the_device():
    """Positions on one card (``[cuda:0] * 4``, built without touching a
    card) are told apart by their pool index; a mesh from another pool
    is not a cached mesh of the first."""
    import torch
    card = [torch.device("cuda", 0)] * 4
    m = t_heal.survivor_mesh(3, (1,), card)
    assert [str(d) for d in m.devices.ravel()] == ["cuda:0"] * 3
    assert [t_heal.device_index(m, p) for p in range(3)] == [0, 2, 3]
    cpu = t_heal.survivor_mesh(3, (1,), M.POOL)
    assert {d.type for d in cpu.devices.ravel()} == {"cpu"}
    assert cpu is not m and t_heal.survivor_mesh(4, (1,), card) is None


def test_shard_health_tracker_decisions_equal_jax():
    """The same failure/clean-pass script drives both classifiers to the
    same verdicts: transient faults reset on a clean pass, N consecutive
    ones open the position, exclusion moves it to its pool index, the
    half-open probe gates re-expansion and rides the new position."""
    import time
    runs = []
    for mod in (t_heal, j_heal):
        tr = mod.ShardHealthTracker(failure_threshold=3, cooldown_s=0.01)
        seen = [tr.record_failure(2), tr.record_failure(2)]
        tr.record_clean_pass()
        seen.append(tr.failed_position())
        seen += [tr.record_failure(2) for _ in range(3)]
        seen += [tr.failed_position(), tr.failed_position(exclude=(2,))]
        tr.exclude(2, 5)
        seen += [tr.excluded_devices(), tr.can_reexpand()]
        time.sleep(0.02)
        seen.append(tr.can_reexpand())
        tr.note_reexpanded({5: 1})
        seen.append(tr.stats())
        tr.record_clean_pass()
        seen.append(tr.stats())
        runs.append(seen)
    assert runs[0] == runs[1]
    assert runs[0][5] == "open" and runs[0][6] == 2
    assert runs[0][-2]["live"] == {1: "half_open"}


def test_persistent_shard_loss_heals_to_survivor_mesh(baselines, tmp_path):
    """THE pin: D = 4 shard loss → D' = 3 on the survivors, bit-equal to
    the fresh D' = 3 build and the never-failed D = 4 run, top-1 equal to
    the JAX package's; the healed features are three node blocks."""
    h0 = t_metrics.MESH_HEALS.value()
    got = M.run(tmp_path, shards=4, faults=[M.SHARD_LOSS])
    sh = got.shield
    assert sh.injector.fired and sh.heals == 1
    assert sh.tier_log[-1] == "mesh_heal", sh.tier_log
    assert t_metrics.MESH_HEALS.value() == h0 + 1
    s = sh.scorer
    assert s._graph_size() == 3 and sh._mesh_excluded == (2,)
    assert s.mesh.pool_index.ravel().tolist() == [0, 1, 3]
    assert isinstance(s._features_dev, Sharded)
    assert s._features_dev.placement.axis == "graph"
    assert s._features_dev.blocks.shape == (1, 3)
    M.assert_same(got.out, baselines["fresh3"], "healed vs fresh D'=3")
    M.assert_same(got.out, baselines["ref"].out, "healed vs never failed")
    M.assert_same(got.out, M.fresh(M.PORT_PKG, got, 3),
                  "healed vs fresh D'=3 on its own store")
    M.assert_equal_jax(got.out, baselines["jax3"], "healed vs JAX D'=3")
    st = sh.stats()
    assert st["serving_shards"] == 3 and st["heals"] == 1
    assert st["shard_health"]["excluded"] == {2: "open"}


def test_transient_shard_fault_recovers_without_resharding(baselines,
                                                           tmp_path):
    """One localized fault (below the threshold) is transient: the replay
    rungs cure it, the mesh stays at D = 4 and parity holds."""
    got = M.run(tmp_path, shards=4, faults=[dict(
        stage="shard_loss", at=2, kind="shard_loss", shard=1)])
    sh = got.shield
    assert sh.injector.fired and sh.heals == 0
    assert "mesh_heal" not in sh.tier_log and sh.recoveries >= 1
    assert sh.scorer._graph_size() == 4
    assert sh.health.stats()["live"] == {}
    M.assert_same(got.out, baselines["ref"].out, "transient vs never failed")


def test_heal_without_a_survivor_escalates(tmp_path):
    """A heal that finds no survivor raises before it journals anything,
    and the ladder's rung reports it so the full rebuild takes over; the
    scorer never leaves its device."""
    got = M.run(tmp_path, shards=2, close=False, events=40)
    sh = got.shield
    try:
        sh._pool = sh.pool[:2]
        before = sh._heal_gen
        with pytest.raises(RuntimeError, match="excluded"):
            sh.mesh_heal(exclude_devices=(0, 1))
        assert sh._heal_gen == before and sh.scorer._graph_size() == 2
        sh._mesh_excluded = (1,)
        assert sh._try_heal(0) is False
        assert sh.scorer.device.type == "cpu" and sh.scorer._graph_size() == 2
    finally:
        sh.close()


@pytest.fixture(scope="module")
def params():
    return load_validated_checkpoint(SHIPPED_CHECKPOINT)


@pytest.mark.parametrize("tier", ["composed", "fused"])
def test_learned_scorer_heals_to_one_device(params, tier, tmp_path,
                                            tmp_path_factory):
    """The learned scorer at D = 2 loses position 1 at its last caller
    boundary: persistently, through the ladder (whose first rung turns
    the fused tick off), or by the operator's ``mesh_heal`` with the fused
    tick on. The heal to D' = 1 re-mirrors the edges from the store, and
    the healed scorer serves a fresh port D' = 1 build's bits, within
    1e-5 of the JAX package's fresh D' = 1 build with the same top-1."""
    over = {"gnn_fused_tick": True} if tier == "fused" else {}
    cfg = M.settings(shards=2, rca_backend="gnn", **over)
    events = 60
    loss = dict(stage="shard_loss", at=events // M.BATCH, kind="shard_loss",
                repeats=3, shard=1)
    got = M.run(tmp_path / "port", faults=[] if over else [loss], cfg=cfg,
                params=params, events=events, close=False)
    sh = got.shield
    try:
        if over:
            assert sh.mesh_heal(positions=(1,))["shards"] == 1
            got.out = sh.rescore()
    finally:
        sh.close()
    assert sh.heals == 1 and sh.scorer.mesh is None
    assert not sh.scorer._mirror_sharded
    assert sh.scorer._use_fused == bool(over)
    fresh = M.fresh(M.PORT_PKG, got, 1, params=params)
    M.assert_same(got.out, fresh, f"{tier}: healed vs fresh D'=1")
    jcfg = M.settings(M.JAX_PKG, 1, depth=1, rca_backend="gnn", **over)
    jax1 = M.run(tmp_path_factory.mktemp("jaxgnn"), M.JAX_PKG, 1, cfg=jcfg,
                 params=params, events=events)
    jfresh = M.fresh(M.JAX_PKG, jax1, 1, params=params)
    _assert_probs(got.out, jfresh, f"{tier}: healed vs the JAX D'=1 build")
