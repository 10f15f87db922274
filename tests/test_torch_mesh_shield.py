"""The crash shield around a scorer on a graph-sharded mesh
(tests/test_heal.py): re-expansion after the half-open probe, crash
consistency of the heal itself (a crash after it applied, a heal that
reached the journal but never applied, and a kill and restart between a
heal's journal record and its snapshot), and the per-shard attestation
that localizes silent corruption to one block and repairs only that
block. Every outcome is held bit for bit to the never-failed D = 4 run
(and to the JAX package's verdicts through it)."""
from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu_torch.observability import (
    metrics as t_metrics)
from kubernetes_aiops_evidence_graph_tpu_torch.parallel.compat import Sharded
from kubernetes_aiops_evidence_graph_tpu_torch.rca.faults import FaultInjector
from kubernetes_aiops_evidence_graph_tpu_torch.rca.shield import ShieldedScorer
from tests import torch_mesh_world as M


@pytest.fixture(scope="module")
def baselines(tmp_path_factory):
    """The never-failed port run at D = 4, held to the JAX package's
    depth-1 run at D = 4 over the same world and script."""
    ref = M.run(tmp_path_factory.mktemp("d4"), shards=4)
    assert ref.shield.heals == 0 and ref.shield.recoveries == 0
    M.assert_equal_jax(ref.out, M.jax_fresh(tmp_path_factory, 4),
                       "D=4 vs the JAX package at D=4")
    return ref


def test_reexpansion_bit_identical_to_never_failed(baselines, tmp_path):
    """D' → D once the lost position's breaker admits its half-open probe:
    back at D = 4 with nothing excluded, the probe closed by the next
    clean pass, verdicts bit-equal to never-failed D = 4 serving."""
    r0 = t_metrics.MESH_REEXPANSIONS.value()
    cfg = M.settings(shards=4, mesh_heal_cooldown_s=0.01)
    got = M.run(tmp_path, shards=4, faults=[M.SHARD_LOSS], cfg=cfg,
                sleep_s=0.02)
    sh = got.shield
    assert sh.heals == 1 and sh.reexpansions == 1, sh.stats()
    assert t_metrics.MESH_REEXPANSIONS.value() == r0 + 1
    assert sh.scorer._graph_size() == 4 and sh._mesh_excluded == ()
    assert sh.scorer.mesh.pool_index.ravel().tolist() == [0, 1, 2, 3]
    assert sh.health.stats() == {"live": {}, "excluded": {},
                                 "shard_failures": 3}
    M.assert_same(got.out, baselines.out, "re-expanded vs never failed")


def test_crash_mid_heal_recovers_consistent_shard_count(baselines, tmp_path):
    """(a) a crash AFTER the heal applied recovers straight to D' = 3 (the
    snapshot records its mesh shape); (b) a heal that reached the journal
    but never applied replays during recovery, landing on its journaled
    shard count (D'' = 2 around pool indices 2 and 3) with parity."""
    got = M.run(tmp_path, shards=4, faults=[M.SHARD_LOSS], close=False)
    sh = got.shield
    try:
        assert sh.heals == 1
        FaultInjector._corrupt_resident(sh.scorer)
        res = sh.recover()
        assert res["mode"] == "journal_replay"
        assert sh.scorer._graph_size() == 3 and sh._mesh_excluded == (2,)
        M.assert_same(sh.rescore(), baselines.out, "recovered at D'=3")
        s = sh.scorer
        sh.journal.append((), int(s._synced_seq), int(s._synced_seq),
                          kind="mesh_heal", force_sync=True, shards=2,
                          exclude=(2, 3), from_shards=3,
                          heal_gen=sh._heal_gen + 1)
        FaultInjector._corrupt_resident(s)
        sh.recover()
        assert s._graph_size() == 2 and sh._mesh_excluded == (2, 3)
        assert s.mesh.pool_index.ravel().tolist() == [0, 1]
        M.assert_same(sh.rescore(), baselines.out, "journal-only heal")
    finally:
        sh.close()


def test_restart_between_heal_record_and_snapshot(baselines, tmp_path):
    """Kill and restart between a heal's journal record and the snapshot
    that covers it: a fresh D = 4 scorer and shield on the directory load
    the D = 4 snapshot, replay the heal record to D' = 3 and the later
    deltas onto it, and serve the never-failed run's verdicts."""
    from kubernetes_aiops_evidence_graph_tpu_torch.simulator.stream import (
        store_step)
    got = M.run(tmp_path, shards=4, close=False, ticks=3)
    sh = got.shield
    cluster, builder, cfg, _ = got.world
    sh.mesh_heal(positions=(2,))
    for ev in got.stream[3 * M.BATCH:]:
        store_step(cluster, builder.store, ev)
    sh.sync()                       # journaled and applied, no snapshot
    sh.close()                      # the kill: nothing more is written
    assert sh.journal.load_snapshot()["mesh_shards"] == 4
    fresh = M.make_scorer(M.PORT_PKG, builder.store, cfg,
                          cluster.now.timestamp())
    assert fresh._graph_size() == 4
    shield2 = M.shield_of(M.PORT_PKG, fresh, cfg, tmp_path)
    try:
        res = shield2.recover()
        assert res["mode"] == "journal_replay" and res["replayed"] > 0
        assert fresh._graph_size() == 3 and shield2._mesh_excluded == (2,)
        assert shield2._heal_gen == 1
        out = shield2.rescore()
    finally:
        shield2.close()
    M.assert_same(out, baselines.out, "restarted after the heal record")


def test_attestation_localizes_silent_shard_corruption(baselines, tmp_path):
    """A SILENT single-shard corruption (nothing raises; the rules fold
    absorbs NaN through its threshold compares) is flagged by the
    per-shard attestation at the next snapshot boundary, localized to
    exactly that shard and repaired from the host mirrors: no rebuild,
    no heal, parity intact. Seeded: replay with KAEG_CHAOS_SEED=<seed>."""
    seed = int(os.environ.get("KAEG_CHAOS_SEED", "20260805"))
    rng = np.random.default_rng(seed)
    shard, visit = int(rng.integers(0, 4)), int(rng.integers(1, 3))
    m0 = {k: t_metrics.MESH_ATTEST_MISMATCH.value(shard=str(k))
          for k in range(4)}
    got = M.run(tmp_path, shards=4, faults=[dict(
        stage="shard_loss", at=visit, kind="shard_corrupt_silent",
        shard=shard)])
    sh = got.shield
    assert sh.injector.fired, f"seed {seed}: corruption never fired"
    assert sh.attest_repairs >= 1
    for k in range(4):
        grew = t_metrics.MESH_ATTEST_MISMATCH.value(shard=str(k)) > m0[k]
        assert grew == (k == shard), f"seed {seed}: shard {k}"
    assert sh.scorer.rebuilds == 0 and sh.heals == 0
    M.assert_same(got.out, baselines.out, "attested vs never failed")


def test_attestation_repairs_only_the_poisoned_block(tmp_path):
    """Poison one position's block on its own device: the fold flags that
    block alone, the repair re-uploads it from host truth in place, and
    the other blocks are not written (their storage and bits unchanged);
    a clean state attests clean."""
    got = M.run(tmp_path, shards=4, close=False, events=40)
    sh = got.shield
    try:
        s = sh.scorer
        with s.serve_lock:
            assert sh._attest_and_repair() == ()
            feats = s._features_dev
            assert isinstance(feats, Sharded)
            before = [(b.data_ptr(), b.clone()) for b in feats.blocks[0]]
            assert FaultInjector._corrupt_shard(s, 6) == 2
            assert torch.isnan(feats.blocks[0, 2]).all()
            assert sh._attest_and_repair() == (2,)
            for k, (ptr, bits) in enumerate(before):
                blk = feats.blocks[0, k]
                assert blk.data_ptr() == ptr
                assert torch.equal(blk.view(torch.int32),
                                   bits.view(torch.int32)), k
            assert sh._attest_and_repair() == ()
        assert sh.health.stats()["live"][2] == "closed"
    finally:
        sh.close()


def test_snapshot_records_the_mesh_and_packs_blocks_in_order(tmp_path):
    """The snapshot names the mesh it was captured at (shards, exclusions,
    home, heal generation) and packs each sharded table whole, its blocks
    in position order: a heal re-places the same state, so the D' = 3
    pack equals the D = 4 pack just before it."""
    from kubernetes_aiops_evidence_graph_tpu_torch.rca import shield as ts
    got = M.run(tmp_path, shards=4, close=False, events=40)
    sh = got.shield
    try:
        s = sh.scorer
        d4 = ts._snapshot_pack(*s._resident_arrays())
        sh.mesh_heal(positions=(1,))
        assert s._features_dev.blocks.shape == (1, 3)
        assert torch.equal(ts._snapshot_pack(*s._resident_arrays()), d4)
        sh.snapshot_now()
        state = sh.journal.load_snapshot()
        assert (state["mesh_shards"], state["mesh_exclude"],
                state["mesh_home"], state["heal_gen"]) == (3, (1,), 4, 1)
        assert np.array_equal(state["flat"], d4.numpy())
        assert sh.stats()["serving_shards"] == 3
        assert sh.stats()["mesh_excluded"] == (1,)
    finally:
        sh.close()


def test_a_mesh_over_two_cards_is_refused_before_the_journal(tmp_path,
                                                            monkeypatch):
    """On a host with two cards a CUDA shield's default pool is every
    card (as JAX's ``jax.devices()``), and the survivor mesh over that
    pool plans a two-card D' without adopting it: nothing is journaled
    or adopted by the plan, so a later recovery replays no heal."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    fake = SimpleNamespace(_pool=None, scorer=SimpleNamespace(
        device=torch.device("cuda", 1)))
    assert ShieldedScorer.pool.fget(fake) == cards
    got = M.run(tmp_path, shards=1, close=False, events=40)
    sh = got.shield
    try:
        s = sh.scorer
        sh._pool = list(cards)
        mesh = sh._survivor_mesh(2, ())
        assert mesh.shape == {"dp": 1, "graph": 2}
        assert list(mesh.devices.ravel()) == cards
        assert mesh.pool_index.ravel().tolist() == [0, 1]
        with pytest.raises(RuntimeError, match="no survivor mesh"):
            sh._survivor_mesh(2, (0,))
        batches, _torn = sh.journal.read()
        assert not [b for b in batches if b.kind == "mesh_heal"]
        assert (s.mesh, sh._heal_gen, sh.scale_events) == (None, 0, 0)
        assert sh.recover()["mode"] == "journal_replay"
        assert s._graph_size() == 1
        M.assert_same(sh.rescore(), M.fresh(M.PORT_PKG, got, 1), "D=1")
    finally:
        sh.close()


def test_randomized_shard_loss_chaos_sweep(baselines, tmp_path):
    """A seeded schedule mixing shard_loss with the classic tick stages at
    D = 4: parity holds wherever it lands. Seeded: replay with
    KAEG_CHAOS_SEED=<seed>."""
    seed = int(os.environ.get("KAEG_CHAOS_SEED", "20260805"))
    got = M.run(tmp_path, shards=4, seeded=dict(
        seed=seed, ticks=M.EVENTS // M.BATCH + 1, rate=0.25,
        stages=("staging", "dispatch", "shard_loss", "journal_append"),
        shards=4))
    M.assert_same(got.out, baselines.out, f"chaos seed {seed}")
    assert np.isfinite(np.asarray(got.out["scores"])).all()
