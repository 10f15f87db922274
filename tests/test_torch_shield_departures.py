"""Where the port's crash shield departs from the JAX package's, each
departure held by a test that fails without it (ROADMAP §C):

1. under the shield, the learned scorer's node-removal cascade walks the
   node's edge keys sorted (``make_replayable``): a set rebuilt by
   unpickling can iterate in another order than the live one, and the
   cascade's order sets the free lists;
2. an edge re-mirror (a relation region out of slots, rebuilt from the
   store as it is then) forces a snapshot at the next boundary, and that
   snapshot's persist is tried once more at once if it fails: a replay
   across a re-mirror reads a later store;
3. the finite delta guard screens the padded staged rows, as the JAX
   package's does, so a poisoned delta with no live feature row is
   quarantined too;
4. a restore re-stitches the host feature mirror from the snapshot's
   feature tensor AND the staged rows (``FeatureStage.overlay``): a
   staged row's mirror is its staged value, and the attestation fold
   holds the device to the mirror.
"""
from __future__ import annotations

import pickle
import shutil

import numpy as np
import pytest

from kubernetes_aiops_evidence_graph_tpu_torch.graph.schema import RelationKind
from kubernetes_aiops_evidence_graph_tpu_torch.models.evidence import (
    GraphEntity, GraphRelation)
from kubernetes_aiops_evidence_graph_tpu_torch.rca import shield as t_shield
from kubernetes_aiops_evidence_graph_tpu_torch.rca.faults import Fault
from tests import torch_shield_world as W
from tests.torch_shield_world import params  # noqa: F401  (fixture)


def _shielded(tier, tmp_path, params=None, **over):  # noqa: F811
    cfg = W.settings(tier=tier, **over)
    cluster, builder, _ = W._world(W.PORT_PKG, cfg, num_pods=120)
    scorer = W.make_scorer(W.PORT_PKG, tier, builder.store, cfg,
                           cluster.now.timestamp(), params)
    shield = t_shield.ShieldedScorer(scorer, cfg, directory=str(tmp_path))
    shield.recover_or_snapshot()
    return shield, (cluster, builder, cfg)


def _order_changes_after_pickle(keys, removed) -> bool:
    """Whether a set with this add/discard history iterates its last key
    differently once rebuilt by unpickling (this process's hashes)."""
    s = set()
    for k in keys:
        s.add(k)
    for k in removed:
        s.discard(k)
    back = pickle.loads(pickle.dumps(s))
    return list(s)[-1] != list(back)[-1]


def test_a_node_removal_cascade_replays_in_the_live_order(params,  # noqa: F811
                                                          tmp_path):
    """A hub node gains many SELECTS edges, loses most of them (its edge-key
    set keeps its large table), the snapshot is taken, then the hub is
    removed (the cascade frees its last edges' slots) and new SELECTS
    edges take freed slots. A restart recovers that journal suffix onto
    the unpickled, compact set: with the cascade sorted, its slots and
    packed state equal the live scorer's."""
    shield, world = _shielded("composed", tmp_path / "live", params,
                              shield_snapshot_every_ticks=10 ** 6)
    store, scorer = world[1].store, shield.scorer
    kind = int(RelationKind.SELECTS)
    n = min(24, len(scorer._free_edge_slots[kind]) // 2 - 8)
    assert n >= 12, "premise: room for the hub's edges in the region"
    pods = sorted(nid for nid in scorer._id_to_idx if nid.startswith("pod:"))
    hub, hub2 = "service:hub", "service:hub2"
    keys = [(hub, p, kind) for p in pods[:n]]
    # the hub keeps a window of k of its edges: the first window whose
    # set iterates its last key differently once unpickled, under this
    # process's string hashes
    removed = next(rest for k in range(3, 9) for j in range(n - k + 1)
                   for rest in [keys[:j] + keys[j + k:]]
                   if _order_changes_after_pickle(keys, rest))
    try:
        store.upsert_entities([GraphEntity(id=h, type="Service")
                               for h in (hub, hub2)])
        store.upsert_relations(GraphRelation(source_id=hub, target_id=p,
                                             relation_type="SELECTS")
                               for p in pods[:n])
        shield.rescore()
        for (_h, p, _k) in removed:
            store.remove_relation(hub, p, "SELECTS")
        shield.rescore()
        shield.snapshot_now()
        store.remove_node(hub)
        store.upsert_relations(GraphRelation(source_id=hub2, target_id=p,
                                             relation_type="SELECTS")
                               for p in pods[n:n + 4])
        live = W.Run(shield.rescore(), shield, W.packed(scorer), world)
    finally:
        shield.close()
    _res, restarted = W.restart(tmp_path / "live", "composed", live, params)
    W.assert_same(restarted, live, "restart across a hub's cascade")


def test_a_recovery_never_replays_across_an_edge_remirror(params,  # noqa: F811
                                                          tmp_path):
    """Churn at a size where a relation region runs out of slots: the
    batch that re-mirrors forces a snapshot, whose first persist fails
    (an injected snapshot-write crash); the next tick loses the device.
    The recovery starts from the snapshot past the re-mirror, so the run
    ends bit-identical to the unfaulted one. Without the forced snapshot
    (or with its persist given up), it would replay the re-mirror onto a
    later store."""
    cfg = W.settings(tier="composed", shield_snapshot_every_ticks=10 ** 6)
    mirrors = []
    W.run(tmp_path / "probe", "composed", params=params, cfg=cfg,
          events=400, during=lambda i, sh: mirrors.append(
              (sh.scorer.mirror_builds, sh.scorer.rebuilds)))
    at = next(i for i, (m, _r) in enumerate(mirrors) if m > 1)
    # the runs end one tick after the re-mirror: a later store-derived
    # rebuild would re-derive the layout and hide a replay's
    assert mirrors[at + 1] == (2, 0), mirrors
    events = (at + 2) * W.BATCH
    ref = W.run(tmp_path / "ref", "composed", params=params, cfg=cfg,
                events=events)

    def arm(i, shield):
        inj = shield.injector
        if i == at - 1:
            inj.faults.append(Fault("snapshot_write",
                                    at=inj.visits.get("snapshot_write", 0)))
        if i == at:
            inj.faults.append(Fault("execute",
                                    at=inj.visits.get("execute", 0),
                                    kind="device_loss"))

    run = W.run(tmp_path / "faulted", "composed", params=params, cfg=cfg,
                events=events, during=arm,
                faults=[dict(stage="staging", at=10 ** 6)])
    # the snapshot persists on the shield's writer thread: the two faults
    # land in either order
    fired = sorted(f[0] for f in run.shield.injector.fired)
    assert fired == ["execute", "snapshot_write"], fired
    assert run.shield.recoveries >= 1
    W.assert_same(run, ref, "recovery after a re-mirror")


@pytest.mark.parametrize("pkg", [W.PORT_PKG, W.JAX_PKG])
def test_a_poisoned_empty_delta_is_quarantined_as_jax_does(pkg, tmp_path):
    """A caller boundary with nothing staged still dispatches a padded
    delta; poison in its padding trips the finite guard, the batch is
    quarantined and the tick replays, in the port as in the JAX package,
    and the verdicts equal the unfaulted run's."""
    def poison_an_empty_tick(i, shield):
        if i == 2:
            shield.rescore()
            assert shield.scorer._pending_delta_count() == 0
            inj = shield.injector
            inj.faults.append(Fault("delta_values",
                                    at=inj.visits.get("delta_values", 0),
                                    kind="poison"))
            shield.rescore()

    cfg = W.settings(pkg, depth=1)
    run = W.run(tmp_path / "faulted", pkg=pkg, cfg=cfg,
                faults=[dict(stage="staging", at=10 ** 6)],
                during=poison_an_empty_tick)
    assert [f[:2] for f in run.shield.injector.fired] == [
        ("delta_values", "poison")]
    assert run.shield.quarantined_batches == 1
    ref = W.run(tmp_path / "ref", pkg=pkg, cfg=cfg,
                during=lambda i, sh: sh.rescore() if i == 2 else None)
    if pkg == W.PORT_PKG:
        W.assert_same(run, ref, "poisoned empty delta")
    else:
        W.assert_rules_equal_jax(run, ref, "poisoned empty delta")


def test_a_restore_keeps_the_staged_rows_in_the_host_mirror(tmp_path):
    """A snapshot taken while feature rows are staged but not yet ticked
    (``sync()``, no dispatch): a restart restores them staged, and the
    host mirror holds their staged values, so the attestation fold at the
    next boundary finds the device equal to the mirror (no repair) and
    the restarted scorer ends bit-identical to the live one."""
    from kubernetes_aiops_evidence_graph_tpu_torch.simulator.stream import (
        churn_events, store_step)
    shield, world = _shielded("rules", tmp_path / "live",
                              shield_snapshot_every_ticks=10 ** 6)
    cluster, builder, _ = world
    scorer = shield.scorer
    events = list(churn_events(cluster, 60, seed=5, incident_ids=tuple(
        builder.store.incident_ids())))
    try:
        for ev in events:
            store_step(cluster, builder.store, ev)
        shield.sync()
        staged = scorer._pending_feat.keys()
        want = scorer.snapshot.features[staged].copy()
        assert (scorer._features_dev.numpy()[staged] != want).any(), \
            "premise: staged rows the device does not hold yet"
        shield.snapshot_now()
        shutil.copytree(tmp_path / "live", tmp_path / "restart")
        live = W.Run(shield.rescore(), shield, None, world)
        shield.snapshot_now()
        live.packed = W.packed(scorer)
    finally:
        shield.close()
    fresh = W.make_scorer(W.PORT_PKG, "rules", builder.store, world[2],
                          cluster.now.timestamp(), None)
    shield2 = t_shield.ShieldedScorer(fresh, world[2],
                                      directory=str(tmp_path / "restart"))
    try:
        assert shield2.recover()["replayed"] == 0
        np.testing.assert_array_equal(fresh.snapshot.features[staged], want)
        out = shield2.rescore()
        shield2.snapshot_now()
        assert shield2.attest_repairs == 0
    finally:
        shield2.close()
    W.assert_same(W.Run(out, shield2, W.packed(fresh), world), live,
                  "restart with staged rows")
