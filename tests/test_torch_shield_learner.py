"""The online learner's hot swaps under the port's crash shield.

A swap is journaled before it applies (``ShieldedScorer.swap_params``, and
``rca/surge.swap_tenants_atomically``'s journal branch for a shielded
target), so a restart recovers the swapped generation with its exact
leaves; non-finite verdicts right after a swap roll it back through the
shield; a fault at the learner's ``harvest`` or ``swap`` stage is
contained, with every target on its old generation
(tests/test_learn.py and tests/test_storm.py's learner cases).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu_torch.rca import shield as t_shield
from kubernetes_aiops_evidence_graph_tpu_torch.rca.faults import (
    Fault, FaultInjector)
from tests import torch_shield_world as W
from tests.torch_shield_world import params  # noqa: F401  (fixture)


def test_learner_swap_recovered_mid_swap_restores_the_generation(
        params, tmp_path):  # noqa: F811
    """tests/test_learn.py's crash after a journaled swap: the learner's
    atomic swap (``rca/surge.swap_tenants_atomically``) journals the exact
    leaves through the shield; a restarted scorer loaded with the OLD
    checkpoint recovers the swapped generation, and after the replayed
    deltas drain it serves the uncrashed scorer's bits."""
    from kubernetes_aiops_evidence_graph_tpu_torch.learn import OnlineLearner
    from kubernetes_aiops_evidence_graph_tpu_torch.rca import gnn
    from kubernetes_aiops_evidence_graph_tpu_torch.simulator.stream import (
        churn_events, store_step)
    rng = np.random.default_rng(5)
    params_b = {k: (np.asarray(v) + rng.normal(0, 0.01, np.shape(v))
                    ).astype(np.float32)
                for k, v in gnn.flat_params(params).items()}
    params_b = gnn.unflat_params(params_b)
    cfg = W.settings(tier="composed", shield_snapshot_every_ticks=10 ** 6)
    cluster, builder, incidents = W._world(W.PORT_PKG, cfg, seed=5,
                                         num_pods=100)
    now = cluster.now.timestamp()
    scorer = W.make_scorer(W.PORT_PKG, "composed", builder.store, cfg, now,
                           params)
    shield = t_shield.ShieldedScorer(scorer, cfg, directory=str(tmp_path))
    try:
        shield.recover_or_snapshot()
        events = list(churn_events(cluster, 60, seed=7, incident_ids=tuple(
            builder.store.incident_ids())))
        for ev in events[:30]:
            store_step(cluster, builder.store, ev)
        shield.rescore()
        learner = OnlineLearner(None, [shield], settings=cfg)
        assert learner.swap(params_b) == 1
        kinds = [b.kind for b in shield.journal.read()[0]]
        assert kinds.count("params_swap") == 1
        for ev in events[30:]:
            store_step(cluster, builder.store, ev)
        shield.rescore()
        live = shield.rescore()
        assert live["params_generation"] == 1
    finally:
        shield.close()
    scorer2 = W.make_scorer(W.PORT_PKG, "composed", builder.store, cfg, now,
                            params)
    shield2 = t_shield.ShieldedScorer(scorer2, cfg, directory=str(tmp_path))
    try:
        assert shield2.recover()["mode"] == "journal_replay"
        assert scorer2.params_generation == 1
        assert scorer2._params_source == "finetune"
        for k, v in gnn.flat_params(scorer._params).items():
            assert torch.equal(gnn.flat_params(scorer2._params)[k], v), k
        shield2.rescore()               # drains the replayed deltas
        out2 = shield2.rescore()
    finally:
        shield2.close()
    np.testing.assert_array_equal(live["probs"], out2["probs"])
    assert out2["params_generation"] == 1


def test_nonfinite_verdicts_after_a_swap_roll_it_back(params,  # noqa: F811
                                                    tmp_path):
    """Non-finite verdicts right after a hot swap roll the swap back
    through the shield (journaled as a fresh generation) before any
    heavier rung; serving stays finite."""
    from kubernetes_aiops_evidence_graph_tpu_torch.rca import gnn
    bad = gnn.unflat_params({k: np.full(np.shape(v), np.nan, np.float32)
                             for k, v in gnn.flat_params(params).items()})
    swapped = []

    def swap(i, shield):
        if i == 1:
            swapped.append(shield.swap_params(bad, source="bad"))

    run = W.run(tmp_path, "composed", params=params, during=swap)
    shield = run.shield
    assert swapped == [1] and "params_rollback" in shield.tier_log
    assert shield.scorer.params_generation == 2
    assert np.isfinite(run.out["probs"]).all()
    recs = [b for b in W.journal_batches(tmp_path) if b.kind == "params_swap"]
    assert [r.meta["generation"] for r in recs][-1] == 2
    assert recs[-1].meta.get("rollback") is True


def test_learner_harvest_and_swap_faults_are_contained(params,  # noqa: F811
                                                       tmp_path):
    """Learner-stage chaos (tests/test_storm.py): a faulted harvest fails
    its cycle; a faulted swap fires before any target swaps, so every
    target and the shield's journal stay on the old generation."""
    from kubernetes_aiops_evidence_graph_tpu_torch.learn import OnlineLearner
    from kubernetes_aiops_evidence_graph_tpu_torch.storage import Database
    run = W.run(tmp_path, "composed", params=params, events=20)
    db = Database(":memory:")
    shield = run.shield
    try:
        inj = FaultInjector([Fault("harvest", at=0), Fault("swap", at=0)])
        learner = OnlineLearner(db, [shield], settings=run.world[2],
                                injector=inj)
        with pytest.raises(RuntimeError, match="harvest"):
            learner.run_once()
        assert learner.generation == 0 and len(learner.buffer) == 0
        with pytest.raises(RuntimeError, match="swap"):
            learner.swap(params)
        assert learner.swaps == 0 and learner.generation == 0
        assert all(b.kind != "params_swap"
                   for b in W.journal_batches(tmp_path))
    finally:
        db.close()


def test_an_atomic_swap_journals_each_shielded_tenant(params,  # noqa: F811
                                                      tmp_path):
    """``swap_tenants_atomically`` over two shielded tenants and one bare
    scorer: all take one generation (one past the highest), each shield's
    journal holds one ``params_swap`` record with that generation and the
    exact leaves, the bare scorer's swap journals nothing, and each shield
    restarted from its own directory serves the swapped leaves."""
    from kubernetes_aiops_evidence_graph_tpu_torch.rca import gnn
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.surge import (
        swap_tenants_atomically)
    rng = np.random.default_rng(3)
    new = gnn.unflat_params({
        k: (np.asarray(v) + rng.normal(0, 0.01, np.shape(v))
            ).astype(np.float32)
        for k, v in gnn.flat_params(params).items()})
    cfg = W.settings(tier="composed", shield_snapshot_every_ticks=10 ** 6)
    shields, worlds = [], []
    for t in range(2):
        cluster, builder, _ = W._world(W.PORT_PKG, cfg, seed=20 + t,
                                       num_pods=80)
        scorer = W.make_scorer(W.PORT_PKG, "composed", builder.store, cfg,
                               cluster.now.timestamp(), params)
        sh = t_shield.ShieldedScorer(scorer, cfg,
                                     directory=str(tmp_path / f"t{t}"))
        sh.recover_or_snapshot()
        shields.append(sh)
        worlds.append((cluster, builder))
    cluster, builder, _ = W._world(W.PORT_PKG, cfg, seed=22, num_pods=80)
    bare = W.make_scorer(W.PORT_PKG, "composed", builder.store, cfg,
                         cluster.now.timestamp(), params)
    bare.params_generation = 4
    try:
        assert swap_tenants_atomically([*shields, bare], new,
                                       source="finetune") == 5
        want = [np.asarray(v) for v in gnn.flat_params(new).values()]
        for sh in shields:
            recs = [b for b in sh.journal.read()[0] if b.kind == "params_swap"]
            assert len(recs) == 1 and recs[0].meta["generation"] == 5
            for got, leaf in zip(recs[0].meta["leaves"], want):
                np.testing.assert_array_equal(got, leaf)
            assert sh.scorer.params_generation == 5
        assert bare.params_generation == 5
    finally:
        for sh in shields:
            sh.close()
    for t, (cluster, builder) in enumerate(worlds):
        fresh = W.make_scorer(W.PORT_PKG, "composed", builder.store, cfg,
                              cluster.now.timestamp(), params)
        sh = t_shield.ShieldedScorer(fresh, cfg,
                                     directory=str(tmp_path / f"t{t}"))
        try:
            assert sh.recover()["mode"] == "journal_replay"
        finally:
            sh.close()
        assert fresh.params_generation == 5
        for k, v in gnn.flat_params(new).items():
            assert torch.equal(gnn.flat_params(fresh._params)[k],
                               torch.as_tensor(np.asarray(v))), k
