"""The port's entry points serving through the crash shield, and the CPU
rehearsal of ``chip_smoke.py``'s phase 15.

With ``shield_enabled`` the workflow worker acquires its resident scorer
shield-wrapped on the worker's device and anchors a snapshot in
``shield_dir`` (a second worker over the same store and directory, a
restarted serve loop, recovers from it); ``AiopsApp`` serves its
incidents through it and closes it on ``stop()``. A shielded surge
worker serves from its tenant's pack, unshielded (the shield wraps one
store), as the reference does.
"""
from __future__ import annotations

import os

import pytest
import torch

import chip_smoke
from kubernetes_aiops_evidence_graph_tpu_torch.rca import shield as t_shield
from kubernetes_aiops_evidence_graph_tpu_torch.rca.faults import TICK_STAGES
from kubernetes_aiops_evidence_graph_tpu_torch.storage import Database
from kubernetes_aiops_evidence_graph_tpu_torch.workflow import IncidentWorker
from tests import torch_shield_world as W

APP_SIZE = dict(num_pods=96, num_incidents=6, batch=3,
                node_bucket_sizes=(512, 2048), incident_bucket_sizes=(8, 32))


def _worker(cfg, builder, cluster):
    db = Database(":memory:")
    return IncidentWorker(cluster, db, builder=builder, settings=cfg,
                          device="cpu"), db


@pytest.mark.parametrize("backend", ["tpu", "gnn"])
def test_worker_serves_through_the_shield(backend, tmp_path):
    """tests/test_shield.py's worker case, then a restart: a second worker
    over the same store and ``shield_dir`` recovers the first one's
    snapshot and journal (no fresh anchor) and serves the same bits."""
    cfg = W.settings(tier="rules" if backend == "tpu" else "composed",
                     depth=1, shield_enabled=True, shield_dir=str(tmp_path))
    cluster, builder, _ = W._world(W.PORT_PKG, cfg)
    worker, db = _worker(cfg, builder, cluster)
    try:
        scorer = worker.serving_scorer()
        assert isinstance(scorer, t_shield.ShieldedScorer)
        assert worker.serving_scorer() is scorer
        assert scorer.device.type == "cpu"
        assert scorer.snapshots >= 1
        assert os.path.exists(tmp_path / "state.snap")
        out = scorer.serve(newest=True)
        assert out["shield_tier"] == "steady"
        packed = W.packed(scorer.scorer)
    finally:
        worker.close()
        db.close()
    worker2, db2 = _worker(cfg, builder, cluster)
    try:
        again = worker2.serving_scorer()
        assert again.snapshots == 0 and again.recoveries == 1
        out2 = again.serve(newest=True)
        W.assert_same(W.Run(out2, again, W.packed(again.scorer), None),
                      W.Run(out, scorer, packed, None), "worker restart")
    finally:
        worker2.close()
        db2.close()


@pytest.mark.parametrize("backend", ["tpu", "gnn"])
def test_chip_smoke_app_phase_serves_through_the_shield(backend, tmp_path):
    """The app with ``shield_enabled`` (phase 15's second half): every
    webhook closes, scored by the resident scorer behind the shield, which
    anchored its snapshot in ``shield_dir``, journaled the store's deltas
    and took no tier transition; ``stop()`` closed its journal."""
    closed = []
    real = t_shield.ShieldedScorer.close

    def close(self):
        closed.append(self)
        real(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_shield.ShieldedScorer, "close", close)
        res = chip_smoke.run_app(backend, torch.device("cpu"),
                                 shield_enabled=True,
                                 shield_dir=str(tmp_path), **APP_SIZE)
    assert res["incidents"] == 6
    assert res["scorer"] == ("StreamingScorer" if backend == "tpu"
                             else "GnnStreamingScorer")
    shield = res["shield"]
    assert shield["snapshots"] >= 1 and shield["journal_batches"] >= 1
    assert shield["tier"] == "steady" and shield["tier_log"] == ()
    assert (tmp_path / "state.snap").exists()
    assert len(closed) == 1 and closed[0].journal._wal_f.closed


def test_a_shielded_surge_fleet_still_waits_for_item_7():
    """Item 7 landed: with ``shield_enabled`` a surge worker serves from
    its tenant's pack, which the shield does not wrap (it needs one
    store), and the app keeps the surge it was given."""
    from kubernetes_aiops_evidence_graph_tpu_torch.app import AiopsApp
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.surge import (
        MultiTenantScorer, SurgeServer)
    cfg = W.settings(shield_enabled=True)
    cluster, builder, _ = W._world(W.PORT_PKG, cfg, num_pods=60)
    db = Database(":memory:")
    srv = SurgeServer(cfg, device="cpu")
    try:
        worker = IncidentWorker(cluster, db, builder=builder, settings=cfg,
                                surge=srv, tenant="t", device="cpu")
        scorer = worker.serving_scorer()
        assert type(scorer) is MultiTenantScorer
        assert scorer is srv.scorer("t")
        app = AiopsApp(cluster, cfg, db=db, surge=srv, device="cpu")
        assert app.surge is srv and app.worker.surge is srv
        assert srv.fleet()["placement"] == {"t": 0, "default": 0}
    finally:
        db.close()


@pytest.fixture(scope="module")
def rehearsal():
    return chip_smoke.run_recovery(torch.device("cpu"), num_pods=150,
                                   num_incidents=6, events=400, batch_size=20)


def test_chip_smoke_recovery_phase_rehearsal(rehearsal):
    """Phase 15 at a small size: every tick stage faults in every scorer
    of the matrix, each recovers to its reference's bits (the phase raises
    otherwise), the restart recovers by replay, and the attestation flags
    the corrupted features, a NaN block and a flipped bit of a finite
    value alike. (On the CPU no kernel counts a launch; on the card the
    phase also checks the walk's launches.)"""
    assert set(rehearsal["kinds"]) == set(chip_smoke.RECOVERY_KINDS)
    for kind, r in rehearsal["kinds"].items():
        assert {f[0] for f in r["fired"]} == set(TICK_STAGES), kind
        assert r["attest_flagged"] == {"nan_block": ["_features_dev"],
                                       "finite_flip": ["_features_dev"]}
        assert "restart" in r["tier_log"]
    assert rehearsal["kinds"]["rules"]["serving_tier_at_end"] == "rules"
    assert rehearsal["kinds"]["dma"]["tier_log"][:2] == [
        "kernel_fallback", "kernel_fallback"]


def test_the_recovery_record_has_its_fields(rehearsal):
    """What the ``{"recovery": ...}`` line reports: snapshot bytes,
    capture and persist seconds, the restart's seconds and records
    replayed, the transitions (none unfaulted), the walk that ended on the
    composed tier and the rules fallback."""
    assert rehearsal["transitions_unfaulted"] == 0
    for r in rehearsal["kinds"].values():
        assert r["snapshot_bytes"] > 0
        assert r["capture_s"] > 0 and r["persist_s"] > 0
        # the kill may land right after a snapshot: nothing to replay
        assert r["restart"]["seconds"] > 0 and r["restart"]["replayed"] >= 0
        assert r["restart"]["torn_truncated"] in (0, 1)
    walk = rehearsal["walk"]
    assert walk["tier_log"] == ["kernel_fallback", "kernel_fallback"]
    assert walk["recoveries"] == 2
    fallback = rehearsal["fallback"]
    assert fallback["tier_log"][-1] == "rules_fallback"
    assert fallback["top1_equal_to_rules_ref"] == fallback["incidents"] > 0
