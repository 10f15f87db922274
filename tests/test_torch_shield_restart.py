"""Kill and restart under the port's crash shield: ``recover()`` loads the
last snapshot and replays the journal suffix (never a rebuild), in place
after the resident state died and in a fresh scorer and shield on the
same directory, and the next caller boundary serves the unfaulted run's
verdicts with its packed state bit for bit, on the rules scorer and on
every learned tier (the quantized tables and their frozen scale
included).
"""
from __future__ import annotations

import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu_torch.rca import shield as t_shield
from kubernetes_aiops_evidence_graph_tpu_torch.rca.faults import FaultInjector
from tests import torch_shield_world as W
from tests.torch_shield_world import params  # noqa: F401  (fixture)


def test_recovery_is_journal_replay_and_a_restart_recovers_the_state(
        tmp_path):
    """tests/test_shield.py's replay-not-rebuild case: recover() after
    churn restores from the snapshot and replays the journal suffix (the
    rebuild counter does not move), and a restart does the same."""
    ref = W.run(tmp_path / "ref")
    run = W.run(tmp_path / "a")
    cluster, builder, cfg = run.world
    scorer = run.shield.scorer
    rebuilds = scorer.rebuilds
    FaultInjector._corrupt_resident(scorer)
    shield = t_shield.ShieldedScorer(scorer, cfg,
                                     directory=str(tmp_path / "a"))
    try:
        res = shield.recover()
        assert res["mode"] == "journal_replay" and scorer.rebuilds == rebuilds
        out = shield.rescore()
    finally:
        shield.close()
    W.assert_same(W.Run(out, shield, W.packed(scorer), run.world), ref,
                  "recover in place")
    res, restarted = W.restart(tmp_path / "a", "rules", run)
    assert res["mode"] == "journal_replay"
    W.assert_same(restarted, ref, "restart")


@pytest.mark.parametrize("tier", ["composed", "fused", "dma", "dma_bf16",
                                  "dma_int8"])
def test_restart_recovers_every_learned_tier_bit_for_bit(
        tier, params, tmp_path):  # noqa: F811
    ref = W.run(tmp_path / "ref", tier, params=params)
    run = W.run(tmp_path / "a", tier, params=params)
    res, restarted = W.restart(tmp_path / "a", tier, run, params)
    assert res["mode"] == "journal_replay"
    W.assert_same(restarted, ref, f"{tier} restart")
    fresh = restarted.shield.scorer
    if tier.startswith("dma_"):
        assert fresh._features_q_dev.dtype == (
            torch.bfloat16 if tier == "dma_bf16" else torch.int8)


def test_a_snapshot_of_another_tier_refuses_to_restore(params,  # noqa: F811
                                                       tmp_path):
    """A restart under other quant settings finds a snapshot whose packed
    tensors do not fit the scorer: the restore raises (recovery then
    falls to the deeper rungs) rather than adopting the wrong table."""
    run = W.run(tmp_path / "a", "dma_int8", params=params, events=20)
    with pytest.raises(RuntimeError, match="quantized-table"):
        W.restart(tmp_path / "a", "dma_bf16", W.Run(
            run.out, run.shield, run.packed,
            run.world[:2] + (W.settings(tier="dma_bf16"),)), params)
