"""The crash shield's degradation ladder around the port's learned scorer:
the kernel-fallback rung is the tick's tier walk, streamed (B4) → fused
(B3) → composed (B2), and never steps down to a kernel's plain version;
a learned scorer that cannot be revived is shed for the rules scorer on
the same device. Every rung taken is counted, in ``stats()`` and in
``aiops_shield_tier_transitions_total``; an unfaulted run takes none.
"""
from __future__ import annotations

import numpy as np
import pytest

import chip_smoke
from kubernetes_aiops_evidence_graph_tpu_torch.observability import (
    metrics as obs_metrics)
from kubernetes_aiops_evidence_graph_tpu_torch.rca import gnn_streaming as gs
from tests import torch_shield_world as W
from tests.torch_shield_world import params  # noqa: F401  (fixture)


def _spy_tiers(monkeypatch) -> list:
    """The tier functions each tick ran, in order."""
    served = []
    for name in ("_gnn_dma_tick", "_gnn_fused_tick", "_gnn_tick"):
        real = getattr(gs, name)

        def spy(*a, _real=real, _name=name, **k):
            served.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(gs, name, spy)
    return served


def _order(served) -> list:
    return [n for i, n in enumerate(served) if i == 0 or served[i - 1] != n]


def test_kernel_fallback_walks_streamed_fused_composed(params,  # noqa: F811
                                                       tmp_path, monkeypatch):
    """One device loss strips the streamed tick (B4) onto the fused one
    (B3), the next strips that onto the composed tick (B2), each tier
    serving ticks in that order; the next suspect fault finds no rung
    below the composed tick and walks on (sync, replay). Bits equal the
    unfaulted run's."""
    served = _spy_tiers(monkeypatch)
    faults = [dict(stage="execute", at=1, kind="device_loss"),
              dict(stage="execute", at=3, kind="device_loss"),
              dict(stage="execute", at=5, kind="device_loss")]
    run = W.run(tmp_path, "walk", params=params, faults=faults, events=140)
    shield = run.shield
    assert shield.tier_log[:2] == ["kernel_fallback", "kernel_fallback"]
    assert "kernel_fallback" not in shield.tier_log[2:]
    assert shield.scorer._use_dma is False
    assert shield.scorer._use_fused is False
    assert _order(served) == ["_gnn_dma_tick", "_gnn_fused_tick",
                              "_gnn_tick"]
    base = W.run(tmp_path / "base", "walk", params=params, events=140)
    assert base.shield.scorer._use_dma and base.shield.tier_log == []
    W.assert_same(run, base, "walk")


def test_a_persistent_kernel_fault_walks_the_tiers(params,  # noqa: F811
                                                   tmp_path, monkeypatch):
    """``chip_smoke.break_tiers``, phase 15's persistent kernel fault: the
    streamed tier fails for good from tick 1, the fused tier from tick 3.
    Each first failure takes the fallback rung (with a replay), so the
    scorer serves B4, then B3, then B2, and ends bit-identical to the
    unfaulted run."""
    served = _spy_tiers(monkeypatch)
    broken: set = set()

    def breaks(i, shield):
        if i == 0:
            chip_smoke.break_tiers(shield.scorer, broken)
            broken.add("dma")
        if i == 2:
            broken.add("fused")

    run = W.run(tmp_path, "walk", params=params, during=breaks, events=140)
    assert run.shield.tier_log == ["kernel_fallback", "kernel_fallback"]
    assert run.shield.recoveries == 2
    assert chip_smoke.serving_tier(run.shield.scorer) == "composed"
    assert _order(served) == ["_gnn_dma_tick", "_gnn_fused_tick",
                              "_gnn_tick"]
    base = W.run(tmp_path / "base", "walk", params=params, events=140)
    W.assert_same(run, base, "persistent tier faults")


def test_persistent_learned_fault_walks_the_ladder_to_rules_fallback(
        params, tmp_path):  # noqa: F811
    """Every tier fails under a persistent device fault until the learned
    scorer is shed for a rules scorer on the same device: degraded,
    finite, still serving the rules verdicts of the same store."""
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.streaming import (
        StreamingScorer)
    t0 = obs_metrics.SHIELD_TIER_TRANSITIONS.value(tier="rules_fallback")
    run = W.run(tmp_path, "composed", params=params, faults=[
        dict(stage="execute", at=1, kind="device_loss", repeats=200)])
    shield = run.shield
    assert shield.tier == "rules_fallback"
    assert shield.tier_log[-1] == "rules_fallback"
    assert type(shield.scorer) is StreamingScorer
    assert shield.scorer.device.type == "cpu"
    assert isinstance(shield._fallback_from, gs.GnnStreamingScorer)
    assert obs_metrics.SHIELD_TIER_TRANSITIONS.value(
        tier="rules_fallback") == t0 + 1
    assert np.isfinite(np.asarray(run.out["top_score"])).all()
    rules = W.run(tmp_path / "rules", "rules", events=W.LEARNED_EVENTS)
    assert W.by_id(run.out, ("top_rule_index",)) == W.by_id(
        rules.out, ("top_rule_index",))


@pytest.mark.parametrize("tier", ["rules", "dma_bf16", "dma_int8"])
def test_every_rung_is_counted_and_none_unfaulted(tier, params,  # noqa: F811
                                                  tmp_path):
    """An unfaulted shielded run takes no rung; a faulted one counts each
    rung it takes once in ``stats()["tier_log"]`` and once in the tier
    transition counter. A quantized streamed tier degrades with its
    table to the float32 tier below it."""
    def counts():
        return {t: obs_metrics.SHIELD_TIER_TRANSITIONS.value(tier=t)
                for t in ("retry", "kernel_fallback", "sync_depth1",
                          "journal_replay", "full_rebuild", "rules_fallback",
                          "breaker_open", "params_rollback")}

    before = counts()
    ref = W.run(tmp_path / "ref", tier, params=params)
    assert ref.shield.stats()["tier_log"] == () and counts() == before
    run = W.run(tmp_path / "faulted", tier, params=params, faults=[
        dict(stage="execute", at=1, kind="device_loss"),
        dict(stage="fetch", at=0)])
    log = run.shield.stats()["tier_log"]
    assert log and "retry" in log
    after = counts()
    assert {t: after[t] - before[t] for t in after} == {
        t: log.count(t) for t in after}
    if tier != "rules":
        assert log[0] == "kernel_fallback"
        assert chip_smoke.serving_tier(run.shield.scorer) == "composed"
        assert run.shield.scorer._features_q_dev is not None
