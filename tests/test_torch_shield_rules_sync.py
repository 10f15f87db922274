"""The crash shield around the port's rules scorer (B1), pipeline depth 1:
the fault matrix of ``tests/test_torch_shield_rules.py`` on the serialized
loop, queue overflow under the shield, and silent corruption that only
the attestation fold can localize.
"""
from __future__ import annotations

import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu_torch.rca import heal
from tests import torch_shield_world as W
from tests.test_torch_shield_rules import check_fault_class

DEPTH = 1


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    ref = W.unfaulted(tmp_path_factory, depth=DEPTH)
    jax_run = W.run(tmp_path_factory.mktemp("jax"), depth=DEPTH,
                    pkg=W.JAX_PKG)
    W.assert_rules_equal_jax(ref, jax_run, f"unfaulted, depth {DEPTH}")
    return ref


@pytest.mark.parametrize("name", sorted(W.FAULTS))
def test_rules_fault_recovery_bit_parity_and_equals_jax(name, baseline,
                                                        tmp_path):
    check_fault_class(name, DEPTH, baseline, tmp_path)


def test_queue_overflow_backpressure_under_shield(baseline, tmp_path):
    """tests/test_shield.py's queue-overflow class: four submissions per
    pipeline slot coalesce or retire unfetched (never drop, never grow the
    queue), and the verdicts are bit-identical."""
    def overflow(_i, shield):
        for _ in range(3):
            shield.tick()

    run = W.run(tmp_path, depth=DEPTH, during=overflow)
    scorer = run.shield.scorer
    assert len(scorer._inflight) == 0
    assert scorer.coalesced_ticks + scorer.deferred_fetches >= \
        3 * (W.EVENTS // W.BATCH)
    assert run.shield.tier_log == [] and run.shield.recoveries == 0
    W.assert_same(run, baseline, "queue overflow")


def test_silent_corruption_is_flagged_and_repaired_by_attestation(
        baseline, tmp_path):
    """A shard whose resident block goes NaN without raising (the rules
    fold would serve wrong-but-finite verdicts from it) is flagged by the
    attestation fold at the next snapshot boundary and repaired in place
    from the host mirror: no recovery, no rebuild, bit parity."""
    run = W.run(tmp_path, depth=DEPTH, faults=[
        dict(stage="shard_loss", at=1, kind="shard_corrupt_silent")])
    shield = run.shield
    assert shield.injector.fired == [("shard_loss",
                                      "shard_corrupt_silent", 1)]
    assert shield.attest_repairs == 1 and shield.recoveries == 0
    W.assert_same(run, baseline, "attested repair")


def test_a_finite_bit_flip_is_flagged_and_repaired_by_attestation(
        baseline, tmp_path):
    """Silent FINITE corruption, the class the finite guard cannot see:
    the lowest mantissa bit of one value in one row of the resident
    features. The fold flags exactly that table against the host mirrors,
    the next snapshot boundary repairs it in place (no recovery), and the
    run ends bit-identical to the unfaulted one."""
    flagged = []

    def flip(i, shield):
        if i != 2:
            return
        s = shield.scorer
        with s._on_stream():
            s._features_dev.view(torch.int32)[1, 0] ^= 1
        assert torch.isfinite(s._features_dev).all()
        pairs = s._attest_arrays()
        fold = heal.attest_fold(*[getattr(s, a) for a, _ in pairs], shards=1)
        bad = fold.numpy() != heal.attest_host([h for _, h in pairs], 1)
        flagged.extend(a for (a, _), row in zip(pairs, bad) if row.any())
        repairs = shield.attest_repairs
        shield.snapshot_now()
        assert shield.attest_repairs == repairs + 1

    run = W.run(tmp_path, depth=DEPTH, during=flip)
    assert flagged == ["_features_dev"]
    assert run.shield.recoveries == 0 and run.shield.attest_repairs == 1
    W.assert_same(run, baseline, "attested repair of a finite flip")
