"""The crash shield around the port's rules scorer (B1), pipeline depth 2,
against an unfaulted replay and against the JAX package's shield.

For every fault class of tests/test_shield.py's matrix the shielded scorer
recovers to verdicts and a packed resident state bit-identical to an
unfaulted replay of the same churn script, and its verdicts equal the
JAX ``ShieldedScorer``'s on the same world and schedule. Depth 1 is in
``tests/test_torch_shield_rules_sync.py``.
"""
from __future__ import annotations

import os

import numpy as np
import pytest

from tests import torch_shield_world as W

DEPTH = 2


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """The unfaulted replay, held to the JAX shield's verdicts."""
    ref = W.unfaulted(tmp_path_factory, depth=DEPTH)
    jax_run = W.run(tmp_path_factory.mktemp("jax"), depth=DEPTH,
                    pkg=W.JAX_PKG)
    W.assert_rules_equal_jax(ref, jax_run, f"unfaulted, depth {DEPTH}")
    return ref


def check_fault_class(name, depth, baseline, tmp_path):
    faults, expects_recovery = W.FAULTS[name]
    run = W.run(tmp_path / "port", depth=depth, faults=faults)
    assert run.shield.injector.fired, f"{name}: fault never fired"
    W.assert_same(run, baseline, f"{name}, depth {depth}",
                  with_packed=run.shield.scorer.rebuilds == 0)
    if expects_recovery:
        assert run.shield.recoveries >= 1, run.shield.stats()
        assert run.out["recovery_seconds"] > 0.0
    assert run.shield.journal.appended_batches >= 1
    assert "journal_seconds" in run.out and "shield_tier" in run.out
    jax_run = W.run(tmp_path / "jax", depth=depth, faults=faults,
                    pkg=W.JAX_PKG)
    W.assert_rules_equal_jax(run, jax_run, f"{name}, depth {depth}")


@pytest.mark.parametrize("name", sorted(W.FAULTS))
def test_rules_fault_recovery_bit_parity_and_equals_jax(name, baseline,
                                                        tmp_path):
    check_fault_class(name, DEPTH, baseline, tmp_path)


def test_nan_poisoned_delta_is_quarantined_and_journaled(baseline, tmp_path):
    """A poisoned delta batch trips the finite DELTA guard at the dispatch
    boundary (the rules fold absorbs NaN through its threshold compares,
    so a verdict-level check alone would serve silently wrong verdicts),
    is journaled as quarantined, and re-ticks from store-truth state."""
    from kubernetes_aiops_evidence_graph_tpu_torch.observability import (
        metrics as obs_metrics)
    q0 = obs_metrics.SHIELD_QUARANTINED_DELTAS.value()
    r0 = obs_metrics.SHIELD_REPLAYED_DELTAS.value()
    seen = []

    def note(_i, shield):
        seen.extend(b.kind for b in shield.journal.read()[0])

    run = W.run(tmp_path, faults=W.FAULTS["nan_poisoned_delta"][0],
                during=note)
    assert run.shield.quarantined_batches >= 1
    assert "quarantine" in seen
    assert obs_metrics.SHIELD_QUARANTINED_DELTAS.value() > q0
    assert obs_metrics.SHIELD_REPLAYED_DELTAS.value() > r0
    for k in ("scores", "top_score", "top_confidence"):
        assert np.isfinite(np.asarray(run.out[k])).all()
    W.assert_same(run, baseline, "poison",
                  with_packed=run.shield.scorer.rebuilds == 0)


def test_seeded_fault_schedule_sweep(baseline, tmp_path):
    """Chaos: a seeded random schedule across the tick stages; parity
    holds wherever it lands, and the JAX shield on the same world and
    schedule serves the same verdicts."""
    seed = int(os.environ.get("KAEG_CHAOS_SEED", "20260804"))
    sched = dict(seed=seed, ticks=W.EVENTS // W.BATCH + 1, rate=0.25,
                 stages=("staging", "dispatch", "pack", "execute",
                         "journal_append"))
    run = W.run(tmp_path / "port", seeded=sched)
    assert run.shield.injector.fired
    W.assert_same(run, baseline, f"seed {seed}",
                  with_packed=run.shield.scorer.rebuilds == 0)
    jax_run = W.run(tmp_path / "jax", seeded=sched, pkg=W.JAX_PKG)
    W.assert_rules_equal_jax(run, jax_run, f"seed {seed}")


def test_watchdog_trip_degrades_the_pipeline_to_sync(baseline, tmp_path):
    """A tick over the watchdog's timeout (given, not measured) counts a
    trip and drops the pipeline to depth 1 without changing a bit."""
    def trip(i, shield):
        if i == 2:
            shield._watchdog(shield.tick_timeout_s + 1.0)

    run = W.run(tmp_path, during=trip)
    shield = run.shield
    assert shield.watchdog_trips == 1 and shield.tier_log == ["sync_depth1"]
    assert shield.scorer.pipeline_depth == 1
    W.assert_same(run, baseline, "watchdog")
    shield._watchdog(shield.tick_timeout_s)      # at the limit: no trip
    assert shield.watchdog_trips == 1
