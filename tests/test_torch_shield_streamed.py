"""The crash shield around the port's learned scorer on its streamed tier
(B4, the tick over resident tables by node blocks): every fault class of
the tick, at pipeline depths 1 and 2, recovers bit-identical to an
unfaulted run and within 1e-5 of the JAX package's shield with the same
top-1, and a seeded schedule across the stages recovers by replay alone.
"""
from __future__ import annotations

import os

import pytest

from tests import torch_shield_world as W
from tests.torch_shield_world import params  # noqa: F401  (fixture)

TIER = "dma"


@pytest.fixture(scope="module")
def base(params, tmp_path_factory):  # noqa: F811
    return W.learned_baseline(tmp_path_factory, TIER, params)


@pytest.mark.parametrize("stage", sorted(W.LEARNED_FAULTS))
def test_learned_fault_recovery_bit_parity(stage, base, params,  # noqa: F811
                                           tmp_path):
    W.check_learned_fault(TIER, stage, base, params, tmp_path)


def test_learned_seeded_schedule_sweep(params, tmp_path):  # noqa: F811
    seed = int(os.environ.get("KAEG_CHAOS_SEED", "20260804"))
    run = W.run(tmp_path / "a", TIER, params=params, events=W.EVENTS,
                seeded=dict(seed=seed, ticks=10, rate=0.06,
                            stages=("staging", "dispatch", "pack", "execute",
                                    "journal_append")))
    # a schedule this sparse recovers by replay alone: a denser one can
    # reach the full rebuild (a store-derived mirror, whose sums reorder
    # at float tolerance) or shed the scorer for the rules fallback
    assert run.shield.scorer.rebuilds == 0, run.shield.tier_log
    assert len(run.shield.injector.fired) >= 3
    ref = W.run(tmp_path / "base", TIER, params=params, events=W.EVENTS)
    assert ref.shield.tier_log == []
    W.assert_same(run, ref, f"seed {seed}")
