"""The crash shield around the port's learned scorer on its fused tier
(B3, the whole tick in one kernel): every fault class of the tick, at
pipeline depths 1 and 2, recovers bit-identical to an unfaulted run and
within 1e-5 of the JAX package's shield with the same top-1. Unfaulted,
on the CPU, the fused tier serves the composed tier's bits.
"""
from __future__ import annotations

import pytest

from tests import torch_shield_world as W
from tests.torch_shield_world import params  # noqa: F401  (fixture)

TIER = "fused"


@pytest.fixture(scope="module")
def base(params, tmp_path_factory):  # noqa: F811
    return W.learned_baseline(tmp_path_factory, TIER, params)


@pytest.mark.parametrize("stage", sorted(W.LEARNED_FAULTS))
def test_learned_fault_recovery_bit_parity(stage, base, params,  # noqa: F811
                                           tmp_path):
    W.check_learned_fault(TIER, stage, base, params, tmp_path)


@pytest.mark.parametrize("tier", ["composed", "dma"])
def test_unfaulted_tiers_serve_the_same_bits(tier, base, params,  # noqa: F811
                                             tmp_path):
    """On the CPU the float32 tiers' plain versions are one computation:
    an unfaulted shielded run on the composed or streamed tier ends in
    the fused run's verdicts and packed state, bit for bit, with no tier
    transition. (On the card the packed state is equal and the fused
    chain's probs round within ~2.4e-7 of the composed tick's.)"""
    other = W.run(tmp_path, tier, params=params)
    assert other.shield.tier_log == [] and other.shield.recoveries == 0
    W.assert_same(other, base["ref"], f"{tier} vs fused")
