"""The crash shield around the port's learned scorer on its composed tier
(B2 per layer): every fault class of the tick, at pipeline depths 1 and 2,
recovers bit-identical to an unfaulted run (verdicts and packed resident
state) and within 1e-5 of the JAX package's shield with the same top-1;
silent corruption is repaired by the attestation fold, or, with it off,
caught by the finite verdict guard.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu_torch.rca import heal
from tests import torch_shield_world as W
from tests.torch_shield_world import params  # noqa: F401  (fixture)

TIER = "composed"


@pytest.fixture(scope="module")
def base(params, tmp_path_factory):  # noqa: F811
    return W.learned_baseline(tmp_path_factory, TIER, params)


@pytest.mark.parametrize("stage", sorted(W.LEARNED_FAULTS))
def test_learned_fault_recovery_bit_parity(stage, base, params,  # noqa: F811
                                           tmp_path):
    W.check_learned_fault(TIER, stage, base, params, tmp_path)


def test_learned_silent_corruption_caught_by_the_verdict_guard(
        params, base, tmp_path):  # noqa: F811
    """With attestation off, silent corruption of the learned state
    reaches the verdict: NaN probs never serve, the finite guard
    quarantines and recovers, bit parity."""
    cfg = W.settings(tier=TIER, mesh_attest=False)
    run = W.run(tmp_path, TIER, params=params, cfg=cfg, faults=[
        dict(stage="execute", at=1, kind="corrupt_silent")])
    assert run.shield.attest_repairs == 0
    assert run.shield.quarantined_batches >= 1
    assert np.isfinite(run.out["probs"]).all()
    W.assert_same(run, base["ref"], "verdict guard",
                  with_packed=run.shield.scorer.rebuilds == 0)


def test_a_finite_bit_flip_is_flagged_and_repaired_by_attestation(
        params, base, tmp_path):  # noqa: F811
    """The lowest mantissa bit of one resident feature flipped: the fold
    flags exactly the feature table (the learned scorer also attests its
    node kinds and masks), the next snapshot boundary repairs it, and the
    run ends bit-identical to the unfaulted one."""
    flagged = []

    def flip(i, shield):
        if i != 1:
            return
        s = shield.scorer
        with s._on_stream():
            s._features_dev.view(torch.int32)[1, 0] ^= 1
        pairs = s._attest_arrays()
        assert [a for a, _ in pairs] == ["_features_dev", "_kind_dev",
                                         "_nmask_dev"]
        fold = heal.attest_fold(*[getattr(s, a) for a, _ in pairs], shards=1)
        bad = fold.numpy() != heal.attest_host([h for _, h in pairs], 1)
        flagged.extend(a for (a, _), row in zip(pairs, bad) if row.any())
        shield.snapshot_now()

    run = W.run(tmp_path, TIER, params=params, during=flip)
    assert flagged == ["_features_dev"]
    assert run.shield.recoveries == 0 and run.shield.attest_repairs == 1
    W.assert_same(run, base["ref"], "attested repair of a finite flip")
