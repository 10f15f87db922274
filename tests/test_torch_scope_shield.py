"""The crash shield and the learner's swaps in the port's scope, against the
JAX package's on the same seeded world: a recovery freezes the flight ring
to disk, a tier transition stamps the tier into the later tick records,
and a params swap or rollback counts and records what the JAX scorer
does (``aiops_learn_swaps_total``, ``aiops_learn_rollbacks_total``,
``aiops_learn_generation``, the ``params_swap`` events). Records are
compared field by field with their times left out. The pattern is
tests/test_scope.py."""
import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_scope_tick import _fence, _mod, _records, _setup
from tests.test_torch_streaming import JAX_PKG, PORT_PKG

torch.set_num_threads(1)


def _shielded(pkg, tmp_path, **extra):
    cluster, builder, incidents, scorer = _setup(pkg, 2, **extra)
    shield = _mod(pkg, "rca.shield").ShieldedScorer(
        scorer, scorer.settings, directory=str(tmp_path / pkg))
    return cluster, builder, incidents, scorer, shield


def _store_churn(pkg, cluster, builder, incidents, shield, n, seed):
    stream = _mod(pkg, "simulator.stream")
    for ev in stream.churn_events(
            cluster, n, seed=seed, structural=False,
            incident_ids=tuple(f"incident:{i.id}" for i in incidents)):
        stream.store_step(cluster, builder.store, ev)
        shield.rescore()


def test_shield_recovery_dumps_the_flight_ring(tmp_path):
    """Any recovery freezes the ring under the shield's own directory: the
    dump parses as JSON, names the recovery and carries tick records; the
    dump counter moved; the same in both packages."""
    def run(pkg):
        metrics = _mod(pkg, "observability.metrics")
        fr = _mod(pkg, "observability.scope").FLIGHT_RECORDER
        cluster, builder, incidents, scorer, shield = _shielded(
            pkg, tmp_path, shield_snapshot_every_ticks=4)
        dumps0 = fr.dumps
        before = metrics.SCOPE_FLIGHT_DUMPS.value(reason="recovery")
        _store_churn(pkg, cluster, builder, incidents, shield, 20, seed=3)
        rec = shield.recover()
        assert fr.dumps > dumps0
        path = fr.last_dump_path
        assert path and os.path.exists(path)
        assert path.startswith(str(tmp_path / pkg))
        doc = json.load(open(path))
        assert any("stages_ms" in r for r in doc["records"])
        assert metrics.SCOPE_FLIGHT_DUMPS.value(reason="recovery") > before
        return rec["mode"], doc["reason"], sorted(doc)

    got = {pkg: run(pkg) for pkg in (JAX_PKG, PORT_PKG)}
    assert got[PORT_PKG] == got[JAX_PKG]
    assert got[PORT_PKG][1].startswith("recovery:")


def test_shield_transition_stamps_the_tier_into_tick_records(tmp_path):
    """A degradation transition dumps the ring once and re-stamps the
    scorer's tier: the next tick's record carries it; a clean pass after
    a failure stamps ``steady`` back."""
    def run(pkg):
        fr = _mod(pkg, "observability.scope").FLIGHT_RECORDER
        cluster, builder, incidents, scorer, shield = _shielded(pkg, tmp_path)
        dumps0 = fr.dumps
        shield._transition("sync_depth1")
        assert fr.dumps == dumps0 + 1
        assert scorer._scope_tier == "sync_depth1"
        marker = _fence(pkg)
        _store_churn(pkg, cluster, builder, incidents, shield, 4, seed=8)
        return _records(pkg, marker)

    got = {pkg: run(pkg) for pkg in (JAX_PKG, PORT_PKG)}
    assert got[PORT_PKG] == got[JAX_PKG]
    ticks = [r for r in got[PORT_PKG] if "tick" in r]
    assert ticks and all(r["tier"] == "sync_depth1" for r in ticks)


def _scaled(tree, f):
    if isinstance(tree, dict):
        return {k: _scaled(v, f) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_scaled(v, f) for v in tree]
    return (np.asarray(tree) * f).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.gnn_backend import (
        SHIPPED_CHECKPOINT, load_validated_checkpoint)
    return load_validated_checkpoint(SHIPPED_CHECKPOINT)


@pytest.mark.parametrize("via", ["scorer", "atomic"])
def test_swap_and_rollback_counters_and_events_match_jax(params, via):
    """A swap (the scorer's own ``swap_params``, or the learner's
    ``swap_tenants_atomically``) then a rollback: the swap and rollback
    counters move by one each, the generation gauge follows, and the
    flight ring holds the same events and tick records as the JAX
    scorer's."""
    def run(pkg):
        metrics = _mod(pkg, "observability.metrics")
        cluster, builder, incidents, scorer = _setup(
            pkg, 2, tier="composed", params=params)
        marker = _fence(pkg)
        swaps0 = metrics.LEARN_SWAPS.value()
        rollbacks0 = metrics.LEARN_ROLLBACKS.value()
        other = _scaled(params, 0.5)
        if via == "atomic":
            gen = _mod(pkg, "rca.surge").swap_tenants_atomically(
                [scorer], other, source="candidate")
        else:
            gen = scorer.swap_params(other, source="candidate")
        served = scorer.rescore()["params_generation"]
        gauge = metrics.LEARN_GENERATION.value()
        back = scorer.rollback_params()
        out = (gen, served, gauge, back, scorer.rescore()["params_generation"],
               metrics.LEARN_GENERATION.value(),
               metrics.LEARN_SWAPS.value() - swaps0,
               metrics.LEARN_ROLLBACKS.value() - rollbacks0)
        return out, _records(pkg, marker)

    got = {pkg: run(pkg) for pkg in (JAX_PKG, PORT_PKG)}
    assert got[PORT_PKG] == got[JAX_PKG]
    (gen, served, gauge, back, after, gauge_after, swaps, rollbacks), recs = \
        got[PORT_PKG]
    assert (gen, served, gauge, back, after, gauge_after) == (1, 1, 1.0, 2, 2,
                                                              2.0)
    assert swaps == rollbacks == 1.0
    events = [r["event"] for r in recs if "event" in r]
    assert events.count("params_swap") == 2
    assert ("params_swap_atomic" in events) == (via == "atomic")
