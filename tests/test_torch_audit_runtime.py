"""The port's runtime guards (``kubernetes_aiops_evidence_graph_tpu_torch/
analysis/runtime_guards.py``) on the CPU. ``chip_smoke.py`` phase 23
drives the same guards over the serving tiers on the card, where the
sync guard bites.

* ``LockOrderGuard`` flags a seeded two-lock cycle, wraps and restores
  the port's module-level locks and the lock factories, and stays clean
  over a shielded learned scenario: ingest, ticks and a learner swap.
* ``BuildFence`` fails on a forced kernel load after arming, and on
  every tier the CPU path builds and loads nothing while the resident
  tensors keep their ``data_ptr()`` over ten churn ticks.
* ``no_implicit_syncs`` sets the error mode over its block and restores
  the previous mode, also when the block raises.
"""
import threading

import numpy as np
import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu_torch import rca as t_rca
from kubernetes_aiops_evidence_graph_tpu_torch.analysis import runtime_guards
from kubernetes_aiops_evidence_graph_tpu_torch.analysis.runtime_guards import (
    MODULE_LOCKS, BuildFence, LockOrderGuard, no_implicit_syncs,
    resident_pointers)
from kubernetes_aiops_evidence_graph_tpu_torch.kernels import _build
from kubernetes_aiops_evidence_graph_tpu_torch.parallel import compat
from kubernetes_aiops_evidence_graph_tpu_torch.rca import shield as t_shield
from tests import torch_shield_world as W
from tests.torch_shield_world import params  # noqa: F401  (fixture)

# one intra-op thread: these tensors are small, and the suite runs
# several pytest workers side by side on the host's cores
torch.set_num_threads(1)

TICKS, EVENTS_PER_TICK = 10, 6


def test_lock_order_guard_flags_a_seeded_cycle():
    with LockOrderGuard() as guard:
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        assert guard.violations == [] and guard.edges == 1
        with b:
            with a:            # the reverse order closes the cycle
                pass
    assert len(guard.violations) == 1
    with pytest.raises(AssertionError, match="lock-order cycles"):
        guard.assert_clean()


def test_lock_order_guard_wraps_and_restores_the_module_locks():
    real_factory = threading.Lock
    real = [_build._lock, t_rca._BUILD_LOCK, compat._STREAMS_LOCK]
    assert len(MODULE_LOCKS) == len(real)
    with LockOrderGuard() as guard:
        assert threading.Lock is not real_factory
        wrapped = [_build._lock, t_rca._BUILD_LOCK, compat._STREAMS_LOCK]
        assert all(isinstance(w, runtime_guards._GuardedLock)
                   for w in wrapped)
        with compat._STREAMS_LOCK:
            with _build._lock:
                pass
        assert guard.edges == 1
    assert threading.Lock is real_factory
    assert [_build._lock, t_rca._BUILD_LOCK, compat._STREAMS_LOCK] == real


def test_lock_order_guard_is_clean_over_a_shielded_learned_scenario(
        params, tmp_path):  # noqa: F811
    """Ingest, ticks (async and fetched) and a learner swap through the
    shield, every lock created under the guard: no acquisition cycle."""
    from kubernetes_aiops_evidence_graph_tpu_torch.learn import OnlineLearner
    from kubernetes_aiops_evidence_graph_tpu_torch.rca import gnn
    from kubernetes_aiops_evidence_graph_tpu_torch.simulator.stream import (
        churn_events, store_step)
    rng = np.random.default_rng(3)
    params_b = gnn.unflat_params({
        k: (np.asarray(v) + rng.normal(0, 0.01, np.shape(v))).astype(
            np.float32) for k, v in gnn.flat_params(params).items()})
    with LockOrderGuard() as guard:
        cfg = W.settings(tier="composed")
        cluster, builder, _ = W._world(W.PORT_PKG, cfg, seed=3, num_pods=100)
        scorer = W.make_scorer(W.PORT_PKG, "composed", builder.store, cfg,
                               cluster.now.timestamp(), params)
        shield = t_shield.ShieldedScorer(scorer, cfg,
                                         directory=str(tmp_path))
        try:
            shield.recover_or_snapshot()
            events = list(churn_events(cluster, 40, seed=4, incident_ids=tuple(
                builder.store.incident_ids())))
            for i, ev in enumerate(events):
                store_step(cluster, builder.store, ev)
                if i % 10 == 9:
                    shield.tick_async()
                if i == 19:
                    learner = OnlineLearner(None, [shield], settings=cfg)
                    assert learner.swap(params_b) == 1
            out = shield.rescore()
        finally:
            shield.close()
    assert out["params_generation"] == 1
    assert np.isfinite(out["probs"]).all()
    assert guard.edges > 0
    guard.assert_clean()


def test_build_fence_fails_on_a_forced_load_after_arming(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "load", lambda name: calls.append(name))
    with BuildFence() as fence:
        _build.load("rules_fold")          # before arming: counted only
        fence.arm()
        _build.load("gms")
        assert calls == ["rules_fold", "gms"]
        assert (fence.loads, fence.builds) == (2, 0)
        with pytest.raises(AssertionError, match="after the fence"):
            fence.assert_clean()
    assert calls == ["rules_fold", "gms"]


@pytest.mark.parametrize("tier", ["rules", "composed", "fused", "dma",
                                  "dma_int8"])
def test_cpu_ticks_build_nothing_and_keep_their_resident_pointers(
        tier, params):  # noqa: F811
    from kubernetes_aiops_evidence_graph_tpu_torch.simulator.stream import (
        churn_events, store_step)
    cfg = W.settings(tier=tier)
    cluster, builder, _ = W._world(W.PORT_PKG, cfg, seed=9, num_pods=100)
    scorer = W.make_scorer(W.PORT_PKG, tier, builder.store, cfg,
                           cluster.now.timestamp(), params)
    scorer.rescore()
    events = list(churn_events(cluster, TICKS * EVENTS_PER_TICK, seed=10,
                               incident_ids=tuple(
                                   builder.store.incident_ids())))
    with BuildFence() as fence:
        fence.arm()
        ptrs, rebuilds = resident_pointers(scorer), scorer.rebuilds
        assert len(ptrs) >= (5 if tier == "rules" else 11)
        for t in range(TICKS):
            for ev in events[t * EVENTS_PER_TICK:(t + 1) * EVENTS_PER_TICK]:
                store_step(cluster, builder.store, ev)
            with no_implicit_syncs():
                scorer.tick_async()
            assert resident_pointers(scorer) == ptrs, f"tick {t}"
        out = scorer.rescore()
    assert scorer.rebuilds == rebuilds
    assert (fence.builds, fence.loads) == (0, 0)
    fence.assert_clean()
    assert out["incident_ids"]
    # a reallocation shows: the pointers name the tensor that moved
    scorer._features_dev = scorer._features_dev.clone()
    moved = resident_pointers(scorer)
    assert [k for k in moved if moved[k] != ptrs[k]] == ["resident[0]"]


def test_no_implicit_syncs_restores_the_previous_mode(monkeypatch):
    modes = [0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    with no_implicit_syncs():
        assert modes[-1] == "error"
    assert modes == [0, "error", 0]
    with pytest.raises(RuntimeError):
        with no_implicit_syncs():
            raise RuntimeError("a sync inside the block")
    assert modes[-1] == 0
