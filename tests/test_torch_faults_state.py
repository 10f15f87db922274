"""The port's fault injector (``rca/faults.py``) on the port's state: the
corruptions write NaN into the port scorer's resident feature tensor on
its own device, the mutation recorder counts duplicates as the JAX one
does, and the port's ingest seams take this injector (tests/test_storm.py's
chaos sweep over parse|dedup|persist|admit, the admitted set equal to an
unfaulted run's and to the JAX app's under the same schedule)."""
from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu.rca import faults as j_faults
from kubernetes_aiops_evidence_graph_tpu_torch.rca import faults as t_faults
from tests.test_torch_streaming import PORT_PKG, _world

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scorer():
    from kubernetes_aiops_evidence_graph_tpu_torch.config import load_settings
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.streaming import (
        StreamingScorer)
    cfg = load_settings(node_bucket_sizes=(512, 2048),
                        incident_bucket_sizes=(8, 32))
    cluster, builder, _ = _world(PORT_PKG, cfg, num_pods=60)
    return StreamingScorer(builder.store, cfg, now_s=cluster.now.timestamp(),
                           device="cpu")


@pytest.mark.parametrize("kind", ["device_loss", "corrupt_silent",
                                  "shard_loss", "shard_corrupt_silent"])
def test_corruptions_write_nan_into_the_resident_features(scorer, kind):
    """device_loss / corrupt_silent replace the feature tensor with NaN;
    shard_loss / shard_corrupt_silent NaN one shard's block in place (one
    card is one shard: every row, for any shard index). Only the silent
    kinds return; the others raise, shard_loss with the shard attached.
    Every other resident tensor is untouched."""
    feats = scorer._features_dev.clone()
    others = [t.clone() for t in scorer._resident_arrays()[1:]]
    inj = t_faults.FaultInjector([t_faults.Fault("execute", at=0, kind=kind,
                                                 shard=3)])
    try:
        if kind.endswith("silent"):
            inj.at("execute", scorer)
        else:
            with pytest.raises(t_faults.InjectedFault) as err:
                inj.at("execute", scorer)
            assert err.value.kind == kind
            assert err.value.shard == (0 if kind == "shard_loss" else None)
        now = scorer._features_dev
        assert now.shape == feats.shape and now.dtype == feats.dtype
        assert now.device == feats.device
        assert torch.isnan(now).all()
        for t, u in zip(others, scorer._resident_arrays()[1:]):
            assert torch.equal(t, u)
    finally:
        scorer._features_dev = feats
    assert t_faults.FaultInjector._corrupt_shard(object(), 5) == 0


def test_mutation_recorder_counts_duplicates():
    class Backend:
        def delete_pod(self, ns, name):
            return f"deleted {ns}/{name}"

        def get_pod(self, ns, name):
            return name

    for mod in (t_faults, j_faults):
        rec = mod.MutationRecorder(Backend())
        assert rec.delete_pod("a", "p") == "deleted a/p"
        rec.delete_pod("a", "p")
        rec.get_pod("a", "q")
        assert rec.calls == [("delete_pod", "a", "p")] * 2
        assert rec.duplicates() == [("delete_pod", "a", "p")]


# -- the ingest seams under the port's injector (tests/test_storm.py) -------

def _storm_alert(name: str, severity: str, ns: str) -> dict:
    return {"status": "firing",
            "labels": {"alertname": name, "namespace": ns,
                       "service": "checkout", "severity": severity},
            "annotations": {"summary": f"{name} fired"},
            "startsAt": "2026-07-29T08:00:00Z"}


def _ingest_run(pkg, batches, injector=None) -> list:
    cfg = importlib.import_module(pkg + ".config").load_settings(
        app_env="development", rca_backend="cpu", db_path=":memory:",
        ingest_columnar=True, ingest_admission=True,
        admission_rate_per_sec=1e6, admission_burst=1e6,
        storm_dwell_s=3600.0, verification_wait_seconds=0,
        breaker_failure_threshold=2, breaker_cooldown_s=0.0,
        node_bucket_sizes=(512, 2048), incident_bucket_sizes=(8, 32))
    sim = importlib.import_module(pkg + ".simulator")
    columnar = importlib.import_module(pkg + ".ingestion.columnar")
    kw = {"device": "cpu"} if pkg == PORT_PKG else {}
    app = importlib.import_module(pkg + ".app").AiopsApp(
        sim.generate_cluster(num_pods=20, seed=5), cfg, **kw)
    app.fault_injector = injector          # worker loop NOT started
    try:
        for alerts in batches:
            for _attempt in range(10):
                try:
                    app.ingest_batch(
                        columnar.normalize_alertmanager_batch(alerts))
                    break
                except RuntimeError:       # parse faults retry
                    continue
            else:
                raise AssertionError("parse fault persisted past 10 retries")
        app._persist_breaker.reset()
        app._replay_spill()
        return sorted(r["fingerprint"] for r in app.db.query(
            "SELECT fingerprint FROM incidents"))
    finally:
        app.db.close()


@pytest.mark.parametrize("seed", [20260805, 3])
def test_ingest_chaos_sweep_admitted_set_parity(seed):
    """Chaos over parse|dedup|persist|admit through the port app's seams:
    parse faults retry, dedup/admit fail open, persist faults ride the
    breaker + spill + replay; the persisted set equals the unfaulted run's
    and the JAX app's under the same schedule."""
    rng = np.random.default_rng(7)
    sevs = ("critical", "warning", "info", "high", "low")
    universe = [_storm_alert(f"U{i}", sevs[i % 5], f"ns{i % 3}")
                for i in range(30)]
    batches = [[universe[j] for j in rng.integers(0, 30, 12)]
               for _ in range(12)]
    base = _ingest_run(PORT_PKG, batches)
    sched = dict(ticks=len(batches) * 3, rate=0.2,
                 stages=t_faults.INGEST_STAGES)
    inj = t_faults.FaultInjector.seeded(seed, **sched)
    got = _ingest_run(PORT_PKG, batches, inj)
    assert inj.fired, "the schedule never fired"
    assert got == base
    j_inj = j_faults.FaultInjector.seeded(seed, **sched)
    assert _ingest_run("kubernetes_aiops_evidence_graph_tpu", batches,
                       j_inj) == got
    assert j_inj.fired == inj.fired
