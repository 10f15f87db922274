"""The port's ingestion edge against the JAX package's: the same webhook
payloads (made from a seed) normalize to the same incident specs and
fingerprints on the dict and the columnar paths; dedup, the rate limiter,
admission, its storm mode and the persist breaker take the same decisions
on the same sequence under the same clock. The patterns are
tests/test_ingestion.py and tests/test_ingest_columnar.py."""
from __future__ import annotations

import numpy as np
import pytest

from kubernetes_aiops_evidence_graph_tpu.config import load_settings as j_settings
from kubernetes_aiops_evidence_graph_tpu.ingestion import admission as j_adm
from kubernetes_aiops_evidence_graph_tpu.ingestion import columnar as j_col
from kubernetes_aiops_evidence_graph_tpu.ingestion import dedup as j_dedup
from kubernetes_aiops_evidence_graph_tpu.ingestion import normalizer as j_norm
from kubernetes_aiops_evidence_graph_tpu_torch.config import load_settings as t_settings
from kubernetes_aiops_evidence_graph_tpu_torch.ingestion import admission as t_adm
from kubernetes_aiops_evidence_graph_tpu_torch.ingestion import columnar as t_col
from kubernetes_aiops_evidence_graph_tpu_torch.ingestion import dedup as t_dedup
from kubernetes_aiops_evidence_graph_tpu_torch.ingestion import normalizer as t_norm

SEVERITIES = ("critical", "high", "warning", "low", "info", "weird", None)


def _alert(rng: np.random.Generator, i: int) -> dict:
    """One Alertmanager alert with the variations the normalizers branch
    on: status, severity spellings, service from service/app/pod labels,
    summary and description annotations, absent startsAt."""
    labels = {"alertname": f"Alert{int(rng.integers(0, 6))}",
              "namespace": f"ns-{int(rng.integers(0, 3))}"}
    sev = SEVERITIES[int(rng.integers(0, len(SEVERITIES)))]
    if sev is not None:
        labels["severity"] = sev
    key = ("service", "app", "deployment", "pod", None)[int(rng.integers(0, 5))]
    if key == "pod":
        labels["pod"] = f"api-{i}-7d4f5b6c8-xyz{i:02d}"
    elif key is not None:
        labels[key] = f"svc-{int(rng.integers(0, 4))}"
    if rng.random() < 0.3:
        labels["cluster"] = "east"
    annotations = {}
    if rng.random() < 0.5:
        annotations["summary"] = f"summary {i}"
    if rng.random() < 0.5:
        annotations["description"] = f"description {i}"
    alert = {"status": "firing" if rng.random() < 0.8 else "resolved",
             "labels": labels, "annotations": annotations}
    if rng.random() < 0.7:
        alert["startsAt"] = f"2026-07-29T08:{i % 60:02d}:00Z"
    return alert


def _alerts(seed: int, n: int = 24) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [_alert(rng, i) for i in range(n)]


def _spec_dict(spec, has_start: bool) -> dict:
    d = spec.model_dump(mode="json")
    if not has_start:
        d.pop("started_at")        # utcnow() at normalization
    return d


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_normalizer_alertmanager_matches_jax(seed):
    for a in _alerts(seed):
        want = j_norm.AlertNormalizer.normalize_alertmanager(a)
        got = t_norm.AlertNormalizer.normalize_alertmanager(a)
        assert _spec_dict(got, "startsAt" in a) == \
            _spec_dict(want, "startsAt" in a)
        prom_j = j_norm.AlertNormalizer.normalize_prometheus(a)
        prom_t = t_norm.AlertNormalizer.normalize_prometheus(a)
        assert prom_t.fingerprint == prom_j.fingerprint
        assert prom_t.source.value == prom_j.source.value


@pytest.mark.parametrize("with_labels", [True, False])
def test_normalizer_grafana_matches_jax(with_labels):
    alerts = _alerts(3, 12)
    if not with_labels:
        for a in alerts:
            a["labels"] = {}
    payload = {"title": "Grafana: high latency", "message": "p99 over 2s",
               "alerts": alerts}
    want = j_norm.AlertNormalizer.normalize_grafana(payload)
    got = t_norm.AlertNormalizer.normalize_grafana(payload)
    assert len(got) == len(want) == len(alerts)
    for g, w, a in zip(got, want, alerts):
        assert _spec_dict(g, "startsAt" in a) == _spec_dict(w, "startsAt" in a)


def _cols_equal(got, want) -> None:
    assert got.source.value == want.source.value
    assert got.malformed == want.malformed
    for name in ("valid", "firing", "fingerprint", "title", "description",
                 "severity_code", "cluster", "namespace", "service"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert np.array_equal(got.started_unix, want.started_unix, equal_nan=True)
    assert got.labels == want.labels and got.annotations == want.annotations


@pytest.mark.parametrize("kind", ["alertmanager", "prometheus", "grafana"])
def test_columnar_batch_matches_jax(kind):
    alerts = _alerts(4, 32)
    # malformed rows: a non-dict alert, labels that are not a dict
    alerts[5] = "not an alert"
    alerts[9] = {"status": "firing", "labels": ["x"], "annotations": {}}
    if kind == "grafana":
        payload = {"title": "t", "message": "m", "alerts": alerts}
        want = j_col.normalize_grafana_batch(payload)
        got = t_col.normalize_grafana_batch(payload)
    else:
        fn = f"normalize_{kind}_batch"
        want = getattr(j_col, fn)(alerts)
        got = getattr(t_col, fn)(alerts)
    _cols_equal(got, want)
    starts = np.isfinite(want.started_unix)
    for i, (g, w) in enumerate(zip(got.specs(), want.specs())):
        row = int(np.flatnonzero(want.eligible)[i])
        assert _spec_dict(g, starts[row]) == _spec_dict(w, starts[row])


def test_columnar_specs_equal_the_dict_path():
    """Within the port: the columnar specs of firing rows are the dict
    normalizer's, field for field."""
    alerts = [a for a in _alerts(5, 40) if a["status"] == "firing"]
    cols = t_col.normalize_alertmanager_batch(alerts)
    for a, spec in zip(alerts, cols.specs()):
        want = t_norm.AlertNormalizer.normalize_alertmanager(a)
        assert _spec_dict(spec, "startsAt" in a) == \
            _spec_dict(want, "startsAt" in a)


def _fps(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [f"{int(x):032x}" for x in rng.integers(0, 40, n)]


@pytest.mark.parametrize("columnar", [True, False])
def test_dedup_decisions_match_jax(columnar):
    """The same check / register / release / expiry sequence gives the
    same answers, on the hashed ring and on the dict TTL set."""
    clock = [0.0]
    kw = dict(ingest_columnar=columnar, dedup_ttl_seconds=100,
              ingest_dedup_window=64)
    dj = j_dedup.AlertDeduplicator(j_settings(**kw), clock=lambda: clock[0])
    dt = t_dedup.AlertDeduplicator(t_settings(**kw), clock=lambda: clock[0])
    rng = np.random.default_rng(7)
    for step, fp in enumerate(_fps(8, 300)):
        op = int(rng.integers(0, 4))
        if op == 0:
            assert dt.check_duplicate(fp) == dj.check_duplicate(fp)
        elif op == 1:
            dj.register_fingerprint(fp)
            dt.register_fingerprint(fp)
        elif op == 2:
            dj.release(fp)
            dt.release(fp)
        else:
            batch = _fps(step, 12)
            assert np.array_equal(dt.check_batch(batch), dj.check_batch(batch))
            dj.register_batch(batch[:6])
            dt.register_batch(batch[:6])
        clock[0] += float(rng.random()) * 3.0


def test_dedup_ring_eviction_matches_jax():
    """Past its capacity the ring evicts the oldest expiry: both rings keep
    and drop the same fingerprints."""
    clock = [0.0]
    rj = j_dedup.FingerprintRing(capacity=16, clock=lambda: clock[0])
    rt = t_dedup.FingerprintRing(capacity=16, clock=lambda: clock[0])
    fps = [f"{i * 7919:032x}" for i in range(60)]
    for i, fp in enumerate(fps):
        clock[0] = float(i)
        rj.add(fp, 1000.0)
        rt.add(fp, 1000.0)
    assert np.array_equal(rt.contains_batch(fps), rj.contains_batch(fps))
    assert rt.occupancy() == rj.occupancy()


def test_rate_limiter_matches_jax():
    clock = [0.0]
    kw = dict(webhook_rate_limit_per_minute=5)
    lj = j_dedup.RateLimiter(j_settings(**kw), clock=lambda: clock[0])
    lt = t_dedup.RateLimiter(t_settings(**kw), clock=lambda: clock[0])
    rng = np.random.default_rng(9)
    for _ in range(200):
        c = f"client-{int(rng.integers(0, 3))}"
        assert lt.check_rate_limit(c) == lj.check_rate_limit(c)
        assert lt.retry_after_s() == lj.retry_after_s()
        clock[0] += float(rng.random()) * 4.0


def test_admission_shed_order_matches_jax():
    """A dry bucket sheds the same rows, lowest severity first (critical
    never), with the same Retry-After, in both packages."""
    clock = [0.0]
    kw = dict(admission_rate_per_sec=10.0, admission_burst=20.0)
    aj = j_adm.AdmissionController(j_settings(**kw), clock=lambda: clock[0])
    at = t_adm.AdmissionController(t_settings(**kw), clock=lambda: clock[0])
    rng = np.random.default_rng(11)
    for _ in range(12):
        n = int(rng.integers(5, 40))
        tenants = np.array([f"ns-{int(t)}" for t in rng.integers(0, 3, n)],
                           dtype=object)
        sev = rng.integers(0, 5, n).astype(np.int8)
        charge = rng.random(n) < 0.8
        mj, rj = aj.admit_batch(tenants, sev, chargeable=charge)
        mt, rt = at.admit_batch(tenants, sev, chargeable=charge)
        assert np.array_equal(mt, mj) and rt == rj
        assert at.shed_by_severity == aj.shed_by_severity
        assert not (~mt & (sev == 0)).any()      # critical never sheds
        clock[0] += float(rng.random())
    assert at.shed > 0 and at.shed == aj.shed and at.admitted == aj.admitted


def test_storm_mode_and_breaker_match_jax():
    clock = [0.0]
    sj = j_adm.StormMode(j_settings(storm_dwell_s=1.0), clock=lambda: clock[0])
    st = t_adm.StormMode(t_settings(storm_dwell_s=1.0), clock=lambda: clock[0])
    bj = j_adm.CircuitBreaker("persist", 3, 2.0, clock=lambda: clock[0])
    bt = t_adm.CircuitBreaker("persist", 3, 2.0, clock=lambda: clock[0])
    rng = np.random.default_rng(13)
    for _ in range(200):
        hi, lo = bool(rng.random() < 0.6), bool(rng.random() < 0.5)
        assert st.update(hi, lo) == sj.update(hi, lo)
        allowed = bt.allow()
        assert allowed == bj.allow()
        if allowed:
            ok = bool(rng.random() < 0.5)
            for b in (bj, bt):
                b.record_success() if ok else b.record_failure()
        assert bt.state == bj.state
        clock[0] += float(rng.random()) * 0.7
    assert (st.entries, st.exits) == (sj.entries, sj.exits)
    assert st.entries > 0 and bt.opens == bj.opens > 0
    sj.force(False)
    st.force(False)
