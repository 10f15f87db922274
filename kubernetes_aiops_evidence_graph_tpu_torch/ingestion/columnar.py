"""graft-intake: vectorized columnar webhook ingest.

The dict path (normalizer.AlertNormalizer) builds one pydantic
IncidentCreate per alert — per-row dict walks, per-row sha256, per-row
timestamp parse. Under an alert storm that is the ingest bottleneck the
flight recorder measured (ROADMAP item 2). This module transposes a whole
webhook batch into NumPy columns in ONE pass over the payload (the
unavoidable JSON→column transpose, ~a dozen dict.gets per alert) and then
derives everything else as array ops over those columns:

* severity mapping, service-label priority (service>app>deployment>job>
  pod-stripped), title fallbacks — np.where chains over object columns;
* fingerprints — the ``source:alertname:namespace:service`` keys are
  composed by elementwise object concatenation and sha256 runs once per
  UNIQUE key (np.unique + inverse take), so a storm of duplicate alerts
  hashes each distinct alert once, not once per row;
* timestamps — parsed once per unique ``startsAt`` string;
* malformed rows (labels not a dict, unparseable timestamp, non-dict
  alert) are MASKED and counted, never raised — one bad row in a batch
  of 10k must not 500 the whole webhook.

pydantic spec construction is deferred to :meth:`ColumnarAlerts.specs`,
which the ingest edge calls only for rows that SURVIVED the (vectorized)
dedup check — the common storm row (a duplicate) never touches pydantic
at all. Row-for-row parity with the dict normalizer is pinned by
tests/test_ingest_columnar.py for all three webhook formats.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Iterable

import numpy as np

from ..models import IncidentCreate, IncidentSource, Severity
from ..utils.timeutils import parse_iso, utcnow
from .normalizer import _SEVERITY_MAP

# severity codes: index into this tuple == the int8 column value
_SEVERITY_ORDER: tuple[Severity, ...] = (
    Severity.CRITICAL, Severity.HIGH, Severity.MEDIUM, Severity.LOW,
    Severity.INFO)
_SEVERITY_CODE = {s: i for i, s in enumerate(_SEVERITY_ORDER)}
_DEFAULT_SEV_CODE = _SEVERITY_CODE[Severity.MEDIUM]

# vectorized helpers over object columns (C-driven elementwise loops —
# no per-row Python frames in the caller)
_LEN = np.frompyfunc(len, 1, 1)
_TRUNC500 = np.frompyfunc(lambda s: s[:500], 1, 1)

_TS_MISSING = np.nan          # started_unix sentinel: fall back to utcnow()


def _strip_pod(name: str) -> str:
    """Reference pod→service stripping (normalizer._service_from)."""
    parts = name.rsplit("-", 2)
    return parts[0] if len(parts) == 3 else name


def _obj(n: int, fill: str = "") -> np.ndarray:
    col = np.empty(n, dtype=object)
    col[:] = fill
    return col


@dataclass
class ColumnarAlerts:
    """One webhook batch, transposed: parallel columns over the rows.

    ``valid`` masks malformed rows out of every downstream consumer;
    ``firing`` carries the Alertmanager status filter (grafana payloads
    set it True everywhere — the dict path ingests them regardless of
    status, parity preserved). String columns are object arrays with
    ``""`` for absent-or-empty (``or``-semantics fields); fields whose
    dict-path default is resolved by ``dict.get`` (namespace, cluster)
    carry the default already applied at transpose time."""

    source: IncidentSource
    valid: np.ndarray                 # bool  [B]
    firing: np.ndarray                # bool  [B]
    fingerprint: np.ndarray           # object[B] 32-hex
    title: np.ndarray                 # object[B]
    description: np.ndarray           # object[B] ("" -> None in specs)
    severity_code: np.ndarray         # int8  [B] index into _SEVERITY_ORDER
    cluster: np.ndarray               # object[B]
    namespace: np.ndarray             # object[B]
    service: np.ndarray               # object[B] ("" -> None in specs)
    started_unix: np.ndarray          # float64[B] epoch s (NaN -> utcnow)
    labels: list                      # per-row label dicts (spec payload)
    annotations: list                 # per-row annotation dicts
    malformed: int = 0
    field_defaults: dict = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.valid)

    @property
    def eligible(self) -> np.ndarray:
        """Rows the ingest edge should consider: well-formed AND firing."""
        return self.valid & self.firing

    def specs(self, rows: Iterable[int] | np.ndarray | None = None
              ) -> list[IncidentCreate]:
        """Materialize IncidentCreate specs for ``rows`` (default: every
        eligible row). Called AFTER dedup on the hot path, so duplicate
        storm rows never pay pydantic validation."""
        if rows is None:
            rows = np.flatnonzero(self.eligible)
        now = None
        out = []
        for i in rows:
            i = int(i)
            ts = self.started_unix[i]
            if np.isnan(ts):
                if now is None:
                    now = utcnow()
                started = now
            else:
                started = datetime.fromtimestamp(float(ts), tz=timezone.utc)
            out.append(IncidentCreate(
                fingerprint=self.fingerprint[i],
                title=self.title[i],
                description=self.description[i] or None,
                severity=_SEVERITY_ORDER[int(self.severity_code[i])],
                source=self.source,
                cluster=self.cluster[i],
                namespace=self.namespace[i],
                service=self.service[i] or None,
                labels=dict(self.labels[i]),
                annotations=dict(self.annotations[i]),
                started_at=started,
            ))
        return out


def _s(v) -> str:
    """Coerce a raw payload field to str ("" for None): object columns
    must stay uniformly str-typed or np.unique's sort would raise on a
    mixed-type storm row."""
    if isinstance(v, str):
        return v
    return "" if v is None else str(v)


def _transpose(alerts: list, n: int) -> dict:
    """The single pass over the payload: raw fields → object columns.
    Defaults resolvable by ``dict.get`` are applied here (namespace /
    cluster); ``or``-semantics fields keep "" so the vectorized
    fallback chains below reproduce the dict path exactly."""
    cols = {
        "valid": np.ones(n, bool),
        "status": _obj(n),
        "alertname": _obj(n),
        "has_alertname": np.zeros(n, bool),
        "namespace": _obj(n, "default"),
        "cluster": _obj(n, "default"),
        "severity_raw": _obj(n),
        "service_l": _obj(n), "app_l": _obj(n), "deploy_l": _obj(n),
        "job_l": _obj(n), "pod_l": _obj(n),
        "summary": _obj(n), "description": _obj(n),
        "starts": _obj(n),
        "labels": [{}] * n, "annotations": [{}] * n,
    }
    for i, alert in enumerate(alerts):
        if not isinstance(alert, dict):
            cols["valid"][i] = False
            continue
        labels = alert.get("labels") or {}
        ann = alert.get("annotations") or {}
        if not isinstance(labels, dict) or not isinstance(ann, dict):
            cols["valid"][i] = False
            continue
        cols["status"][i] = _s(alert.get("status"))
        if "alertname" in labels:
            cols["has_alertname"][i] = True
            cols["alertname"][i] = _s(labels["alertname"])
        cols["namespace"][i] = _s(labels.get("namespace", "default"))
        cols["cluster"][i] = _s(labels.get("cluster", "default"))
        cols["severity_raw"][i] = _s(labels.get("severity"))
        cols["service_l"][i] = _s(labels.get("service"))
        cols["app_l"][i] = _s(labels.get("app"))
        cols["deploy_l"][i] = _s(labels.get("deployment"))
        cols["job_l"][i] = _s(labels.get("job"))
        cols["pod_l"][i] = _s(labels.get("pod"))
        cols["summary"][i] = _s(ann.get("summary"))
        cols["description"][i] = _s(ann.get("description"))
        cols["starts"][i] = _s(alert.get("startsAt"))
        cols["labels"][i] = labels
        cols["annotations"][i] = ann
    return cols


def _map_unique(col: np.ndarray, fn) -> np.ndarray:
    """Apply ``fn`` once per UNIQUE value of an object column and
    broadcast back — the storm-shaped transform (duplicate-heavy columns
    pay O(unique), not O(rows))."""
    uniq, inv = np.unique(col, return_inverse=True)
    mapped = np.empty(len(uniq), dtype=object)
    mapped[:] = [fn(u) for u in uniq]
    return mapped[inv]


def _severity_codes(raw: np.ndarray) -> np.ndarray:
    uniq, inv = np.unique(raw, return_inverse=True)
    codes = np.array(
        [_SEVERITY_CODE.get(_SEVERITY_MAP.get(str(u).lower()),
                            _DEFAULT_SEV_CODE) for u in uniq],
        dtype=np.int8)
    return codes[inv]


def _fingerprints(source: str, alertname: np.ndarray, namespace: np.ndarray,
                  service: np.ndarray) -> np.ndarray:
    """sha256 once per unique (alertname, namespace, service) key.
    Identical to utils.hashing.alert_fingerprint row for row."""
    keys = (source + ":") + alertname + (":" + namespace) + (":" + service)
    return _map_unique(
        keys, lambda k: hashlib.sha256(str(k).encode()).hexdigest()[:32])


def _timestamps(starts: np.ndarray, valid: np.ndarray
                ) -> tuple[np.ndarray, int]:
    """Parse once per unique startsAt; unparseable rows are masked out of
    ``valid`` (in place) and counted, not raised."""
    uniq, inv = np.unique(starts, return_inverse=True)
    epoch = np.empty(len(uniq), np.float64)
    bad = np.zeros(len(uniq), bool)
    for j, u in enumerate(uniq):
        if not u:
            epoch[j] = _TS_MISSING
            continue
        try:
            epoch[j] = parse_iso(str(u)).timestamp()
        except (ValueError, TypeError):
            epoch[j] = _TS_MISSING
            bad[j] = True
    bad_rows = bad[inv] & valid
    valid &= ~bad_rows
    return epoch[inv], int(bad_rows.sum())


def _derive(cols: dict, source: IncidentSource, n: int,
            fallback_title: str = "", fallback_desc: str = "",
            fp_alertname_default: str = "") -> ColumnarAlerts:
    """Array-op derivations over the transposed columns — the vectorized
    twin of AlertNormalizer's per-row logic."""
    valid = cols["valid"]
    started, ts_bad = _timestamps(cols["starts"], valid)
    malformed = int((~valid).sum())

    # service priority chain; pod names stripped per unique pod
    pod_svc = _map_unique(cols["pod_l"], _strip_pod)
    service = np.where(
        cols["service_l"] != "", cols["service_l"],
        np.where(cols["app_l"] != "", cols["app_l"],
                 np.where(cols["deploy_l"] != "", cols["deploy_l"],
                          np.where(cols["job_l"] != "", cols["job_l"],
                                   pod_svc))))

    # title: summary[:500] if present, else "alertname: subject" / alertname
    subject = np.where(
        cols["pod_l"] != "", cols["pod_l"],
        np.where(cols["deploy_l"] != "", cols["deploy_l"],
                 cols["service_l"]))
    named = np.where(cols["alertname"] != "", cols["alertname"],
                     "UnknownAlert")
    title = np.where(
        cols["summary"] != "", _TRUNC500(cols["summary"]),
        np.where(subject != "", named + ": " + subject, named))
    if fallback_title:
        # grafana: alerts with NO labels fall back to the payload title
        has_labels = np.array([bool(l) for l in cols["labels"]], bool)
        title = np.where(has_labels, title, fallback_title[:500])

    description = cols["description"]
    if fallback_desc:
        description = np.where(description != "", description, fallback_desc)

    fp_alertname = cols["alertname"]
    if fp_alertname_default:
        # grafana fingerprints default a MISSING alertname label to the
        # payload title (dict.get default semantics: present-empty stays "")
        fp_alertname = np.where(cols["has_alertname"], fp_alertname,
                                fp_alertname_default)
    fingerprint = _fingerprints(source.value, fp_alertname,
                                cols["namespace"], service)

    firing = (cols["status"] == "firing") \
        if source is not IncidentSource.GRAFANA else np.ones(n, bool)

    return ColumnarAlerts(
        source=source,
        valid=valid,
        firing=firing,
        fingerprint=fingerprint,
        title=title,
        description=description,
        severity_code=_severity_codes(cols["severity_raw"]),
        cluster=cols["cluster"],
        namespace=cols["namespace"],
        service=service,
        started_unix=started,
        labels=cols["labels"],
        annotations=cols["annotations"],
        malformed=malformed,
    )


def normalize_alertmanager_batch(alerts: list) -> ColumnarAlerts:
    """Columnar twin of AlertNormalizer.normalize_alertmanager over a
    whole webhook batch. Non-firing rows stay in the columns with
    ``firing=False`` (the handler's status filter, vectorized)."""
    n = len(alerts)
    return _derive(_transpose(alerts, n), IncidentSource.ALERTMANAGER, n)


def normalize_prometheus_batch(alerts: list) -> ColumnarAlerts:
    """Columnar twin of AlertNormalizer.normalize_prometheus (alertmanager
    shape, prometheus fingerprint source)."""
    n = len(alerts)
    return _derive(_transpose(alerts, n), IncidentSource.PROMETHEUS, n)


def normalize_grafana_batch(payload: dict) -> ColumnarAlerts:
    """Columnar twin of AlertNormalizer.normalize_grafana: multi-alert
    payloads with payload-level title/message fallbacks; no status
    filter (parity with the dict path, which ingests every row)."""
    alerts = payload.get("alerts", []) or []
    if not isinstance(alerts, list):
        alerts = []
    n = len(alerts)
    return _derive(
        _transpose(alerts, n), IncidentSource.GRAFANA, n,
        fallback_title=(payload.get("title") or "Grafana alert"),
        fallback_desc=(payload.get("message") or ""),
        fp_alertname_default=payload.get("title", ""))
