from .admission import AdmissionController, CircuitBreaker, StormMode
from .columnar import (
    ColumnarAlerts,
    normalize_alertmanager_batch,
    normalize_grafana_batch,
    normalize_prometheus_batch,
)
from .dedup import AlertDeduplicator, FingerprintRing, RateLimiter, TTLSet
from .normalizer import AlertNormalizer

__all__ = [
    "AlertNormalizer", "AlertDeduplicator", "RateLimiter", "TTLSet",
    "FingerprintRing", "ColumnarAlerts", "normalize_alertmanager_batch",
    "normalize_grafana_batch", "normalize_prometheus_batch",
    "AdmissionController", "CircuitBreaker", "StormMode",
]
