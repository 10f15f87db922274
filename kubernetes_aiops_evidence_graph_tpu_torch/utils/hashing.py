"""Stable hashing / fingerprinting.

The alert fingerprint matches the reference's dedup key semantics
(src/services/ingestion/normalizer.py:208-218): sha256 over
``source:alertname:namespace:service`` truncated to 32 hex chars, so
incidents fingerprinted by either system deduplicate identically.
"""
from __future__ import annotations

import hashlib


def alert_fingerprint(source: str, alertname: str, namespace: str, service: str | None) -> str:
    key = f"{source}:{alertname}:{namespace}:{service or ''}"
    return hashlib.sha256(key.encode()).hexdigest()[:32]


def stable_hash(*parts: object, bits: int = 64) -> int:
    """Deterministic non-cryptographic id for graph entities (run-to-run stable,
    unlike Python's salted ``hash``)."""
    key = "\x1f".join(str(p) for p in parts)
    digest = hashlib.blake2b(key.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big") >> (64 - bits)
