"""Fingerprint dedup + rate limiting (no Redis: in-process TTL store).

Parity with the reference AlertDeduplicator/RateLimiter
(deduplicator.py:16-177) with its two defects fixed (SURVEY.md §3.6):

* fingerprints are ACTUALLY REGISTERED on incident creation (the reference
  defined register_fingerprint but never called it — defect 4), with the
  same 4h TTL (deduplicator.py:20);
* duplicate checks fail open like the reference (:69-72), and the Postgres
  UNIQUE-constraint backstop survives as the storage layer's open-
  fingerprint index.

The rate limiter keeps the reference's fixed-window INCR+EXPIRE semantics
(:147-177) at 100 req/min (settings.py:119).
"""
from __future__ import annotations

import threading
import time

import numpy as np

from ..config import Settings, get_settings
from ..observability import metrics as obs_metrics


class TTLSet:
    """Monotonic-clock TTL set with lazy expiry."""

    def __init__(self, clock=time.monotonic) -> None:
        self._clock = clock
        self._expiry: dict[str, float] = {}
        self._lock = threading.Lock()

    def add(self, key: str, ttl_s: float) -> None:
        with self._lock:
            self._expiry[key] = self._clock() + ttl_s

    def __contains__(self, key: str) -> bool:
        with self._lock:
            exp = self._expiry.get(key)
            if exp is None:
                return False
            if exp < self._clock():
                del self._expiry[key]
                return False
            return True

    def discard(self, key: str) -> None:
        with self._lock:
            self._expiry.pop(key, None)

    def purge(self) -> int:
        now = self._clock()
        with self._lock:
            dead = [k for k, exp in self._expiry.items() if exp < now]
            for k in dead:
                del self._expiry[k]
            return len(dead)


class FingerprintRing:
    """graft-intake: bounded hashed fingerprint window for dedup.

    Open-addressed ``(hash, expiry)`` slot arrays (capacity rounded up to
    a power of two) replacing the unbounded dict TTL store on the
    columnar path: every op is O(probes), batch membership checks are
    VECTORIZED (one array compare per probe round over the whole batch —
    the storm-shaped operation), and memory is fixed. A full probe
    neighborhood evicts its oldest-expiry entry, counted in
    ``aiops_ingest_dedup_evictions_total``; live-slot occupancy feeds the
    ``aiops_ingest_dedup_window_occupancy`` gauge. Fingerprints are
    identified by their leading 64 hash bits — a collision reads as a
    duplicate (an alert suppressed for one TTL), the same fail-closed
    trade the reference's fingerprint truncation already makes.
    """

    _TOMBSTONE = np.uint64(0)     # empty-or-released slot

    def __init__(self, capacity: int = 32768, probes: int = 8,
                 clock=time.monotonic) -> None:
        cap = 1
        while cap < max(int(capacity), probes * 2):
            cap *= 2
        self._mask = np.uint64(cap - 1)
        self.capacity = cap
        self.probes = int(probes)
        self._clock = clock
        self._hash = np.zeros(cap, np.uint64)
        self._expiry = np.zeros(cap, np.float64)
        self.evictions = 0
        self._lock = threading.Lock()

    @staticmethod
    def _h(fingerprint: str) -> np.uint64:
        # leading 64 bits of the (already sha256-derived) hex fingerprint;
        # 0 is reserved as the empty marker, so only the single value 0
        # remaps (an |1-style trick would collapse even/odd hash pairs)
        v = int(str(fingerprint)[:16], 16)
        return np.uint64(v if v else 0x9E3779B97F4A7C15)

    def _hash_batch(self, fingerprints) -> np.ndarray:
        """Per-unique hashing: a storm batch repeats few fingerprints."""
        fps = np.asarray(fingerprints, dtype=object)
        uniq, inv = np.unique(fps, return_inverse=True)
        hu = np.fromiter((self._h(u) for u in uniq), np.uint64,
                         count=len(uniq))
        return hu[inv]

    # -- single-key API (AlertDeduplicator back-compat surface) -----------

    def __contains__(self, fingerprint: str) -> bool:
        return bool(self.contains_batch([fingerprint])[0])

    def add(self, fingerprint: str, ttl_s: float) -> None:
        now = self._clock()
        with self._lock:
            self._add_one(self._h(fingerprint), now + ttl_s, now)
            obs_metrics.INGEST_DEDUP_OCCUPANCY.set(
                float(((self._hash != self._TOMBSTONE)
                       & (self._expiry >= now)).sum()))

    def discard(self, fingerprint: str) -> None:
        h = self._h(fingerprint)
        base, mask = int(h), int(self._mask)
        with self._lock:
            for p in range(self.probes):
                slot = (base + p) & mask
                if self._hash[slot] == h:
                    self._hash[slot] = self._TOMBSTONE
                    self._expiry[slot] = 0.0
                    return

    # -- batch API (the columnar ingest edge) ------------------------------

    def contains_batch(self, fingerprints) -> np.ndarray:
        """[B] bool duplicate mask: one vectorized slot compare per probe
        round over the whole batch."""
        if len(fingerprints) == 0:
            return np.zeros(0, bool)
        h = self._hash_batch(fingerprints)
        now = self._clock()
        hit = np.zeros(len(h), bool)
        with self._lock:
            for p in range(self.probes):
                slots = ((h + np.uint64(p)) & self._mask).astype(np.int64)
                hit |= (self._hash[slots] == h) & (self._expiry[slots] >= now)
        return hit

    def add_batch(self, fingerprints, ttl_s: float) -> None:
        if len(fingerprints) == 0:
            return
        h = self._hash_batch(fingerprints)
        now = self._clock()
        exp = now + ttl_s
        with self._lock:
            for hv in h:
                self._add_one(hv, exp, now)
            obs_metrics.INGEST_DEDUP_OCCUPANCY.set(
                float(((self._hash != self._TOMBSTONE)
                       & (self._expiry >= now)).sum()))

    def _add_one(self, h: np.uint64, exp: float, now: float) -> None:
        """Place one hash: refresh an existing live slot, else the first
        free/expired slot in the probe neighborhood, else evict the
        neighborhood's oldest-expiry entry (counted). Caller holds the
        lock."""
        free = -1
        oldest_slot, oldest_exp = -1, np.inf
        base, mask = int(h), int(self._mask)
        for p in range(self.probes):
            slot = (base + p) & mask
            if self._hash[slot] == h:
                self._expiry[slot] = exp
                return
            e = self._expiry[slot]
            if free < 0 and (self._hash[slot] == self._TOMBSTONE
                             or e < now):
                free = slot
            if e < oldest_exp:
                oldest_slot, oldest_exp = slot, e
        if free < 0:
            free = oldest_slot
            self.evictions += 1
            obs_metrics.INGEST_DEDUP_EVICTIONS.inc()
        self._hash[free] = h
        self._expiry[free] = exp

    def occupancy(self) -> int:
        now = self._clock()
        with self._lock:
            return int(((self._hash != self._TOMBSTONE)
                        & (self._expiry >= now)).sum())


class AlertDeduplicator:
    """Dedup facade over the TTL window. With ``settings.ingest_columnar``
    the window is the hashed :class:`FingerprintRing` (bounded, batch
    probes for the columnar ingest edge); without it, the original dict
    :class:`TTLSet` — the behavioral oracle the contract tests compare
    against."""

    def __init__(self, settings: Settings | None = None, clock=time.monotonic) -> None:
        self.settings = settings or get_settings()
        self._seen: "TTLSet | FingerprintRing"
        if getattr(self.settings, "ingest_columnar", False):
            self._seen = FingerprintRing(
                capacity=getattr(self.settings, "ingest_dedup_window", 32768),
                clock=clock)
        else:
            self._seen = TTLSet(clock)

    def check_duplicate(self, fingerprint: str) -> bool:
        try:
            return fingerprint in self._seen
        except Exception:  # graft-audit: allow[broad-except] fail open (deduplicator.py:69-72): dedup errors must not drop alerts
            return False

    def register_fingerprint(self, fingerprint: str) -> None:
        self._seen.add(fingerprint, self.settings.dedup_ttl_seconds)

    def release(self, fingerprint: str) -> None:
        """Allow re-alerting once an incident resolves."""
        self._seen.discard(fingerprint)

    # -- batch surface (columnar ingest edge; graft-intake) ---------------

    def check_batch(self, fingerprints) -> np.ndarray:
        """[B] bool duplicate mask. Vectorized on the ring; the TTLSet
        oracle answers per key (fail-open per row, like check_duplicate)."""
        ring = self._seen
        if isinstance(ring, FingerprintRing):
            try:
                return ring.contains_batch(fingerprints)
            except Exception:  # graft-audit: allow[broad-except] fail open: dedup errors must not drop alerts
                return np.zeros(len(fingerprints), bool)
        return np.array([self.check_duplicate(f) for f in fingerprints],
                        bool)

    def register_batch(self, fingerprints) -> None:
        ttl = self.settings.dedup_ttl_seconds
        ring = self._seen
        if isinstance(ring, FingerprintRing):
            ring.add_batch(fingerprints, ttl)
            return
        for f in fingerprints:
            ring.add(f, ttl)


class RateLimiter:
    """Fixed one-minute windows per client key (deduplicator.py:147-177).

    graft-storm fixed its unbounded-memory defect: ``_windows`` grew one
    entry per distinct client key FOREVER (a storm from many source IPs
    = a memory leak). Entries from previous windows are now pruned when
    the limiter first observes a new window — the sweep runs at most
    once per window roll, so the steady-state cost is unchanged. The
    columnar webhook path replaces this limiter entirely with the
    severity-aware per-tenant token-bucket gate
    (ingestion/admission.AdmissionController); this stays as the
    dict-path oracle's request gate, now with a ``retry_after_s`` so
    429 responses can carry Retry-After.
    """

    def __init__(self, settings: Settings | None = None, clock=time.monotonic) -> None:
        self.settings = settings or get_settings()
        self._clock = clock
        self._windows: dict[str, tuple[int, int]] = {}  # key -> (window, count)
        self._cur_window = -1
        self._lock = threading.Lock()

    def check_rate_limit(self, client: str) -> bool:
        """True when the request is allowed."""
        window = int(self._clock() // 60)
        limit = self.settings.webhook_rate_limit_per_minute
        with self._lock:
            if window != self._cur_window:
                # window rolled: every entry stamped with an older window
                # is dead weight — prune them all in one sweep
                self._windows = {k: v for k, v in self._windows.items()
                                 if v[0] == window}
                self._cur_window = window
            w, count = self._windows.get(client, (window, 0))
            if w != window:
                w, count = window, 0
            count += 1
            self._windows[client] = (w, count)
            return count <= limit

    def retry_after_s(self) -> float:
        """Seconds until the current fixed window rolls — the
        Retry-After a 429 from this limiter carries."""
        now = self._clock()
        return max(60.0 - (now % 60.0), 0.0)

    def tracked_clients(self) -> int:
        with self._lock:
            return len(self._windows)
