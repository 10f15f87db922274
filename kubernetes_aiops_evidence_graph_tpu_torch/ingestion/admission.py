"""graft-storm: overload-robust admission for the webhook→verdict path.

graft-intake proved the columnar ingest path is FAST (10k ev/s paced,
~38k unpaced); this module makes it survive being asked for 5× that.
Industrial RCA (Groot, PAPERS.md) lives or dies during alert storms and
grey failures: inflow spikes 10–100×, and the one unacceptable behavior
is dropping the critical signal while drowning in the noise. Three
pieces, all host-side (nothing here touches jitted code — COST_BASELINE
is untouched by construction):

1. **Per-tenant token-bucket admission** (:class:`AdmissionController`).
   Replaces the fixed-window ``RateLimiter`` on the columnar path — the
   fixed window admits 2× bursts across window boundaries and knows
   nothing about severity or tenancy. The gate charges tokens only for
   dedup SURVIVORS (duplicates ride free: the ring absorbs them before
   the gate, so a duplicate-heavy storm cannot shed the critical
   needle), sheds lowest-severity-first when the bucket runs dry, and
   NEVER sheds critical — a critical row admits even at zero tokens
   (bounded overdraft). Buckets are per tenant, so one misbehaving
   tenant's storm cannot starve its neighbors — the same isolation
   contract graft-surge gives the packed serving regions. Shed requests
   carry ``Retry-After`` derived from the bucket refill time.

2. **Storm mode** (:class:`StormMode`). A hysteresis-gated degraded tier:
   sustained pressure (admission shed ratio, dedup-ring eviction rate,
   or absorb busy-yield rate over their thresholds for a dwell) enters;
   sustained calm exits. While active: the gate pre-sheds ``info`` rows
   even with tokens remaining, app.ingest_batch samples persistence of
   presumed re-arrivals past an evicting ring, and the serving executor
   coalesces harder (rca/streaming.py reads the
   ``observability.scope.STORM_FLAG`` mirror — the ingest and serving
   layers share the flag without an import edge). Transitions are
   counted, note_event'd into the flight ring, and every tick dispatched
   during storm carries a ``storm`` flag in its TickSpan.

3. **Circuit breakers** (:class:`CircuitBreaker`). Bounded-failure-count
   → open → half-open probe around the two blocking downstreams: SQLite
   persist (app.py — open degrades ingest to the bounded spill journal)
   and device dispatch (rca/shield.py — open degrades tick()/absorb()
   to journal-only until the probe recovers). A wedged downstream costs
   one state check per webhook instead of a timeout per webhook.

Everything is deterministic given the injected clock — the chaos tests
drive all three pieces from fake clocks and seeded fault schedules.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from ..config import Settings, get_settings
from ..observability import get_logger
from ..observability import metrics as obs_metrics
from ..observability import scope as obs_scope

log = get_logger("admission")

# severity codes are indexes into columnar._SEVERITY_ORDER:
# 0=critical 1=high 2=medium 3=low 4=info. Shedding walks codes
# DESCENDING (info first), and code 0 is never shed.
_CRITICAL_CODE = 0

# prune admission buckets idle longer than this when the tenant table
# grows past _MAX_TENANTS — the RateLimiter._windows leak class, fixed
# structurally here rather than discovered in production
_BUCKET_IDLE_S = 300.0
_MAX_TENANTS = 4096


class CircuitBreaker:
    """Bounded-failure-count circuit breaker: ``closed`` → (N consecutive
    failures) → ``open`` → (cooldown) → ``half_open`` (exactly one probe)
    → ``closed`` on success / ``open`` on failure.

    ``allow()`` answers "may I attempt the protected operation now":
    closed always, open never until the cooldown elapses, half-open for
    exactly one in-flight probe. State changes are counted in
    ``aiops_breaker_transitions_total`` and mirrored to the
    ``aiops_breaker_state`` gauge.
    """

    _STATE_CODE = {"closed": 0.0, "half_open": 1.0, "open": 2.0}

    def __init__(self, name: str, failure_threshold: int = 5,
                 cooldown_s: float = 2.0, clock=time.monotonic) -> None:
        self.name = name
        self.failure_threshold = max(int(failure_threshold), 1)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self.state = "closed"
        self.failures = 0
        self.opened_at = 0.0
        self.opens = 0
        self._probe_inflight = False
        obs_metrics.BREAKER_STATE.set(0.0, breaker=name)

    def _set_state(self, state: str) -> None:
        """Caller holds the lock."""
        if state == self.state:
            return
        self.state = state
        obs_metrics.BREAKER_STATE.set(self._STATE_CODE[state],
                                      breaker=self.name)
        obs_metrics.BREAKER_TRANSITIONS.inc(breaker=self.name, state=state)
        log.warning("breaker_transition", breaker=self.name, state=state,
                    failures=self.failures)

    def allow(self) -> bool:
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if self._clock() - self.opened_at < self.cooldown_s:
                    return False
                self._set_state("half_open")
                self._probe_inflight = True
                return True
            # half_open: one probe at a time
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self.failures = 0
            self._probe_inflight = False
            if self.state != "closed":
                self._set_state("closed")

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            self._probe_inflight = False
            if self.state == "half_open" or (
                    self.state == "closed"
                    and self.failures >= self.failure_threshold):
                self.opened_at = self._clock()
                self.opens += 1
                self._set_state("open")

    def reset(self) -> None:
        self.record_success()

    def stats(self) -> dict:
        with self._lock:
            return {"name": self.name, "state": self.state,
                    "failures": self.failures, "opens": self.opens}


class StormMode:
    """Hysteresis-gated storm tier. ``update(hi, lo)`` feeds one pressure
    observation: ``hi`` is the ENTER predicate (pressure over the enter
    thresholds), ``lo`` the stay-degraded predicate (over the lower exit
    thresholds). Sustained ``hi`` for ``dwell_s`` enters; sustained
    ``not lo`` for ``dwell_s`` exits — the classic two-threshold + dwell
    gate, so a flapping signal cannot flap the tier.

    Transitions mirror into ``observability.scope.STORM_FLAG`` (the
    serving layer's read side), the ``aiops_storm_mode`` gauge, the
    transition counter, and a flight-recorder event — storm entry/exit
    is stamped into the same forensic stream as shield tier changes.
    """

    def __init__(self, settings: "Settings | None" = None,
                 clock=time.monotonic) -> None:
        s = settings or get_settings()
        self.dwell_s = float(getattr(s, "storm_dwell_s", 1.0))
        self._clock = clock
        self._lock = threading.Lock()
        self.active = False
        self.entries = 0
        self.exits = 0
        self._hi_since: float | None = None
        self._calm_since: float | None = None
        obs_scope.STORM_FLAG["active"] = False
        obs_metrics.STORM_MODE.set(0.0)

    def update(self, hi: bool, lo: bool | None = None) -> bool:
        """Feed one observation; returns the (possibly new) active state."""
        lo = hi if lo is None else lo
        now = self._clock()
        with self._lock:
            if not self.active:
                self._hi_since = (self._hi_since or now) if hi else None
                if hi and now - self._hi_since >= self.dwell_s:
                    self._flip(True, now)
            else:
                self._calm_since = ((self._calm_since or now)
                                    if not lo else None)
                if not lo and now - self._calm_since >= self.dwell_s:
                    self._flip(False, now)
            return self.active

    def force(self, active: bool) -> None:
        """Test/bench seam: set the tier directly (still counted)."""
        now = self._clock()
        with self._lock:
            if active != self.active:
                self._flip(active, now)

    def _flip(self, active: bool, now: float) -> None:
        """Caller holds the lock."""
        self.active = active
        self._hi_since = None
        self._calm_since = None
        if active:
            self.entries += 1
        else:
            self.exits += 1
        obs_scope.STORM_FLAG["active"] = active
        obs_metrics.STORM_MODE.set(1.0 if active else 0.0)
        obs_metrics.STORM_TRANSITIONS.inc(
            direction="enter" if active else "exit")
        obs_scope.FLIGHT_RECORDER.note_event(
            "storm_mode", active=active,
            entries=self.entries, exits=self.exits)
        log.warning("storm_mode_transition", active=active)


class _Bucket:
    __slots__ = ("tokens", "last")

    def __init__(self, tokens: float, last: float) -> None:
        self.tokens = tokens
        self.last = last


class AdmissionController:
    """Per-tenant token-bucket admission gate with severity-weighted
    shedding (see module docstring for the policy). One instance per
    app; ``admit_batch`` is the only hot call — a handful of NumPy ops
    per webhook batch plus a dict lookup per tenant."""

    def __init__(self, settings: "Settings | None" = None,
                 clock=time.monotonic, injector=None,
                 storm: "StormMode | None" = None) -> None:
        self.settings = settings or get_settings()
        self.rate = max(float(getattr(self.settings,
                                      "admission_rate_per_sec", 2000.0)),
                        1e-6)
        self.burst = max(float(getattr(self.settings,
                                       "admission_burst", 4000.0)), 1.0)
        self._clock = clock
        self.injector = injector
        self.storm = storm if storm is not None else StormMode(
            self.settings, clock=clock)
        self._lock = threading.Lock()
        self._buckets: dict[str, _Bucket] = {}
        self.admitted = 0
        self.shed = 0
        self.shed_by_severity: dict[int, int] = {}
        # storm pressure signals: EWMA shed ratio + metric-counter deltas
        self._shed_ewma = 0.0
        self._last_signal_t = self._clock()
        self._last_evictions = obs_metrics.INGEST_DEDUP_EVICTIONS.value()
        self._last_busy = obs_metrics.SERVE_ABSORB_BUSY.value()

    # -- bucket mechanics --------------------------------------------------

    def _bucket(self, tenant: str, now: float) -> _Bucket:
        """Caller holds the lock. Refills and returns the tenant bucket;
        prunes idle buckets when the table outgrows the cap (the
        fixed-window limiter's per-client leak, fixed structurally)."""
        b = self._buckets.get(tenant)
        if b is None:
            if len(self._buckets) >= _MAX_TENANTS:
                stale = [t for t, bb in self._buckets.items()
                         if now - bb.last > _BUCKET_IDLE_S]
                for t in stale:
                    del self._buckets[t]
            b = self._buckets[tenant] = _Bucket(self.burst, now)
        else:
            b.tokens = min(self.burst, b.tokens + (now - b.last) * self.rate)
            b.last = now
        return b

    def retry_after_s(self, tenant: str) -> float:
        """Seconds until the tenant's bucket refills to one token — the
        Retry-After a shed response carries."""
        now = self._clock()
        with self._lock:
            b = self._bucket(tenant, now)
            if b.tokens >= 1.0:
                return 0.0
            return (1.0 - b.tokens) / self.rate

    # -- the gate ----------------------------------------------------------

    def admit_batch(self, tenants: np.ndarray, severity_codes: np.ndarray,
                    chargeable: "np.ndarray | None" = None
                    ) -> tuple[np.ndarray, float]:
        """[B] admit mask for one webhook batch.

        ``tenants``/``severity_codes`` are the columnar namespace and
        int8 severity columns for the rows under consideration;
        ``chargeable`` masks the rows that actually consume drain
        capacity (dedup survivors — duplicate rows are always "admitted"
        here in the sense that the gate does not shed them; the ring
        already suppressed them). Within one tenant, chargeable rows are
        considered in ascending severity-code order (critical first), so
        when the bucket runs dry the shed set is exactly the
        lowest-severity tail — info sheds before low before medium
        before high, and critical NEVER sheds (it admits on overdraft,
        bounded at -burst). Returns ``(admit_mask, retry_after_s)`` with
        ``retry_after_s`` > 0 iff anything was shed."""
        if self.injector is not None:
            self.injector.at("admit")
        n = len(severity_codes)
        admit = np.ones(n, bool)
        if n == 0:
            self._signal(0, 0)
            return admit, 0.0
        sev = np.asarray(severity_codes)
        charge = (np.ones(n, bool) if chargeable is None
                  else np.asarray(chargeable, bool))
        storm_active = self.storm.active
        now = self._clock()
        retry_after = 0.0
        shed_rows = 0
        charged_rows = int(charge.sum())
        with self._lock:
            tcol = np.asarray(tenants, dtype=object)
            for tenant in np.unique(tcol[charge]) if charged_rows else ():
                rows = np.flatnonzero((tcol == tenant) & charge)
                b = self._bucket(str(tenant), now)
                tenant_shed = 0
                # ascending severity code = admit critical first; stable
                # sort keeps arrival order within one severity
                order = rows[np.argsort(sev[rows], kind="stable")]
                for r in order:
                    code = int(sev[r])
                    if code == _CRITICAL_CODE:
                        # NEVER shed: overdraft, bounded at -burst
                        b.tokens = max(b.tokens - 1.0, -self.burst)
                        continue
                    if b.tokens >= 1.0 and not (storm_active
                                                and code >= 4):
                        # storm tier pre-sheds info (code 4) outright:
                        # the degraded tier keeps headroom for the
                        # severities that page someone
                        b.tokens -= 1.0
                        continue
                    admit[r] = False
                    tenant_shed += 1
                    self.shed_by_severity[code] = \
                        self.shed_by_severity.get(code, 0) + 1
                    obs_metrics.ADMISSION_SHED.inc(
                        tenant=str(tenant), severity=str(code))
                if tenant_shed:
                    # Retry-After only means something when this batch
                    # actually shed: time for the dry bucket to refill
                    # to one token
                    shed_rows += tenant_shed
                    retry_after = max(
                        retry_after,
                        max(1.0 - b.tokens, 0.0) / self.rate)
                obs_metrics.ADMISSION_TOKENS.set(b.tokens,
                                                 tenant=str(tenant))
            self.shed += shed_rows
            self.admitted += n - shed_rows
        # admitted counters outside the lock (label fan-out is bounded)
        adm = admit & charge
        if adm.any():
            for tenant in np.unique(tcol[adm]):
                trows = (tcol == tenant) & adm
                for code in np.unique(sev[trows]):
                    obs_metrics.ADMISSION_ADMITTED.inc(
                        float(int((sev[trows] == code).sum())),
                        tenant=str(tenant), severity=str(int(code)))
        self._signal(shed_rows, charged_rows)
        return admit, retry_after

    # -- storm pressure ----------------------------------------------------

    def _signal(self, shed_rows: int, charged_rows: int) -> None:
        """Fold one batch's shed ratio plus the ring-eviction and
        absorb-busy counter rates into the storm hysteresis."""
        s = self.settings
        ratio = shed_rows / charged_rows if charged_rows else 0.0
        now = self._clock()
        with self._lock:
            self._shed_ewma = 0.8 * self._shed_ewma + 0.2 * ratio
            dt = max(now - self._last_signal_t, 1e-6)
            ev = obs_metrics.INGEST_DEDUP_EVICTIONS.value()
            busy = obs_metrics.SERVE_ABSORB_BUSY.value()
            ev_rate = (ev - self._last_evictions) / dt
            busy_rate = (busy - self._last_busy) / dt
            self._last_signal_t = now
            self._last_evictions = ev
            self._last_busy = busy
            ewma = self._shed_ewma
        enter = float(getattr(s, "storm_enter_shed_ratio", 0.25))
        exit_ = float(getattr(s, "storm_exit_shed_ratio", 0.02))
        ev_thr = float(getattr(s, "storm_eviction_rate_per_s", 500.0))
        busy_thr = float(getattr(s, "storm_busy_rate_per_s", 50.0))
        hi = (ewma > enter or ev_rate > ev_thr or busy_rate > busy_thr)
        lo = (ewma > exit_ or ev_rate > ev_thr / 2.0
              or busy_rate > busy_thr / 2.0)
        self.storm.update(hi, lo)

    def stats(self) -> dict:
        with self._lock:
            return {
                "admitted": self.admitted,
                "shed": self.shed,
                "shed_by_severity": dict(self.shed_by_severity),
                # contract surface: stays 0 forever by construction (the
                # gate admits code 0 on overdraft) — asserted by the
                # webhook_storm bench and the graft-storm CI job
                "critical_shed": self.shed_by_severity.get(
                    _CRITICAL_CODE, 0),
                "shed_ewma": round(self._shed_ewma, 4),
                "storm_active": self.storm.active,
                "storm_entries": self.storm.entries,
                "storm_exits": self.storm.exits,
                "tenants": len(self._buckets),
            }
