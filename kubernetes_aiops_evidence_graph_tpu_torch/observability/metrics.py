"""In-process metrics registry with Prometheus text exposition.

Implements the FULL metric set the reference promised but only partially
emitted (SURVEY.md §3.6 item 7): the 5 real ones (main.py:30-48,
base.py:19-23) plus the 4 referenced-but-never-defined ones, without a
prometheus_client dependency.
"""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import Iterable

_DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class _Metric:
    def __init__(self, name: str, help_: str, kind: str):
        self.name = name
        self.help = help_
        self.kind = kind
        self._lock = threading.Lock()


class Counter(_Metric):
    def __init__(self, name: str, help_: str = ""):
        super().__init__(name, help_, "counter")
        self._values: dict[tuple, float] = defaultdict(float)

    def inc(self, value: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] += value

    def value(self, **labels) -> float:
        return self._values.get(tuple(sorted(labels.items())), 0.0)

    def expose(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} counter"
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            yield f"{self.name}{_fmt_labels(key)} {v}"


class Gauge(Counter):
    def __init__(self, name: str, help_: str = ""):
        _Metric.__init__(self, name, help_, "gauge")
        self._values = defaultdict(float)

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[tuple(sorted(labels.items()))] = value

    def expose(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} gauge"
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            yield f"{self.name}{_fmt_labels(key)} {v}"


class Histogram(_Metric):
    def __init__(self, name: str, help_: str = "", buckets=_DEFAULT_BUCKETS):
        super().__init__(name, help_, "histogram")
        self.buckets = tuple(buckets)
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = defaultdict(float)
        self._totals: dict[tuple, int] = defaultdict(int)

    def observe(self, value: float, **labels) -> None:
        self.observe_key(value, tuple(sorted(labels.items())))

    def observe_key(self, value: float, key: tuple) -> None:
        """Fast path for hot callers (graft-scope per-tick stages) that
        pre-build the sorted label-tuple once instead of per observation.
        ``key`` must be ``tuple(sorted(labels.items()))``."""
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._sums[key] += value
            self._totals[key] += 1

    def time(self, **labels):
        import time as _t

        class _Timer:
            def __enter__(timer):
                timer.t0 = _t.perf_counter()
                return timer

            def __exit__(timer, *exc):
                self.observe(_t.perf_counter() - timer.t0, **labels)
                return False

        return _Timer()

    def percentile(self, q: float, **labels) -> float:
        """Approximate percentile from bucket counts with linear
        interpolation WITHIN the landing bucket (Prometheus
        histogram_quantile semantics): the old upper-bound answer
        overstated every quantile by up to a full bucket width, which at
        the SLO bucket ladder turned a 30 ms p50 into 50 ms. Quantiles
        beyond the last finite bucket clamp to its bound (there is no
        width to interpolate into +Inf)."""
        key = tuple(sorted(labels.items()))
        total = self._totals.get(key, 0)
        if not total:
            return 0.0
        target = q * total
        counts = self._counts.get(key, [])
        prev_cum = 0
        for i, c in enumerate(counts):
            if c >= target:
                lo = self.buckets[i - 1] if i else 0.0
                in_bucket = c - prev_cum
                if in_bucket <= 0:
                    return lo
                frac = (target - prev_cum) / in_bucket
                return lo + frac * (self.buckets[i] - lo)
            prev_cum = c
        return self.buckets[-1] if self.buckets else 0.0

    def expose(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} histogram"
        with self._lock:
            snapshot = [
                (key, list(self._counts.get(key, [0] * len(self.buckets))),
                 self._sums[key], self._totals[key])
                for key in sorted(self._totals)
            ]
        for key, counts, total_sum, total in snapshot:
            for b, c in zip(self.buckets, counts):
                yield f'{self.name}_bucket{_fmt_labels(key, le=b)} {c}'
            yield f'{self.name}_bucket{_fmt_labels(key, le="+Inf")} {total}'
            yield f"{self.name}_sum{_fmt_labels(key)} {total_sum}"
            yield f"{self.name}_count{_fmt_labels(key)} {total}"


def _fmt_labels(key: tuple, le=None) -> str:
    parts = [f'{k}="{v}"' for k, v in key]
    if le is not None:
        parts.append(f'le="{le}"')
    return "{" + ",".join(parts) + "}" if parts else ""


class Registry:
    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            return self._metrics.setdefault(metric.name, metric)

    def counter(self, name: str, help_: str = "") -> Counter:
        return self.register(Counter(name, help_))  # type: ignore[return-value]

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self.register(Gauge(name, help_))  # type: ignore[return-value]

    def histogram(self, name: str, help_: str = "", buckets=_DEFAULT_BUCKETS) -> Histogram:
        return self.register(Histogram(name, help_, buckets))  # type: ignore[return-value]

    def expose(self) -> str:
        lines: list[str] = []
        for m in self._metrics.values():
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"


REGISTRY = Registry()

# The reference's metric surface, complete (main.py:30-48 + promised set):
ALERTS_RECEIVED = REGISTRY.counter(
    "aiops_alerts_received_total", "Alerts received by webhook")
ALERTS_DEDUPLICATED = REGISTRY.counter(
    "aiops_alerts_deduplicated_total", "Alerts dropped as duplicates")
INCIDENTS_CREATED = REGISTRY.counter(
    "aiops_incidents_created_total", "Incidents created")
INCIDENTS_RESOLVED = REGISTRY.counter(
    "aiops_incidents_resolved_total", "Incidents resolved or closed")
REMEDIATION_ATTEMPTS = REGISTRY.counter(
    "aiops_remediation_attempts_total", "Remediation executions attempted")
HYPOTHESES_GENERATED = REGISTRY.counter(
    "aiops_hypotheses_generated_total", "Hypotheses generated")
EVIDENCE_COLLECTED = REGISTRY.counter(
    "aiops_evidence_collected_total", "Evidence items collected")
WEBHOOK_LATENCY = REGISTRY.histogram(
    "aiops_webhook_latency_seconds", "Webhook handling latency")
COLLECTOR_DURATION = REGISTRY.histogram(
    "aiops_collector_duration_seconds", "Per-collector collection duration")
RCA_DURATION = REGISTRY.histogram(
    "aiops_rca_duration_seconds", "RCA scoring duration (new)")
WORKFLOW_STEP_DURATION = REGISTRY.histogram(
    "aiops_workflow_step_duration_seconds", "Workflow step duration (new)")
WORKFLOW_STEPS = REGISTRY.counter(
    "aiops_workflow_steps_total",
    "Workflow step outcomes by status (completed|failed) — feeds the "
    "WorkflowFailures alert rule")

# graft-saga instrumentation (workflow/engine.py, workflow/worker.py,
# remediation/executor.py + compensator.py): the durable exactly-once
# remediation lifecycle. Every intent/result/reconciliation, lease
# fencing event, resume, orphaned step thread, and compensation outcome
# is counted — the action trail behind a verdict must be as auditable
# as the verdict itself.
WORKFLOW_STEP_ORPHANS = REGISTRY.counter(
    "aiops_workflow_step_orphans_total",
    "Sync workflow steps whose executor THREAD outlived the step "
    "timeout (asyncio.wait_for cannot cancel a thread — the step keeps "
    "running detached while the engine retries/fails), by step")
WORKFLOW_STALLED = REGISTRY.gauge(
    "aiops_workflow_stalled",
    "Workflows currently stalled: open incidents whose journal carries "
    "a failed step or whose resume budget is exhausted — visible to the "
    "resumer sweep and GET /api/v1/workflows")
WORKFLOW_RESUMES = REGISTRY.counter(
    "aiops_workflow_resumes_total",
    "Orphaned workflows (expired lease, no failed steps) re-entered "
    "through the journal-replay path by the resumer sweep")
WORKFLOW_LEASE_FENCED = REGISTRY.counter(
    "aiops_workflow_lease_fenced_total",
    "Workflow runs aborted at a step boundary because their lease was "
    "lost (expired and reclaimed by another worker) — the fencing that "
    "keeps two workers from double-driving one workflow")
ACTION_INTENTS = REGISTRY.counter(
    "aiops_action_intents_total",
    "Two-phase execution intent rows journaled BEFORE a cluster "
    "mutation dispatch, by action_type")
ACTION_DUP_PREVENTED = REGISTRY.counter(
    "aiops_action_duplicates_prevented_total",
    "Action executions answered from the durable ledger's recorded "
    "result instead of re-firing the cluster mutation (journal-replay "
    "after a crash between the mutation and the step commit)")
ACTION_RECONCILED = REGISTRY.counter(
    "aiops_action_reconciliations_total",
    "In-doubt executions (intent without result after a crash) settled "
    "by probing cluster state, by outcome (completed = the mutation had "
    "landed; refired = the probe proved it had not)")
COMPENSATION_ACTIONS = REGISTRY.counter(
    "aiops_compensation_actions_total",
    "Saga compensation executions after a failed verification, by "
    "action_type and outcome (completed | failed | denied | noop)")
COMPENSATION_ESCALATIONS = REGISTRY.counter(
    "aiops_compensation_escalations_total",
    "Compensations that exhausted their bounded attempts (or were "
    "policy-denied) and escalated to a human via an "
    "escalate_to_human action row")

# graft-intake instrumentation (ingestion/columnar.py + the columnar
# staging path in rca/streaming.py): the webhook→staged-delta segment,
# previously the one part of the serving path with no metric surface.
INGEST_ROWS = REGISTRY.counter(
    "aiops_ingest_rows_total",
    "Webhook alert rows through the columnar ingest edge, by source and "
    "outcome (created | duplicate | not_firing | malformed)")
INGEST_ROWS_PER_SEC = REGISTRY.gauge(
    "aiops_ingest_rows_per_sec",
    "Rows/s through the most recent columnar webhook batch "
    "(batch rows / parse+normalize+dedup wall), by source")
INGEST_BATCH_FILL = REGISTRY.gauge(
    "aiops_ingest_batch_fill",
    "Fill fraction of the most recent staged buffer, by site: webhook = "
    "eligible rows / batch rows; delta = staged delta entries / the "
    "_DELTA_BUCKETS rung the packed slab was sized on")
INGEST_MALFORMED_ROWS = REGISTRY.counter(
    "aiops_ingest_malformed_rows_total",
    "Webhook rows masked as malformed (non-dict alert, non-dict labels, "
    "unparseable timestamp) — masked and counted, never a 500, by source")
INGEST_STAGE_SECONDS = REGISTRY.histogram(
    "aiops_ingest_stage_seconds",
    "Columnar ingest stage durations per webhook batch "
    "(parse | normalize | dedup | persist), by stage/source",
    buckets=_DEFAULT_BUCKETS)
INGEST_DEDUP_HITS = REGISTRY.counter(
    "aiops_ingest_dedup_hits_total",
    "Batch dedup probe hits (rows suppressed as duplicates by the "
    "fingerprint window) — with aiops_ingest_rows_total this is the "
    "dedup hit ratio, by source")
INGEST_DEDUP_EVICTIONS = REGISTRY.counter(
    "aiops_ingest_dedup_evictions_total",
    "Live fingerprints evicted from a full hashed-ring probe "
    "neighborhood before their TTL (window pressure)")
INGEST_DEDUP_OCCUPANCY = REGISTRY.gauge(
    "aiops_ingest_dedup_window_occupancy",
    "Live (unexpired) fingerprint slots resident in the hashed dedup "
    "ring")

# graft-storm instrumentation (ingestion/admission.py + the overload
# paths in app.py / rca/streaming.py / rca/shield.py): the admission
# gate, storm-mode tier, circuit breakers, and the absorb busy/backlog
# escalation — the overload story must be exactly accountable (the
# webhook_storm bench asserts admitted + shed + sampled sums match).
ADMISSION_ADMITTED = REGISTRY.counter(
    "aiops_admission_admitted_total",
    "Webhook rows admitted by the per-tenant token-bucket gate, by "
    "tenant and severity")
ADMISSION_SHED = REGISTRY.counter(
    "aiops_admission_shed_total",
    "Webhook rows shed by the admission gate (token bucket exhausted — "
    "lowest severity first, critical NEVER), by tenant and severity")
ADMISSION_TOKENS = REGISTRY.gauge(
    "aiops_admission_tokens",
    "Admission token-bucket level after the most recent batch, by "
    "tenant (negative = critical-only overdraft, bounded at -burst)")
STORM_MODE = REGISTRY.gauge(
    "aiops_storm_mode",
    "1 while the ingest path is in the hysteresis-gated storm tier "
    "(degraded: pre-shed info, sampled persistence, harder coalescing)")
STORM_TRANSITIONS = REGISTRY.counter(
    "aiops_storm_transitions_total",
    "Storm-mode tier transitions, by direction (enter | exit)")
STORM_SAMPLED_ROWS = REGISTRY.counter(
    "aiops_storm_sampled_rows_total",
    "Non-critical fresh rows suppressed by storm-mode sampled "
    "persistence (registered back into the dedup ring as presumed "
    "re-arrivals past an evicting window), by tenant")
BREAKER_STATE = REGISTRY.gauge(
    "aiops_breaker_state",
    "Circuit-breaker state by breaker name: 0 closed, 1 half_open, "
    "2 open")
BREAKER_TRANSITIONS = REGISTRY.counter(
    "aiops_breaker_transitions_total",
    "Circuit-breaker state transitions, by breaker name and new state")
PERSIST_SPILLED = REGISTRY.counter(
    "aiops_persist_spilled_total",
    "Incidents diverted to the bounded spill journal while the SQLite "
    "persist breaker was open (replayed on breaker close)")
PERSIST_SPILL_REPLAYED = REGISTRY.counter(
    "aiops_persist_spill_replayed_total",
    "Spilled incidents persisted by the post-recovery replay")
PERSIST_SPILL_DROPPED = REGISTRY.counter(
    "aiops_persist_spill_dropped_total",
    "Spilled incidents dropped because the bounded spill journal "
    "overflowed (oldest-first) — the accountable data-loss path of a "
    "wedged DB outlasting the spill capacity")
SERVE_ABSORB_BUSY = REGISTRY.counter(
    "aiops_serve_absorb_busy_total",
    "Non-blocking absorb() calls that yielded busy because a caller-"
    "boundary tick or fetch held the serving state (their deltas stay "
    "in the store journal for the contending boundary's sync)")
SERVE_ABSORB_SYNC_DRAINS = REGISTRY.counter(
    "aiops_serve_absorb_sync_drains_total",
    "absorb() busy yields that escalated to a synchronous journal drain "
    "because the unsynced store-journal backlog crossed "
    "ingest_max_journal_backlog")

# Serving-pipeline instrumentation (graft-pipeline, rca/streaming.py):
# the double-buffered executor that overlaps host delta staging with
# device ticks and defers device_get to the caller boundary.
SERVE_PIPELINE_INFLIGHT = REGISTRY.gauge(
    "aiops_serve_pipeline_inflight",
    "Dispatched-but-unfetched ticks in the serving pipeline, by pack "
    "label (graft-swell: one series per serving mesh)")
SERVE_PIPELINE_STALL_SECONDS = REGISTRY.counter(
    "aiops_serve_pipeline_stall_seconds_total",
    "Time blocked waiting for a pipeline slot after the coalescing bound "
    "(top of the delta ladder) was reached, by pack label")
SERVE_COALESCED_TICKS = REGISTRY.counter(
    "aiops_serve_coalesced_ticks_total",
    "Tick submissions whose deltas merged into a later, larger tick "
    "because the pipeline was full (backpressure without blocking)")
SERVE_COALESCED_TICK_SIZE = REGISTRY.gauge(
    "aiops_serve_coalesced_tick_size",
    "Pending delta entries carried by the most recent coalesced tick")
SERVE_DEFERRED_FETCHES = REGISTRY.counter(
    "aiops_serve_deferred_fetches_total",
    "Tick results superseded and dropped without a device->host fetch "
    "(the readback the deferred-fetch boundary avoided)")
SERVE_FETCHED_BYTES = REGISTRY.counter(
    "aiops_serve_fetched_bytes_total",
    "Bytes actually moved device->host by serving fetches, by path label")

# graft-surge instrumentation (rca/surge.py + the async workflow drive):
# cross-tenant verdict batching on one resident state. The histogram is
# the batching story in one surface — incidents scored per device pass,
# labeled by how many tenants were packed onto the state; the gauge makes
# per-tenant backpressure visible (staged-but-unticked delta entries).
SERVE_BATCH_INCIDENTS = REGISTRY.histogram(
    "aiops_serve_batch_incidents",
    "Live incidents scored by one device pass of the resident serving "
    "state, by tenants label (cross-tenant packing: N tenants' concurrent "
    "incidents ride ONE jitted pass instead of one pass per incident)",
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0,
             1024.0))
SERVE_TENANT_QUEUE_DEPTH = REGISTRY.gauge(
    "aiops_serve_tenant_queue_depth",
    "Pending (staged, not yet ticked) delta entries per tenant region of "
    "the multi-tenant resident scorer, by tenant label")
SERVE_TENANT_QUARANTINES = REGISTRY.counter(
    "aiops_serve_tenant_quarantines_total",
    "Tenant regions quarantined off the shared tick (poisoned deltas or "
    "journal truncation), by tenant label — the other tenants' ticks "
    "continue while the quarantined region re-mirrors from its store")
SERVE_TENANT_REBUILDS = REGISTRY.counter(
    "aiops_serve_tenant_rebuilds_total",
    "Region-scoped tenant re-mirrors (store-derived heal staged as "
    "in-place deltas) — the per-tenant rebuild that never stalls the "
    "other tenants' ticks, by tenant label")

# graft-shield instrumentation (rca/shield.py + rca/journal.py): the
# crash-consistent recovery layer over the donated serving state. Every
# degradation-tier transition and recovery action is counted — a recovery
# path that cannot be observed cannot be trusted (auditable-RCA bar).
SHIELD_SNAPSHOTS = REGISTRY.counter(
    "aiops_shield_snapshots_total",
    "Resident-state snapshots written (atomic temp+fsync+rename)")
SHIELD_JOURNAL_BYTES = REGISTRY.counter(
    "aiops_shield_journal_bytes_total",
    "Bytes appended (fsync'd) to the write-ahead delta journal")
SHIELD_REPLAYED_DELTAS = REGISTRY.counter(
    "aiops_shield_replayed_deltas_total",
    "Store-journal records re-applied from the WAL during recovery")
SHIELD_QUARANTINED_DELTAS = REGISTRY.counter(
    "aiops_shield_quarantined_deltas_total",
    "Delta batches quarantined after producing non-finite verdicts "
    "(journaled as quarantined, re-ticked from replayed clean state)")
SHIELD_WATCHDOG_TRIPS = REGISTRY.counter(
    "aiops_shield_watchdog_trips_total",
    "Ticks that exceeded the per-tick watchdog timeout")
SHIELD_TIER_TRANSITIONS = REGISTRY.counter(
    "aiops_shield_tier_transitions_total",
    "Degradation-ladder transitions by tier label (retry, "
    "kernel_fallback, sync_depth1, journal_replay, full_rebuild, "
    "rules_fallback, ladder_rebuild)")
SHIELD_RECOVERIES = REGISTRY.counter(
    "aiops_shield_recoveries_total",
    "Recoveries completed, by mode label (journal_replay | full_rebuild)")
SHIELD_NONFINITE_VERDICTS = REGISTRY.counter(
    "aiops_shield_nonfinite_verdicts_total",
    "Verdict fetches rejected by the finite guard (NaN/inf would have "
    "been served), by path label")

# graft-heal instrumentation (rca/heal.py + the shield's mesh_heal rung):
# per-shard health, live resharding and re-expansion of the serving mesh.
MESH_SHARD_HEALTH = REGISTRY.gauge(
    "aiops_mesh_shard_health",
    "Per-shard health verdict (1 healthy, 0 classified failed / "
    "excluded), by shard label (mesh position while live, global device "
    "index once excluded)")
MESH_SHARD_FAILURES = REGISTRY.counter(
    "aiops_mesh_shard_failures_total",
    "Shard-localized faults fed into the per-position classifier, by "
    "shard label")
MESH_HEALS = REGISTRY.counter(
    "aiops_mesh_heals_total",
    "Live D→D' reshards onto a survivor mesh (the mesh_heal ladder rung)")
MESH_REEXPANSIONS = REGISTRY.counter(
    "aiops_mesh_reexpansions_total",
    "D'→D re-expansions after a successful half-open device probe")
MESH_SERVING_SHARDS = REGISTRY.gauge(
    "aiops_mesh_serving_shards",
    "Graph shards the resident serving state currently spans (1 = "
    "single-device fallback)")
MESH_ATTEST_MISMATCH = REGISTRY.counter(
    "aiops_mesh_attest_mismatch_total",
    "Per-shard attestation checksum mismatches (silent corruption "
    "localized to its shard), by shard label")
MESH_ATTEST_REPAIRS = REGISTRY.counter(
    "aiops_mesh_attest_repairs_total",
    "Attestation repair passes that re-uploaded mismatched shard blocks "
    "from the host-truth mirrors (no whole-state rebuild)")

# graft-swell instrumentation (rca/elastic.py + multi-pack SurgeServer):
# load-driven elastic meshes — scale events through the heal seams,
# fleet bin-packing and live tenant migration.
MESH_SCALE_EVENTS = REGISTRY.counter(
    "aiops_mesh_scale_events_total",
    "Load-driven D→D' reshards executed through the WAL-journaled "
    "adopt_mesh seam, by direction label (up | down)")
ELASTIC_SCALE_DECISIONS = REGISTRY.counter(
    "aiops_elastic_scale_decisions_total",
    "ElasticController hysteresis-gate firings that executed a scale "
    "event (after dwell + cooldown), by direction label")
FLEET_PACKS = REGISTRY.gauge(
    "aiops_fleet_packs",
    "Serving packs (MultiTenantScorer meshes) the fleet currently runs")
FLEET_TENANT_MIGRATIONS = REGISTRY.counter(
    "aiops_fleet_tenant_migrations_total",
    "Completed tenant migrations between serving packs (journal-cursor "
    "handoff, exactly-once)")
FLEET_TENANT_LOAD = REGISTRY.gauge(
    "aiops_fleet_tenant_load_rows_per_sec",
    "Per-tenant admitted-rows/s EWMA load estimate the bin-packer "
    "places by, by tenant label")

# graft-evolve instrumentation (learn/): the online learning loop.
# Every stage of the verdicts→checkpoint pipeline is counted — harvested
# episodes, buffer occupancy, fine-tune steps, the gate's eval accuracy,
# and the swap/rollback/gate-reject outcomes — so "the model silently got
# worse" is not a failure mode this loop can have.
LEARN_EPISODES_HARVESTED = REGISTRY.counter(
    "aiops_learn_episodes_harvested_total",
    "Labeled incidents harvested into replay-buffer episodes, by label "
    "source (feedback | verification | weak_rule)")
LEARN_BUFFER_SIZE = REGISTRY.gauge(
    "aiops_learn_buffer_size",
    "Dedup'd production episodes resident in the replay buffer")
LEARN_TRAIN_STEPS = REGISTRY.counter(
    "aiops_learn_train_steps_total",
    "Fine-tune train steps executed by the background trainer")
LEARN_EVAL_TOP1 = REGISTRY.gauge(
    "aiops_learn_eval_top1",
    "Gate holdout top-1 accuracy (simulator suite + held production "
    "slice), by params label (candidate | serving)")
LEARN_SWAPS = REGISTRY.counter(
    "aiops_learn_swaps_total",
    "Hot checkpoint swaps landed into the serving executors")
LEARN_ROLLBACKS = REGISTRY.counter(
    "aiops_learn_rollbacks_total",
    "Post-swap rollbacks to the previous params generation (nonfinite "
    "verdicts or accuracy regression after a swap)")
LEARN_GATE_REJECTS = REGISTRY.counter(
    "aiops_learn_gate_rejects_total",
    "Fine-tuned candidates discarded by the eval gate (holdout top-1 "
    "below the serving checkpoint's) — counted, never swapped")
LEARN_GENERATION = REGISTRY.gauge(
    "aiops_learn_params_generation",
    "Params generation currently serving (0 = the offline checkpoint)")

# graft-scope instrumentation (observability/scope.py): the end-to-end
# serving latency story — webhook→verdict SLO histograms, per-tick stage
# splits at the host boundaries, telemetry self-accounting (dropped
# spans), flight-recorder dumps, and roofline drift gauges.
_SLO_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.15,
                0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
WEBHOOK_VERDICT_LATENCY = REGISTRY.histogram(
    "aiops_webhook_verdict_latency_seconds",
    "End-to-end webhook→verdict latency by tenant/backend/shards — the "
    "ROADMAP item-2 SLO surface (p50/p99 via Histogram.percentile)",
    buckets=_SLO_BUCKETS)
TICK_STAGE_SECONDS = REGISTRY.histogram(
    "aiops_tick_stage_seconds",
    "Per-tick host-boundary stage durations (staging|dispatch|"
    "queue_wait|execute|fetch) by stage/backend labels",
    buckets=_SLO_BUCKETS)
TRACE_SPANS_DROPPED = REGISTRY.counter(
    "aiops_trace_spans_dropped_total",
    "Spans silently evicted by a bounded telemetry buffer, by site "
    "(tracer_ring | exporter_queue | scope_arrivals) — a tracer that "
    "cannot count its own losses is not auditable")
SCOPE_FLIGHT_DUMPS = REGISTRY.counter(
    "aiops_scope_flight_dumps_total",
    "Flight-recorder dumps written, by reason label (shield tier "
    "transitions and recoveries)")
SCOPE_FLIGHT_DUMPS_PRUNED = REGISTRY.counter(
    "aiops_scope_flight_dumps_pruned_total",
    "Old flight-recorder dump files pruned by the retention policy "
    "(settings.flight_dump_keep newest kept per directory)")
SCOPE_VERDICTS_OBSERVED = REGISTRY.counter(
    "aiops_scope_verdicts_observed_total",
    "Webhook→verdict latency samples observed, by backend label")
ROOFLINE_MODELED_BYTES = REGISTRY.gauge(
    "aiops_roofline_modeled_tick_bytes",
    "graft-cost modeled HBM bytes of the LIVE serving tick (traced at "
    "its current compiled shapes), by entrypoint and pack labels")
ROOFLINE_HALO_BYTES = REGISTRY.gauge(
    "aiops_roofline_modeled_halo_bytes",
    "graft-cost modeled collective (halo) bytes of the live serving "
    "tick, by entrypoint and pack labels")
ROOFLINE_ACHIEVED_BPS = REGISTRY.gauge(
    "aiops_roofline_achieved_bytes_per_sec",
    "Modeled tick bytes / host-observed device seconds (EWMA): the "
    "achieved-bandwidth proxy the drift gauge compares against, per "
    "(entrypoint, pack) series")
ROOFLINE_DRIFT = REGISTRY.gauge(
    "aiops_roofline_drift",
    "Achieved bytes/sec vs the best observed in this process for the same "
    "(entrypoint, pack) (1.0 = at the high-water mark; a sustained fall is "
    "measured performance decaying away from the cost model without a "
    "bench run)")
