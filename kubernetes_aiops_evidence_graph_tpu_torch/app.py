"""Application composition root.

Wires the whole platform together — storage, graph store, dedup, rate
limiting, workflow worker (asyncio loop on a background thread), HTTP API —
the role docker-compose's aiops-api + aiops-worker pair plays for the
reference (docker-compose.yml:205-253), in one process with no external
services. `python -m kubernetes_aiops_evidence_graph_tpu_torch.serve`
serves it.

The port's copy of the JAX package's app: the same routes and lifecycle,
with the scorers on an explicit ``device`` (``None`` is the CUDA device
and raises without one; the tests pass ``"cpu"``).
"""
from __future__ import annotations

import asyncio
import collections
import sqlite3
import threading
from dataclasses import dataclass, field
from typing import Any, Optional
from uuid import UUID

from .config import Settings, get_settings
from .device import resolve_device
from .graph import GraphBuilder
from .ingestion.admission import AdmissionController, CircuitBreaker
from .ingestion.api import make_server
from .ingestion.dedup import AlertDeduplicator, RateLimiter
from .models import Incident, IncidentCreate
from .observability import ALERTS_DEDUPLICATED, INCIDENTS_CREATED, configure, get_logger
from .observability import metrics as obs_metrics
from .storage import Database, DuplicateIncidentError
from .workflow import IncidentWorker, WorkflowEngine

log = get_logger("app")


@dataclass
class IngestBatchResult:
    """Exact overload accounting for one columnar webhook batch: every
    eligible row lands in exactly one of created / duplicates / shed /
    sampled / spilled (the webhook_storm bench asserts the sum)."""

    created: list[tuple[str, str]] = field(default_factory=list)
    duplicates: int = 0
    shed: int = 0                  # admission gate (token bucket dry)
    sampled: int = 0               # storm-mode sampled persistence
    spilled: int = 0               # persist breaker open -> spill journal
    retry_after_s: float = 0.0


class AiopsApp:
    def __init__(
        self,
        cluster: Any,
        settings: Settings | None = None,
        db: Database | None = None,
        surge: Any = None,
        device: Any = None,
    ) -> None:
        self.settings = settings or get_settings()
        self.device = resolve_device(device)
        configure(self.settings.log_level)
        self.cluster = cluster
        self.db = db or Database(self.settings.db_path)
        self.builder = GraphBuilder()
        if self.settings.graph_persist_path:
            import os
            path = self.settings.graph_persist_path
            if os.path.exists(path):
                from .graph.store import EvidenceGraphStore
                # a corrupt/incompatible persist file must not block startup
                # (stop() likewise never lets persistence failures block
                # shutdown) — move it aside and start with an empty store
                try:
                    self.builder.store = EvidenceGraphStore.load(path)
                    log.info("graph_restored", path=path,
                             nodes=self.builder.store.node_count())
                except Exception as exc:  # graft-audit: allow[broad-except] corrupt persisted graph must not block startup; moved aside below
                    bad = path + ".corrupt"
                    try:
                        os.replace(path, bad)
                    except OSError:
                        bad = "<unmovable>"
                    log.error("graph_restore_failed", path=path,
                              moved_to=bad, error=str(exc))
        self.store = self.builder.store
        self._otlp = None
        if self.settings.otlp_endpoint:
            from .observability import TRACER
            from .observability.otlp import OtlpExporter
            self._otlp = OtlpExporter(self.settings.otlp_endpoint,
                                      self.settings.otel_service_name)
            TRACER.on_end = self._otlp.enqueue
            log.info("otlp_export_enabled",
                     endpoint=self.settings.otlp_endpoint)
        self.dedup = AlertDeduplicator(self.settings)
        self.rate_limiter = RateLimiter(self.settings)
        # graft-storm: per-tenant token-bucket admission with severity
        # shedding on the columnar webhook path (the legacy fixed-window
        # limiter stays as the dict-path oracle's request gate), plus a
        # circuit breaker around SQLite persist — open degrades ingest to
        # the bounded spill journal instead of timing out every webhook.
        # Chaos hooks (rca/faults.py ingest stages parse|dedup|persist|
        # admit) thread through ``fault_injector``.
        self.fault_injector: Any = None
        self.admission: AdmissionController | None = None
        if getattr(self.settings, "ingest_admission", False) and \
                getattr(self.settings, "ingest_columnar", False):
            self.admission = AdmissionController(self.settings)
        self._persist_breaker = CircuitBreaker(
            "persist",
            failure_threshold=getattr(self.settings,
                                      "breaker_failure_threshold", 5),
            cooldown_s=getattr(self.settings, "breaker_cooldown_s", 2.0))
        self._persist_spill: collections.deque = collections.deque(
            maxlen=max(int(getattr(self.settings,
                                   "persist_spill_cap", 4096)), 1))
        self._spill_lock = threading.Lock()
        self._storm_sample_counter = 0
        # an optional shared SurgeServer fleet: the worker serves off its
        # tenant's pack, and GET /api/v1/fleet exposes placement, load and
        # the migration history
        self.surge = surge
        self.worker = IncidentWorker(cluster, self.db, builder=self.builder,
                                     settings=self.settings, dedup=self.dedup,
                                     surge=surge, device=self.device)
        # graft-evolve (learn/): the online learning loop, attached to the
        # worker's resident GNN scorer once serving resolves it. Built on
        # a background thread at start() — scorer construction tensorizes
        # the store, and learning must never delay first-serve.
        self.learner = None
        self._learner_thread: threading.Thread | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._loop_thread: threading.Thread | None = None
        self._server = None
        self._server_thread: threading.Thread | None = None

    # -- lifecycle --------------------------------------------------------

    def start(self, host: str | None = None, port: int | None = None) -> int:
        """Start worker loop + HTTP server; returns the bound port."""
        self._loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(
            target=self._loop.run_forever, daemon=True, name="kaeg-worker-loop")
        self._loop_thread.start()
        asyncio.run_coroutine_threadsafe(self.worker.start(), self._loop).result()
        # graft-saga startup sweep: a PREVIOUS process that died mid-
        # workflow left incidents stuck INVESTIGATING with expired leases
        # — reclaim and re-enter them through the journal-replay path
        # before taking new traffic (the periodic sweep keeps watching)
        resumed = asyncio.run_coroutine_threadsafe(
            self.worker.resume_orphans(), self._loop).result()
        if resumed:
            log.info("startup_resume_sweep", resumed=resumed)

        self._server = make_server(
            self, host or self.settings.api_host,
            self.settings.api_port if port is None else port)
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="kaeg-http")
        self._server_thread.start()
        bound = self._server.server_address[1]
        if self.settings.learn_enabled:
            self._learner_thread = threading.Thread(
                target=self._start_learner, name="kaeg-learn-boot",
                daemon=False)
            self._learner_thread.start()
        log.info("app_started", port=bound)
        return bound

    def _start_learner(self) -> None:
        """Resolve the resident GNN scorer (may build it — off the event
        loop and off the serving path) and start the online learning
        loop. Any backend without a swappable scorer leaves learning off,
        loudly."""
        try:
            scorer = self.worker.serving_scorer()
            if scorer is None or not hasattr(scorer, "swap_params"):
                log.warning("learn_requires_gnn_scorer",
                            rca_backend=self.settings.rca_backend)
                return
            from .learn import OnlineLearner
            self.learner = OnlineLearner(self.db, [scorer],
                                         settings=self.settings)
            self.learner.start()
            log.info("learner_started",
                     interval_s=self.settings.learn_interval_s)
        except Exception as exc:  # graft-audit: allow[broad-except] learning is strictly additive: a failed learner boot must never take serving down
            log.error("learner_start_failed", error=str(exc))

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server = None
        if self._learner_thread is not None:
            self._learner_thread.join(timeout=30)
            self._learner_thread = None
        if self.learner is not None:
            self.learner.stop()
        if self._loop is not None:
            try:
                asyncio.run_coroutine_threadsafe(
                    self.worker.drain(), self._loop).result(timeout=30)
            except Exception as exc:  # graft-audit: allow[broad-except] drain stuck (e.g. pending approval); force shutdown
                log.warning("drain_timeout_forcing_stop", error=str(exc))
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._loop_thread.join(timeout=5)
            self._loop = None
        self.worker.close()
        try:
            if self.settings.graph_persist_path:
                written = self.store.save(self.settings.graph_persist_path)
                log.info("graph_persisted",
                         path=self.settings.graph_persist_path,
                         records=written)
        except Exception as exc:  # graft-audit: allow[broad-except] never let persistence block shutdown
            log.error("graph_persist_failed", error=str(exc))
        finally:
            if self._otlp is not None:
                from .observability import TRACER
                TRACER.on_end = None
                self._otlp.close()  # final best-effort flush
            self.db.close()

    def ready(self) -> bool:
        try:
            self.db.query("SELECT 1")
            return self._loop is not None and self._loop.is_running()
        except Exception:  # graft-audit: allow[broad-except] readiness probe: any failure reads as not-ready
            return False

    # -- ingestion path (main.py:345-425 analog) --------------------------

    def ingest(self, spec: IncidentCreate) -> Optional[str]:
        """Normalize→dedup→persist→launch workflow. Returns incident id or
        None when deduplicated."""
        if self.dedup.check_duplicate(spec.fingerprint):
            ALERTS_DEDUPLICATED.inc(reason="ttl")
            return None
        incident = Incident(**spec.model_dump())
        outcome = self._persist_incident(incident)
        if outcome == "duplicate":
            ALERTS_DEDUPLICATED.inc(reason="storage")  # backstop (init-db.sql:27)
            return None
        self.dedup.register_fingerprint(spec.fingerprint)  # fixes defect 4
        if outcome == "spilled":
            # persist breaker open: the incident waits in the bounded
            # spill journal and launches its workflow on replay — the
            # webhook is acknowledged with its id, not timed out
            return str(incident.id)
        INCIDENTS_CREATED.inc(severity=incident.severity.value)
        self._submit_workflow(incident)
        return str(incident.id)

    def _submit_workflow(self, incident: Incident) -> None:
        if self._loop is not None:
            asyncio.run_coroutine_threadsafe(
                self.worker.submit(incident), self._loop)

    # -- persist breaker + spill journal (graft-storm) --------------------

    def _persist_incident(self, incident: Incident) -> str:
        """One guarded DB insert: ``created`` | ``duplicate`` |
        ``spilled``. A wedged SQLite (N consecutive failures) opens the
        persist breaker; while open every incident costs one state check
        and a bounded-deque append instead of a timeout, and the
        half-open probe's first success replays the spill."""
        inj = self.fault_injector
        br = self._persist_breaker
        if not br.allow():
            self._spill(incident)
            return "spilled"
        try:
            if inj is not None:
                inj.at("persist")
            self.db.create_incident(incident)
        except DuplicateIncidentError:
            br.record_success()
            return "duplicate"
        except (sqlite3.Error, OSError, RuntimeError) as exc:
            br.record_failure()
            log.error("persist_failed", error=str(exc),
                      breaker=br.state)
            self._spill(incident)
            return "spilled"
        br.record_success()
        if self._persist_spill:
            self._replay_spill()
        return "created"

    def _spill(self, incident: Incident) -> None:
        with self._spill_lock:
            if len(self._persist_spill) == self._persist_spill.maxlen:
                obs_metrics.PERSIST_SPILL_DROPPED.inc()
            self._persist_spill.append(incident)
        obs_metrics.PERSIST_SPILLED.inc()

    def _replay_spill(self) -> int:
        """Drain the spill journal through the (now healthy) DB in spill
        order; stops — leaving the rest spilled — on the first fresh
        failure. Replayed incidents launch their workflows late rather
        than never."""
        replayed = 0
        while True:
            with self._spill_lock:
                if not self._persist_spill:
                    return replayed
                incident = self._persist_spill.popleft()
            try:
                self.db.create_incident(incident)
            except DuplicateIncidentError:
                obs_metrics.ALERTS_DEDUPLICATED.inc(reason="storage")
                continue
            except (sqlite3.Error, OSError, RuntimeError) as exc:
                self._persist_breaker.record_failure()
                with self._spill_lock:
                    self._persist_spill.appendleft(incident)
                log.error("spill_replay_failed", error=str(exc))
                return replayed
            replayed += 1
            obs_metrics.PERSIST_SPILL_REPLAYED.inc()
            INCIDENTS_CREATED.inc(severity=incident.severity.value)
            self._submit_workflow(incident)

    def ingest_batch(self, cols) -> IngestBatchResult:
        """graft-intake/graft-storm: columnar batch twin of
        :meth:`ingest`, with the overload ladder applied in order.

        One vectorized dedup probe covers the whole batch (the hashed
        ring answers every fingerprint in a handful of array compares —
        dedup runs FIRST so duplicates never charge the admission
        budget), intra-batch repeats collapse to their first occurrence,
        the admission gate sheds lowest-severity-first when the tenant's
        token bucket runs dry (critical never sheds), storm mode samples
        persistence of presumed re-arrivals, and only the remaining
        survivors pay pydantic spec construction and a (breaker-guarded)
        DB insert. Returns an :class:`IngestBatchResult` with exact
        per-outcome accounting."""
        import numpy as np

        res = IngestBatchResult()
        inj = self.fault_injector
        if inj is not None:
            # "parse" chaos stage: the payload-decode boundary — a fault
            # here rejects the whole batch (the webhook client retries),
            # nothing was admitted or persisted
            inj.at("parse")
        elig = np.flatnonzero(cols.eligible)
        if elig.size == 0:
            return res
        fps = cols.fingerprint[elig]
        try:
            if inj is not None:
                inj.at("dedup")
            dup = self.dedup.check_batch(fps)
        except RuntimeError as exc:
            # fail open, like the scalar path: a broken dedup window must
            # not drop alerts — the storage layer's UNIQUE-fingerprint
            # backstop still suppresses duplicates, so admitted-event
            # parity holds (chaos contract, tests/test_storm.py)
            log.error("dedup_failed_open", error=str(exc))
            dup = np.zeros(len(fps), bool)
        # intra-batch duplicates: the dict path registers the first
        # occurrence then TTL-hits the rest — keep-first via unique
        _, first = np.unique(fps, return_index=True)
        keep = np.zeros(len(fps), bool)
        keep[first] = True
        dup |= ~keep
        res.duplicates = int(dup.sum())
        if res.duplicates:
            obs_metrics.ALERTS_DEDUPLICATED.inc(float(res.duplicates),
                                                reason="ttl")
            obs_metrics.INGEST_DEDUP_HITS.inc(float(res.duplicates),
                                              source=cols.source.value)
        # admission: dedup survivors charge the tenant's token bucket;
        # shed rows answer 429 + Retry-After at the handler
        admit = np.ones(len(fps), bool)
        if self.admission is not None:
            try:
                admit, res.retry_after_s = self.admission.admit_batch(
                    cols.namespace[elig], cols.severity_code[elig],
                    chargeable=~dup)
            except RuntimeError as exc:
                # "admit" chaos stage / a broken gate fails OPEN: an
                # admission outage must never drop alerts on its own
                log.error("admission_failed_open", error=str(exc))
                admit = np.ones(len(fps), bool)
            res.shed = int((~admit & ~dup).sum())
        # storm-mode sampled persistence: fresh non-critical rows are
        # overwhelmingly re-arrivals whose ring entry was evicted —
        # persist 1-in-N, register the rest back into the ring
        survivors = ~dup & admit
        sampled_fps: list[str] = []
        if (self.admission is not None and self.admission.storm.active):
            every = int(getattr(self.settings, "storm_sample_every", 0))
            if every > 1:
                sev = cols.severity_code[elig]
                ns = cols.namespace[elig]
                for i in np.flatnonzero(survivors & (sev > 0)):
                    self._storm_sample_counter += 1
                    if self._storm_sample_counter % every:
                        survivors[i] = False
                        sampled_fps.append(str(fps[i]))
                        obs_metrics.STORM_SAMPLED_ROWS.inc(
                            tenant=str(ns[i]))
                res.sampled = len(sampled_fps)
        registered: list[str] = []
        for spec in cols.specs(elig[survivors]):
            incident = Incident(**spec.model_dump())
            outcome = self._persist_incident(incident)
            if outcome == "duplicate":
                res.duplicates += 1
                continue
            registered.append(spec.fingerprint)
            if outcome == "spilled":
                res.spilled += 1
                continue
            INCIDENTS_CREATED.inc(severity=incident.severity.value)
            self._submit_workflow(incident)
            res.created.append((str(incident.id), incident.namespace))
        if registered or sampled_fps:
            # sampled rows register too: their repeats must dedup, and
            # the row they stand in for will exist once a sample lands
            self.dedup.register_batch(registered + sampled_fps)
        return res

    def workflow_status(self, incident_id: str | UUID) -> dict:
        return self.worker.engine.status(f"incident-{incident_id}")

    def learning_status(self) -> dict:
        """GET /api/v1/learning: the online-learning loop's observable
        state — buffer occupancy, last gate eval, swap generation."""
        l = self.learner
        if l is None:
            return {"enabled": bool(self.settings.learn_enabled),
                    "running": False}
        return {"enabled": True, **l.status()}


def main() -> None:  # pragma: no cover - manual entrypoint
    """Serve the platform on the CUDA device. KAEG_CLUSTER_BACKEND selects
    the evidence source (fake = hermetic demo cluster, kubernetes = live
    K8s/Prometheus/Loki, collectors/live.py); KAEG_COORDINATOR /
    _NUM_PROCESSES / _PROCESS_ID join a multi-process group
    (parallel/multihost.py, NCCL; each rank serves on its own card)
    before any other device use."""
    from .parallel import init_distributed
    init_distributed()
    settings = get_settings()
    if settings.cluster_backend == "kubernetes":
        from .collectors.live import LiveClusterBackend
        cluster: Any = LiveClusterBackend(settings)
    else:
        from .simulator import generate_cluster
        cluster = generate_cluster(num_pods=200, seed=0)
    app = AiopsApp(cluster, settings)
    port = app.start()
    print(f"kaeg serving on :{port} (Ctrl-C to stop)")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        app.stop()
