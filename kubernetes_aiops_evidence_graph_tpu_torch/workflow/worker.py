"""Incident worker — the Temporal worker analog.

The reference worker registers the workflow + activities on task queue
"incident-workflow" and scales horizontally (worker.py:31-73). Here: an
asyncio queue with N concurrent workflow slots in one process; horizontal
scale-out is running more processes against the same SQLite/cluster
backends. That is a tested claim, not an aspiration: the step journal is
WAL-mode with busy-timeout writes (storage/sqlite.py _connect) and every
journal write is an idempotent upsert, so tests/test_multiprocess.py
proves two real OS processes can contend on one journal and that a
SIGKILL mid-workflow replays to completion in a second process without
re-executing completed steps.

The port's copy serves from the port's scorers on the worker's device
(``device=None`` is the CUDA device and raises without one; the tests
pass ``"cpu"``), wrapped in the crash shield (``rca/shield.py``) when
``shield_enabled``, or from a tenant's pack of a shared multi-tenant
``rca/surge.SurgeServer`` (rules backend only). With ``mesh_dp`` or
``serve_graph_shards`` above 1 the rules scorer serves on a mesh built
from the device's pool (``_serving_mesh``). It starts no warm thread:
a hand kernel compiles once, so the JAX package's warm paths have no
counterpart. A serving, heal or learn mesh may span several cards.
"""
from __future__ import annotations

import asyncio
import threading
from sqlite3 import Error as sqlite3Error
from typing import Any

from ..config import Settings, get_settings
from ..device import resolve_device
from ..graph import GraphBuilder
from ..models import Incident
from ..observability import get_logger
from ..observability import metrics as obs_metrics
from ..storage import Database
from .engine import WorkflowEngine
from .incident_workflow import run_incident_workflow

log = get_logger("worker")


def _incident_from_row(row: dict) -> Incident:
    """Rehydrate an Incident from its durable incidents row (the resumer
    re-enters run_incident_workflow with it; ``model_validate`` converts
    the ISO strings and enum values)."""
    return Incident.model_validate(dict(
        id=row["id"], fingerprint=row["fingerprint"], title=row["title"],
        description=row["description"], severity=row["severity"],
        status=row["status"], source=row["source"], cluster=row["cluster"],
        namespace=row["namespace"], service=row["service"],
        labels=row.get("labels") or {},
        annotations=row.get("annotations") or {},
        started_at=row["started_at"], created_at=row["created_at"],
        updated_at=row["updated_at"],
    ))


class IncidentWorker:
    def __init__(
        self,
        cluster: Any,
        db: Database,
        builder: GraphBuilder | None = None,
        settings: Settings | None = None,
        concurrency: int = 4,
        dedup: Any = None,
        surge: Any = None,
        tenant: str = "default",
        device: Any = None,
    ) -> None:
        self.cluster = cluster
        self.db = db
        self.builder = builder or GraphBuilder()
        self.settings = settings or get_settings()
        self.device = resolve_device(device)
        self.dedup = dedup
        self.concurrency = concurrency
        self.queue: asyncio.Queue[Incident | None] = asyncio.Queue()
        self.engine = WorkflowEngine(db)
        self._tasks: list[asyncio.Task] = []
        self.completed: int = 0
        self.failed: int = 0
        # resident serving scorer (tpu backend): created once, mirrors the
        # store via its change journal — no per-incident snapshot rebuild
        self.scorer: Any = None
        self._scorer_lock = threading.Lock()
        # attach this worker's store to a shared multi-tenant SurgeServer
        # (rca/surge.py): N per-tenant workers then serve off ONE resident
        # pack and their concurrent incidents score in one device pass.
        # Registration is cheap; the pack builds lazily at first serve.
        # ``tenant`` labels this worker's region
        if surge is not None and self.settings.rca_backend != "tpu":
            # the pack batches the rules scorer's verdict pass; other
            # backends keep their per-tenant resident scorer
            log.warning("surge_requires_tpu_backend",
                        rca_backend=self.settings.rca_backend)
            surge = None
        self.surge = surge
        self.tenant = tenant
        if surge is not None:
            surge.register(tenant, self.builder.store)
        # once the scorer question is settled (a resident scorer exists,
        # or the backend has none), steady-state incidents skip the
        # executor hop entirely — `scorer_resolutions` counts the slow
        # path so tests can pin the fast path actually engages
        self._scorer_resolved = False
        self.scorer_resolutions = 0
        # graft-saga resumer: the periodic sweep task reclaiming expired
        # leases (started by start() when workflow_resume_interval_s > 0)
        self._resume_task: asyncio.Task | None = None
        self.resumed: int = 0

    def serving_scorer(self) -> Any:
        """Lazily build the shared resident scorer on the worker's device:
        StreamingScorer for rca_backend=tpu (kernels/rules_fold),
        GnnStreamingScorer for rca_backend=gnn (kernels/gms and the
        serving ticks), wrapped in the crash shield when
        ``shield_enabled``."""
        if self.settings.rca_backend not in ("tpu", "gnn"):
            return None
        if self.surge is not None:
            # the shared multi-tenant pack IS this worker's resident
            # scorer; scorer() (re)builds under the server's own lock when
            # tenants registered since the last build. The shield wraps
            # one store and stays off the pack (each tenant's
            # quarantine/heal ladder covers poison)
            if self.settings.shield_enabled:
                log.warning("surge_shield_unsupported", tenant=self.tenant)
            scorer = self.surge.scorer(self.tenant)
            with self._scorer_lock:
                self.scorer = scorer
            return scorer
        with self._scorer_lock:
            if self.scorer is None:
                if self.settings.rca_backend == "gnn":
                    scorer = self._build_gnn_scorer()
                else:
                    from ..rca.streaming import StreamingScorer
                    scorer = StreamingScorer(
                        self.builder.store, self.settings,
                        device=self.device, mesh=self._serving_mesh(),
                        mesh_from_settings=False)
                if self.settings.shield_enabled:
                    # the crash-consistent recovery layer: on acquisition
                    # either restore a compatible on-disk snapshot+journal
                    # (a prior shield of THIS store lineage, e.g. a
                    # restarted serve loop in the same process) or anchor a
                    # fresh snapshot so recovery is possible from tick one
                    from ..rca.shield import ShieldedScorer
                    scorer = ShieldedScorer(scorer, self.settings)
                    scorer.recover_or_snapshot()
                self.scorer = scorer
            return self.scorer

    def close(self) -> None:
        """Join the shield's snapshot writer and close its journal (a no-op
        for an unshielded scorer)."""
        close = getattr(self.scorer, "close", None)
        if close is not None:
            close()

    def _build_gnn_scorer(self):
        """GnnStreamingScorer, or the RULES serving tier when the
        checkpoint is unusable (corrupt, legacy, or missing): a bad
        checkpoint degrades serving — verdicts keep flowing from the rules
        fold, on the same device — never crashes the worker. The fallback
        is loud (error log + shield tier counter) and the workflow's
        hypothesis slicing keys off the RESULT surface, so a rules-tier
        scorer under rca_backend=gnn serves rules hypotheses."""
        from ..rca.gnn_backend import CheckpointError
        from ..rca.gnn_streaming import GnnStreamingScorer
        try:
            return GnnStreamingScorer(self.builder.store, self.settings,
                                      device=self.device,
                                      mesh=self._serving_mesh(),
                                      mesh_from_settings=False)
        except CheckpointError as exc:
            log.error("gnn_checkpoint_unusable_rules_fallback",
                      error=str(exc))
            obs_metrics.SHIELD_TIER_TRANSITIONS.inc(tier="rules_fallback")
            from ..rca.streaming import StreamingScorer
            return StreamingScorer(self.builder.store, self.settings,
                                   device=self.device)

    def _serving_mesh(self):
        """The mesh ``settings.mesh_dp`` and ``settings.serve_graph_shards``
        ask for, from the default pool of the worker's device's platform
        (``parallel/mesh.settings_mesh``); None = single-device serving
        (logged when the pool is short)."""
        from ..parallel.mesh import settings_mesh
        return settings_mesh(self.settings, self.device)

    async def submit(self, incident: Incident) -> None:
        await self.queue.put(incident)

    async def _worker_loop(self, slot: int) -> None:
        while True:
            incident = await self.queue.get()
            if incident is None:
                self.queue.task_done()
                return
            try:
                # scorer construction tensorizes the whole store (O(N) +
                # device upload) — run it on an executor thread so the
                # one-time cold start never freezes the event loop. Once
                # resolved (warm scorer, or a backend with none), the
                # fast path reuses the cached reference: steady-state
                # incidents pay zero thread round-trips here. A surge
                # fleet whose tenant set changed since its packs were
                # built (``fresh()`` False) resolves again: the repacked
                # pack supersedes the cached one
                if self._scorer_resolved and (
                        self.surge is None or self.surge.fresh()):
                    scorer = self.scorer
                else:
                    self.scorer_resolutions += 1
                    scorer = await asyncio.get_event_loop().run_in_executor(
                        None, self.serving_scorer)
                    self._scorer_resolved = True
                await run_incident_workflow(
                    incident, self.cluster, self.db, builder=self.builder,
                    settings=self.settings, engine=self.engine,
                    dedup=self.dedup, scorer=scorer, tenant=self.tenant,
                    device=self.device)
                self.completed += 1
            except Exception as exc:  # graft-audit: allow[broad-except] per-incident isolation: one failed workflow must not kill the serve loop
                self.failed += 1
                log.error("incident_workflow_error", slot=slot,
                          incident=str(incident.id), error=str(exc))
            finally:
                self.queue.task_done()

    # -- graft-saga resumer: drain orphaned workflows ---------------------

    async def resume_orphans(self) -> int:
        """One sweep: reclaim workflows whose lease EXPIRED (their worker
        died mid-run) and re-enter them through run_incident_workflow's
        journal-replay path. Also stamps the stalled-workflow gauge
        (failed steps / exhausted resume budget) so operators see what
        the sweep will NOT touch."""
        if not getattr(self.settings, "workflow_lease_enabled", False):
            return 0
        max_resumes = int(getattr(self.settings, "workflow_max_resumes", 5))
        resumed = 0
        for row in self.db.orphaned_incidents(max_resumes=max_resumes):
            incident = _incident_from_row(row)
            obs_metrics.WORKFLOW_RESUMES.inc()
            self.resumed += 1
            resumed += 1
            log.info("workflow_resumed", incident=str(incident.id),
                     prior_resumes=row.get("resumes"))
            await self.submit(incident)
        obs_metrics.WORKFLOW_STALLED.set(float(len(
            self.db.stalled_workflows(max_resumes=max_resumes))))
        return resumed

    async def _resume_loop(self, interval_s: float) -> None:
        while True:
            await asyncio.sleep(interval_s)
            try:
                await self.resume_orphans()
            except (sqlite3Error, RuntimeError, ValueError) as exc:
                log.error("resume_sweep_failed", error=str(exc))

    async def start(self) -> None:
        self._tasks = [asyncio.create_task(self._worker_loop(i))
                       for i in range(self.concurrency)]
        interval = float(getattr(self.settings,
                                 "workflow_resume_interval_s", 0.0))
        if interval > 0 and getattr(self.settings,
                                    "workflow_lease_enabled", False):
            self._resume_task = asyncio.create_task(
                self._resume_loop(interval))

    async def drain(self) -> None:
        """Wait for queue to empty, then stop workers."""
        if self._resume_task is not None:
            self._resume_task.cancel()
            self._resume_task = None
        await self.queue.join()
        for _ in self._tasks:
            await self.queue.put(None)
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []

    async def run_all(self, incidents: list[Incident]) -> dict:
        await self.start()
        for inc in incidents:
            await self.submit(inc)
        await self.drain()
        return {"completed": self.completed, "failed": self.failed}
