"""Durable workflow engine — Temporal's job, in-process.

The reference leans on a Temporal server for durability: per-activity
retries with exponential backoff and non-retryable exception classes
(incident_workflow.py:60-72), per-step timeouts, event-history replay on
worker restart, and queryable in-flight state (:40-53). This engine
reproduces that contract with a SQLite step-journal (storage.sqlite
workflow_journal table): every step result is recorded, a re-run of the
same workflow id replays completed steps from the journal instead of
re-executing them, failed steps retry with backoff, and steps are expected
to be idempotent (SURVEY.md §5 checkpoint/resume).
"""
from __future__ import annotations

import asyncio
import hashlib
import inspect
import json
import time
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Sequence

from ..observability import WORKFLOW_STEP_DURATION, WORKFLOW_STEPS, TRACER, get_logger
from ..observability import metrics as obs_metrics
from ..observability.scope import SCOPE
from ..storage import Database

log = get_logger("workflow")


class NonRetryableError(Exception):
    """Fail the step immediately (reference non_retryable_error_types)."""


class WorkflowFenced(Exception):
    """graft-saga: this run's lease was lost (expired and reclaimed by
    another worker). The loser must stop driving the workflow at the next
    step boundary — the winner owns the journal now. Benign by design:
    the workflow continues elsewhere."""

    def __init__(self, workflow_id: str):
        super().__init__(f"lease for {workflow_id} lost; fenced out")
        self.workflow_id = workflow_id


@dataclass(frozen=True)
class RetryPolicy:
    """Reference defaults: 3 attempts, 1s → 5m exponential backoff
    (incident_workflow.py:60-72), plus deterministic seeded jitter."""
    max_attempts: int = 3
    initial_interval_s: float = 1.0
    backoff: float = 2.0
    max_interval_s: float = 300.0
    # ± fraction of the backoff applied as jitter. Seeded from the caller
    # key (workflow_id) + attempt, NOT from random(): a mass failure that
    # fails N workflows at once must not wake all N in lockstep on every
    # retry round (thundering herd), while a journal REPLAY of one
    # workflow must sleep exactly what the original run slept — replay
    # determinism is the Temporal-parity contract this engine keeps.
    jitter: float = 0.1

    non_retryable: tuple[type[Exception], ...] = (ValueError, TypeError,
                                                  NonRetryableError)

    def delay(self, attempt: int, key: "str | None" = None) -> float:
        base = min(self.initial_interval_s * self.backoff ** (attempt - 1),
                   self.max_interval_s)
        if not self.jitter or key is None:
            return base
        digest = hashlib.sha256(f"{key}:{attempt}".encode()).digest()
        u = int.from_bytes(digest[:8], "big") / float(1 << 64)  # [0, 1)
        return base * (1.0 - self.jitter + 2.0 * self.jitter * u)


@dataclass
class Step:
    name: str
    fn: Callable[..., Any]          # sync or async, takes (ctx) -> JSONable
    timeout_s: float = 30.0
    retry: RetryPolicy = field(default_factory=RetryPolicy)
    # skip the step (recorded as "skipped") when the predicate is false
    condition: Callable[[Any], bool] | None = None


class StepFailed(Exception):
    def __init__(self, step: str, cause: Exception, attempts: int):
        super().__init__(f"step {step} failed after {attempts} attempts: {cause}")
        self.step = step
        self.cause = cause
        self.attempts = attempts


class WorkflowEngine:
    """Executes a linear Step pipeline with journal-backed replay."""

    def __init__(self, db: Database, sleeper=asyncio.sleep) -> None:
        self.db = db
        self._sleep = sleeper  # injectable for tests

    async def run(self, workflow_id: str, steps: Sequence[Step], ctx: Any,
                  lease: "tuple[str, int] | None" = None,
                  lease_ttl_s: float = 60.0) -> dict:
        """Run (or resume) a workflow. Returns {step: result}. Completed
        steps in the journal are replayed, not re-executed.

        graft-saga: when ``lease=(owner, token)`` is supplied, the engine
        heartbeats the lease on a background task (so steps longer than
        the TTL — the 4h approval wait — stay covered) and FENCES at
        every step boundary: a heartbeat that no longer matches
        (owner, token) means the lease expired and another worker
        reclaimed the workflow, so this run raises WorkflowFenced instead
        of double-driving the journal."""
        journal = self.db.journal_get(workflow_id)
        results: dict[str, Any] = {}
        for entry_name, entry in journal.items():
            if entry["status"] in ("completed", "skipped"):
                results[entry_name] = entry["result"]
        if hasattr(ctx, "results"):
            ctx.results.update(results)

        hb_task: asyncio.Task | None = None
        if lease is not None:
            owner, token = lease

            async def _heartbeat() -> None:
                period = max(lease_ttl_s / 3.0, 0.02)
                while True:
                    await asyncio.sleep(period)
                    if not self.db.lease_heartbeat(workflow_id, owner,
                                                   token, lease_ttl_s):
                        return  # fenced; the boundary check raises

            hb_task = asyncio.get_event_loop().create_task(_heartbeat())
        try:
            for step in steps:
                if step.name in results:
                    log.debug("step_replayed", workflow=workflow_id,
                              step=step.name)
                    continue
                if lease is not None and not self.db.lease_heartbeat(
                        workflow_id, lease[0], lease[1], lease_ttl_s):
                    obs_metrics.WORKFLOW_LEASE_FENCED.inc()
                    log.warning("workflow_fenced", workflow=workflow_id,
                                step=step.name)
                    raise WorkflowFenced(workflow_id)
                if step.condition is not None and not step.condition(ctx):
                    self.db.journal_put(workflow_id, step.name, "skipped", None)
                    results[step.name] = None
                    if hasattr(ctx, "results"):
                        ctx.results[step.name] = None
                    continue
                result = await self._run_step(workflow_id, step, ctx)
                results[step.name] = result
                if hasattr(ctx, "results"):
                    ctx.results[step.name] = result
        finally:
            if hb_task is not None:
                hb_task.cancel()
        return results

    async def _run_step(self, workflow_id: str, step: Step, ctx: Any) -> Any:
        attempts = 0
        while True:
            attempts += 1
            self.db.journal_put(workflow_id, step.name, "running",
                                attempts=attempts)
            t0 = time.perf_counter()
            try:
                # graft-scope context propagation: the step span joins the
                # webhook's trace when this workflow's incident arrived
                # through one (ServeScope carries the webhook span context
                # across the async worker hop), so one exported trace
                # shows webhook → evidence → tick → verdict. Sync steps
                # run on executor threads whose span stack is empty —
                # attach() re-parents everything the step itself opens
                # (collector spans, serving-tick spans) under the step.
                with TRACER.span(f"workflow.{step.name}",
                                 parent=SCOPE.trace_parent(workflow_id),
                                 workflow=workflow_id) as step_span:
                    if inspect.iscoroutinefunction(step.fn):
                        result = await asyncio.wait_for(
                            step.fn(ctx), timeout=step.timeout_s)
                    else:
                        def _run_attached(fn=step.fn, span=step_span):
                            with TRACER.attach(span):
                                return fn(ctx)
                        try:
                            result = await asyncio.wait_for(
                                asyncio.get_event_loop().run_in_executor(
                                    None, _run_attached),
                                timeout=step.timeout_s)
                        except asyncio.TimeoutError:
                            # CAVEAT (graft-saga satellite): wait_for
                            # cancels the asyncio wrapper, but an executor
                            # THREAD cannot be cancelled — the step keeps
                            # running detached and its side effects may
                            # still land after this "timeout". Counted
                            # and logged so an orphan storm is visible;
                            # two-phase ledgered actions stay exactly-once
                            # regardless (the orphan's late result commit
                            # is an idempotent upsert).
                            obs_metrics.WORKFLOW_STEP_ORPHANS.inc(
                                step=step.name)
                            log.warning("step_thread_orphaned",
                                        workflow=workflow_id,
                                        step=step.name,
                                        timeout_s=step.timeout_s)
                            raise
                json.dumps(result, default=str)  # journal-serializable check
                dt = time.perf_counter() - t0
                WORKFLOW_STEP_DURATION.observe(dt, step=step.name)
                WORKFLOW_STEPS.inc(step=step.name, status="completed")
                # chaos boundary: the step's effects are live, its journal
                # commit is not — the classic lost-commit crash window
                inj = getattr(ctx, "faults", None)
                if inj is not None:
                    inj.at("journal_put")
                self.db.journal_put(workflow_id, step.name, "completed",
                                    result, attempts=attempts, duration_s=dt)
                return result
            except Exception as exc:
                dt = time.perf_counter() - t0
                WORKFLOW_STEP_DURATION.observe(dt, step=step.name)
                WORKFLOW_STEPS.inc(step=step.name, status="failed")
                retryable = not isinstance(exc, step.retry.non_retryable)
                log.warning("step_failed", workflow=workflow_id, step=step.name,
                            attempt=attempts, error=str(exc), retryable=retryable)
                if not retryable or attempts >= step.retry.max_attempts:
                    self.db.journal_put(workflow_id, step.name, "failed",
                                        {"error": str(exc)}, attempts=attempts,
                                        duration_s=dt)
                    raise StepFailed(step.name, exc, attempts) from exc
                await self._sleep(step.retry.delay(attempts,
                                                   key=workflow_id))

    def status(self, workflow_id: str) -> dict:
        """Queryable in-flight state (reference @workflow.query, :40-53)."""
        journal = self.db.journal_get(workflow_id)
        done = [s for s, e in journal.items() if e["status"] == "completed"]
        failed = [s for s, e in journal.items() if e["status"] == "failed"]
        running = [s for s, e in journal.items() if e["status"] == "running"]
        # graft-saga: lease + stalled visibility — the resumer and
        # operators must be able to SEE a workflow that is going nowhere
        # (failed step, or an expired lease nobody reclaimed yet)
        lease = self.db.lease_view(workflow_id)
        lease_expired = bool(
            lease and lease["deadline"] is not None
            and lease["deadline"] < time.time())  # graft-audit: allow[wall-clock] lease deadlines are cross-process wall-clock values (storage/sqlite._now)
        return {
            "workflow_id": workflow_id,
            "steps": journal,
            "completed": done,
            "failed": failed,
            "running": running,
            "state": self.db.rollup_state(
                len(failed), len(running), len(done)),
            "lease": lease,
            "stalled": bool(failed) or lease_expired,
        }
