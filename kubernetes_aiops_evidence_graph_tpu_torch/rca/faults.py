"""Deterministic fault injection for the serving hot path (graft-shield).

The shield's recovery claims are only as strong as the faults they were
proven against, so this harness injects failures at every stage of the
tick pipeline — from seeded schedules, so every chaos run is exactly
reproducible from its seed (the CI chaos job echoes the seed it drew).

Stages (where the hooks fire):

* ``staging``        — shield delta staging, before any state mutation
* ``dispatch``       — after the pending deltas are packed and drained,
                       before the tick runs (the staged values are
                       lost: recovery MUST replay, a bare retry cannot)
* ``pack``           — the PACKED delta buffer exists (the tick's one
                       staged int32 slab) but the tick has not run;
                       deltas are already drained, so this is
                       dispatch-class — journal replay only
* ``execute``        — after the tick's device work was enqueued on the
                       scorer's stream (a device error mid-pipeline);
                       ``device_loss`` additionally corrupts the resident
                       tensors, simulating the device state dying
* ``fetch``          — the device→host readback failed (state is intact:
                       an empty re-tick re-serves it)
* ``journal_append`` / ``snapshot_write`` — torn writes via the
                       rca/journal.py fault hook (crash mid-record)
* ``delta_values``   — value poisoning: NaN/inf stamped into the staged
                       feature rows (the finite guard must quarantine)
* ``stall``          — the tick completes but only after sleeping past the
                       watchdog timeout (fires at the ``execute`` hook)
* ``shard_loss``     — a PER-SHARD device fault on the resident state.
                       ``kind="shard_loss"`` corrupts exactly one shard's
                       node block and raises with the position attached
                       (the shield's shard-loss classifier keys on it);
                       ``kind="shard_corrupt_silent"`` corrupts the block
                       and returns — the class only the attestation fold
                       can localize before it serves. On a graph-sharded
                       mesh the block is one position's, on its device

graft-storm widened the harness past the tick path — the ingest and
learner paths previously had ZERO fault coverage:

* ``parse``          — the webhook payload-decode boundary
                       (app.ingest_batch entry): the batch is rejected,
                       nothing admitted/persisted, the client retries
* ``dedup``          — the batch dedup probe: MUST fail open (alerts are
                       never dropped by a broken window; the storage
                       UNIQUE-fingerprint backstop preserves parity)
* ``persist``        — the SQLite insert: failures walk the persist
                       circuit breaker (open → bounded spill journal →
                       half-open probe → replay)
* ``admit``          — the admission gate: MUST fail open (a broken gate
                       never drops alerts on its own)
* ``harvest`` / ``swap`` — the online-learning loop (learn/loop.py): a
                       faulted cycle is contained — serving params and
                       generation are untouched, the loop survives

Faults address the Nth *visit* of their stage and can repeat for several
consecutive visits (``repeats``) to force the shield past bounded retry
into the deeper degradation tiers.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Any, Iterable

import numpy as np
import torch

from ..observability import get_logger

log = get_logger("shield.faults")

TICK_STAGES = ("staging", "dispatch", "pack", "execute", "fetch",
               "journal_append", "snapshot_write", "delta_values",
               "shard_loss")
# graft-storm: the previously-uncovered halves of the pipeline
INGEST_STAGES = ("parse", "dedup", "persist", "admit")
LEARN_STAGES = ("harvest", "swap")
# graft-saga: the incident-lifecycle stage boundaries (the back half,
# verdict → remediation → verified closure). The tick pipeline reuses
# "execute" as a stage name; lifecycle hooks are distinct call sites
# (workflow steps + the two-phase executor), so the shared name never
# aliases — one injector drives one pipeline at a time.
#
# * ``collect``      — inside collect_evidence, before evidence persists
# * ``journal_put``  — engine boundary: the step ran, its journal commit
#                      has not (the classic lost-commit crash)
# * ``wf_execute``   — inside the two-phase executor: the CLUSTER
#                      MUTATION landed, the ledger result row has not —
#                      resume must reconcile, never re-fire
# * ``verify``       — inside verify_remediation, before the verdict
# * ``compensate``   — inside the saga compensation step
# * ``crash_restart``— immediately after a resumed run re-acquires the
#                      lease (a worker that dies again right away)
WORKFLOW_STAGES = ("collect", "journal_put", "wf_execute", "verify",
                   "compensate", "crash_restart")
# graft-swell: the tenant-migration handoff boundaries (SurgeServer
# ``migrate``). ONE stage name, three hook visits per migration — after
# the fleet-journal intent append, after the source pack's incremental
# repack, and after the destination adopt — so a seeded schedule can
# crash a migration at any boundary and the recovery replay must still
# land the tenant with exactly one owner.
MIGRATE_STAGES = ("migrate",)
STAGES = (TICK_STAGES + INGEST_STAGES + LEARN_STAGES + WORKFLOW_STAGES
          + MIGRATE_STAGES)

# value-corruption stages return poisoned data instead of raising
_POISON_STAGES = frozenset({"delta_values"})


class WorkflowCrash(BaseException):
    """A simulated worker death at a lifecycle stage boundary. Derives
    from BaseException ON PURPOSE: every per-step / per-incident handler
    catches Exception, and a crash must tear the whole run down exactly
    the way SIGKILL would — no retry, no audit row, no lease release.
    The chaos harness catches it at the process-boundary analog and
    resumes through the journal-replay path like a fresh worker."""

    def __init__(self, stage: str, visit: int):
        super().__init__(f"injected crash at {stage} (visit {visit})")
        self.stage = stage
        self.visit = visit


class InjectedFault(RuntimeError):
    """A scheduled failure. ``stage`` tells the shield what is suspect:
    faults at ``staging``/``journal_append``/``snapshot_write``/``fetch``
    leave the resident state coherent (bounded retry is sound); faults at
    ``dispatch``/``execute`` mean staged deltas or the donated state
    itself are gone and only journal-replay recovery restores parity."""

    def __init__(self, stage: str, kind: str, visit: int,
                 shard: "int | None" = None):
        msg = f"injected {kind} fault at {stage} (visit {visit})"
        if shard is not None:
            msg += f" [shard {shard}]"
        super().__init__(msg)
        self.stage = stage
        self.kind = kind
        self.visit = visit
        # graft-heal: mesh position the fault is localized to (None =
        # not shard-attributable) — the shield's classifier reads this
        self.shard = shard


@dataclass(frozen=True)
class Fault:
    stage: str          # one of STAGES
    at: int             # fires on the Nth visit of the stage (0-based)
    kind: str = "raise"  # raise | device_loss | corrupt_silent | poison |
    #                      stall | shard_loss | shard_corrupt_silent
    repeats: int = 1    # consecutive visits that fail (escalation depth)
    shard: int = 0      # graft-heal: target mesh position for shard kinds


class FaultInjector:
    """Deterministic schedule of Faults, consulted at the named hook
    points (scorer ``_fault_point``/``_fault_value`` + the journal's
    ``fault_hook``). Stateless apart from per-stage visit counters, so a
    replay of the same script with the same schedule faults identically."""

    def __init__(self, faults: Iterable[Fault] = (),
                 stall_seconds: float = 0.0) -> None:
        self.faults = list(faults)
        self.stall_seconds = stall_seconds
        self.visits: dict[str, int] = {}
        self.fired: list[tuple[str, str, int]] = []

    @classmethod
    def seeded(cls, seed: int, ticks: int, rate: float = 0.25,
               stages: tuple[str, ...] = STAGES,
               stall_seconds: float = 0.0,
               shards: int = 0) -> "FaultInjector":
        """Randomized-but-reproducible schedule: each stage draws fault
        visits over ``[0, ticks)`` at ``rate``. The same seed always
        yields the same schedule — chaos runs log the seed so any failure
        reproduces exactly. ``shards`` > 0 widens the pool with per-shard
        kinds: ``shard_loss`` draws target a random mesh position, and
        half of them go SILENT (corruption only the attestation fold can
        localize)."""
        rng = np.random.default_rng(seed)
        faults: list[Fault] = []
        for stage in stages:
            hits = rng.random(ticks) < rate
            for at in np.nonzero(hits)[0]:
                shard = 0
                if stage == "delta_values":
                    kind = "poison"
                elif stage == "shard_loss":
                    kind = ("shard_corrupt_silent"
                            if rng.random() < 0.5 else "shard_loss")
                    shard = int(rng.integers(0, max(shards, 1)))
                elif stage == "execute" and rng.random() < 0.5:
                    kind = "device_loss"
                elif stage in WORKFLOW_STAGES:
                    # lifecycle stages simulate worker DEATH, not a
                    # retryable step error — the resumer must drain them
                    kind = "crash"
                else:
                    kind = "raise"
                faults.append(Fault(stage=stage, at=int(at), kind=kind,
                                    shard=shard))
        return cls(faults, stall_seconds=stall_seconds)

    def _due(self, stage: str) -> "Fault | None":
        visit = self.visits.get(stage, 0)
        self.visits[stage] = visit + 1
        for f in self.faults:
            if f.stage == stage and f.at <= visit < f.at + f.repeats:
                return f
        return None

    # -- hook API (scorer/_shield/journal call these) ----------------------

    def at(self, stage: str, scorer: Any = None) -> None:
        """Raise (or corrupt-then-raise, or stall) if a fault is due at
        this visit of ``stage``; no-op otherwise."""
        f = self._due(stage)
        if f is None:
            return
        visit = self.visits[stage] - 1
        self.fired.append((stage, f.kind, visit))
        log.warning("fault_injected", stage=stage, kind=f.kind, visit=visit)
        if f.kind == "crash":
            raise WorkflowCrash(stage, visit)
        if f.kind == "stall":
            time.sleep(self.stall_seconds)
            return                      # completes, but past the watchdog
        if f.kind == "corrupt_silent" and scorer is not None:
            # the nastiest class: the device state dies but nothing
            # raises — only the finite guard at the verdict boundary can
            # catch it before garbage serves
            self._corrupt_resident(scorer)
            return
        if f.kind == "shard_corrupt_silent" and scorer is not None:
            # graft-heal: SILENT single-shard corruption — the rules fold
            # absorbs NaN through threshold compares, so only the
            # per-shard attestation fold at the next snapshot boundary
            # can localize (and repair) it before a wrong verdict serves
            self._corrupt_shard(scorer, f.shard)
            return
        if f.kind == "shard_loss" and scorer is not None:
            shard = self._corrupt_shard(scorer, f.shard)
            raise InjectedFault(stage, f.kind, visit, shard=shard)
        if f.kind == "device_loss" and scorer is not None:
            self._corrupt_resident(scorer)
        raise InjectedFault(stage, f.kind, visit)

    def poison(self, stage: str, value: np.ndarray) -> np.ndarray:
        """Return ``value`` with NaN/inf stamped in if a poison fault is
        due; the original array otherwise."""
        f = self._due(stage)
        if f is None or f.kind != "poison":
            return value
        visit = self.visits[stage] - 1
        self.fired.append((stage, "poison", visit))
        log.warning("fault_injected", stage=stage, kind="poison", visit=visit)
        bad = np.array(value, copy=True)
        if bad.size:
            # whole rows go non-finite: any poisoned row that is (or ever
            # becomes) evidence WILL surface at the verdict boundary — the
            # finite guard must catch it, not column luck
            bad.fill(np.nan)
            bad.reshape(-1)[0] = np.inf
        return bad

    def journal_hook(self, stage: str) -> None:
        """Adapter with the rca/journal.py ``fault_hook`` signature."""
        self.at(stage)

    # -- corruption --------------------------------------------------------

    @staticmethod
    def _corrupt_shard(scorer: Any, shard: int) -> int:
        """Kill exactly ONE mesh position's node block of the resident
        feature table, in place on that position's device: the feature rows
        the shard owns go NaN while every other block keeps its bits, so
        the shard-loss classifier can localize the fault and the
        attestation fold must flag exactly that block. On a graph-sharded
        table the block is position ``(0, shard)``'s; on a table whole at
        every position (one device, or a mesh the bucket does not divide)
        the same rows are poisoned in every replica. ``shard`` wraps over
        the mesh's graph size. Returns the position corrupted."""
        from ..parallel import compat
        from ..parallel.compat import Sharded
        feats = getattr(scorer, "_features_dev", None)
        if feats is None:
            return 0
        g = max(int(scorer._graph_size()), 1) \
            if hasattr(scorer, "_graph_size") else 1
        shard = int(shard) % g
        with _on_scorer_stream(scorer):
            if isinstance(feats, Sharded):
                # each block is poisoned at its position, on its stream
                if feats.placement.axis == "graph":
                    compat.run(feats.mesh, lambda p, b: b.fill_(float("nan")),
                               feats, where=lambda p: (p.dp, p.graph)
                               == (0, shard))
                    return shard
                compat.run(feats.mesh, lambda p, b: _poison_rows(b, shard, g),
                           feats)
            else:
                _poison_rows(feats, shard, g)
        return shard

    @staticmethod
    def _corrupt_resident(scorer: Any) -> None:
        """Simulate the resident buffers dying with the device: the
        feature tensor (the only float32 resident input every verdict
        folds) is replaced by NaNs on the scorer's device (every block of
        it on a mesh), so any path that keeps serving from this state is
        caught by the finite guards."""
        from ..parallel import compat
        from ..parallel.compat import Sharded
        feats = getattr(scorer, "_features_dev", None)
        if feats is None:
            return
        with _on_scorer_stream(scorer):
            if isinstance(feats, Sharded):
                compat.run(feats.mesh, lambda p, b: b.fill_(float("nan")),
                           feats)
            else:
                scorer._features_dev = torch.full_like(feats, float("nan"))


def _poison_rows(t, shard: int, g: int) -> None:
    """NaN into row block ``shard`` of ``g`` of a whole table."""
    rows = t.shape[0] // g
    t[shard * rows:(shard + 1) * rows] = float("nan")


def _on_scorer_stream(scorer: Any):
    """The scorer's stream context (its device work runs in order there),
    or a no-op for anything without one."""
    on = getattr(scorer, "_on_stream", None)
    return on() if on is not None else contextlib.nullcontext()


class MutationRecorder:
    """graft-saga counting seam: wraps a cluster backend and records
    every cluster-MUTATING call as (method, *str(args)). The chaos
    sweeps assert exactly-once remediation on this ledger — a crash
    anywhere in the lifecycle (including between the cluster mutation
    and the journal commit) must yield ZERO duplicate mutations across
    all resume cycles. Reads pass through untouched."""

    MUTATORS = frozenset({
        "delete_pod", "restart_deployment", "rollback_deployment",
        "scale_deployment", "cordon_node", "uncordon_node",
    })

    def __init__(self, backend: Any) -> None:
        self._backend = backend
        self.calls: list[tuple] = []

    def __getattr__(self, name: str) -> Any:
        attr = getattr(self._backend, name)
        if name in self.MUTATORS and callable(attr):
            def wrapped(*a: Any, _attr=attr, _name=name, **k: Any) -> Any:
                self.calls.append((_name,) + tuple(str(x) for x in a))
                return _attr(*a, **k)
            return wrapped
        return attr

    def duplicates(self) -> list[tuple]:
        from collections import Counter
        return [c for c, n in Counter(self.calls).items() if n > 1]
