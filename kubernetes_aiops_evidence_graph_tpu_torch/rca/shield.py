"""Crash-consistent recovery and graceful degradation for the resident
serving state: the port of the JAX package's ``rca/shield.py``.

The resident scorer updates its device tensors in place, tick by tick, so
a device fault, a poisoned delta or a crash mid-tick destroys the ONLY
copy of the serving state, and the sole fallback would be a full
``_rebuild()`` (re-tensorize the world, drop every in-flight tick). This
layer gives it three pillars:

1. **Crash-consistent recovery.** Every store-journal record batch is
   appended to a host-side write-ahead journal (rca/journal.py: fsync'd,
   crc-framed, O(delta)) BEFORE it is applied to the resident state, and
   the full resident state snapshots every N caller boundaries. Recovery
   = load the last snapshot + replay the journal suffix through the SAME
   mutation code path serving uses (``_apply_records`` /
   ``_apply_edge_records``), which reproduces row allocation, widths and
   the device tensors bit for bit (no kernel uses floating-point atomics)
   and is strictly cheaper than ``_rebuild()``.

2. **Deterministic fault injection.** rca/faults.py drives every stage of
   the tick from seeded schedules.

3. **Graceful-degradation ladder + watchdog.** Transient faults get
   bounded retry with seeded-jitter exponential backoff (the
   workflow/engine.RetryPolicy semantics); persistent ones walk the
   ladder: kernel fallback (the learned tick's tiers, streamed → fused →
   composed, which leave the resident state alike and serve the same
   top-1), pipeline fallback (depth N →
   depth 1, bit-identical), journal-replay recovery, on a graph-sharded
   mesh the live reshard around a persistently failed position
   (``mesh_heal``, rca/heal.py), full store-derived rebuild, and finally
   (learned scorer only) the rules scorer. Every
   transition is counted in observability/metrics.py and surfaced in the
   rescore() result. A finite guard rejects NaN/inf verdicts before they
   serve: the staged batch is journaled as quarantined and the tick
   replays from store-truth state.

Fault-stage semantics (what a bare retry may assume): ``staging``,
``journal_append``, ``snapshot_write`` and ``fetch`` faults leave the
resident state coherent (an empty re-tick re-serves it), so bounded retry
is sound. ``dispatch``/``pack``/``execute`` faults mean the drained deltas
or the resident tensors themselves are gone; every ladder step taken for
those is paired with a journal replay.

The snapshot pack and unpack (:func:`_snapshot_pack` /
:func:`_snapshot_unpack`) and the attestation fold (rca/heal.py) are torch
ops on the scorer's device; the tensors they move are the ones the hand
kernels read and write. On a mesh the pack gathers each table's blocks in
position order, the snapshot records the mesh shape it was captured at,
and the attestation folds each position's block where it lies.

**The mesh.** A shield around a scorer on a ``(1 x D)`` mesh classifies
shard-localized faults per position (``heal.ShardHealthTracker``); a
persistently failed position walks the ``mesh_heal`` rung, which reshards
onto the survivors of the shield's POOL of positions (``pool``, default
the scorer's platform's, ``parallel/mesh.device_pool``) at the largest
viable D'. After the cooldown the mesh re-expands to its home D, and
:meth:`ShieldedScorer.scale_mesh` is the elastic controller's load-driven
reshard through the same seam. All three journal a ``mesh_heal`` record
(``force_sync``) BEFORE they apply, so recovery lands on the journaled
shard count.
"""
from __future__ import annotations

import math
import os
import pickle
import threading
import time
import uuid

import numpy as np
import torch

from ..config import Settings, get_settings
from ..ingestion.admission import CircuitBreaker
from ..kernels import _build
from ..observability import get_logger
from ..observability import metrics as obs_metrics
from ..observability import scope as obs_scope
from ..workflow.engine import NonRetryableError, RetryPolicy
from .journal import DeltaJournal
from .streaming import NonFiniteDelta

log = get_logger("shield")

# fault stages after which the resident state is still coherent — see
# module docstring; everything else is state-suspect
_RETRIABLE_STAGES = frozenset(
    {"staging", "journal_append", "snapshot_write", "fetch"})

# the degradation ladder, in escalation order. The ``mesh_heal`` rung
# sits between journal replay and the full rebuild: once the per-shard
# classifier (rca/heal.ShardHealthTracker) has declared a mesh position
# persistently failed, replaying onto the SAME mesh is futile, and
# re-placing the state onto a survivor mesh at D' < D is cheaper than the
# store-derived rebuild
LADDER = ("kernel_fallback", "sync_depth1", "journal_replay", "mesh_heal",
          "full_rebuild", "rules_fallback")

# one int32 per element: float32 bit for bit, 16-bit floats through int16
# (sign-extended, truncated back on unpack), small ints and bool widened
_VIA_INT16 = (torch.bfloat16, torch.float16)
_WIDENED = (torch.int8, torch.uint8, torch.int16, torch.bool)


def _as_int32(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.float32:
        return t.contiguous().view(torch.int32).reshape(-1)
    if t.dtype == torch.int32:
        return t.reshape(-1)
    if t.dtype in _VIA_INT16:
        return t.contiguous().view(torch.int16).reshape(-1).to(torch.int32)
    if t.dtype in _WIDENED:
        return t.reshape(-1).to(torch.int32)
    raise TypeError(f"snapshot pack: no int32 layout for {t.dtype}")


def _snapshot_layout(tensors) -> tuple:
    """``((shape, dtype name), ...)`` of the tensors a pack carries (a
    table on a mesh by its whole shape): what :func:`_snapshot_unpack`
    needs to cut and reinterpret the flat buffer."""
    from ..parallel.compat import whole
    tensors = [whole(t) for t in tensors]
    return tuple((tuple(int(d) for d in t.shape),
                  str(t.dtype).removeprefix("torch."))
                 for t in tensors)


def _snapshot_pack(*tensors: torch.Tensor) -> torch.Tensor:
    """Pack the resident device tensors into ONE flat int32 tensor on their
    device, so a snapshot pays a single device→host copy however many
    tensors the scorer carries: float32 viewed as int32 bit for bit (NaN
    payloads included), bf16/f16 through int16, small ints and bool
    widened, everything raveled and concatenated. A table on a mesh
    (``parallel/compat.Sharded``) packs whole, its blocks gathered in
    position order onto its first position's device. For float32, int32
    and bool tensors this is the JAX package's ``_snapshot_pack`` buffer
    element for element."""
    from ..parallel.compat import whole
    return torch.cat([_as_int32(whole(t)) for t in tensors])


def _snapshot_unpack(flat: torch.Tensor, layout) -> list:
    """Inverse of :func:`_snapshot_pack`, bit-exact: ``layout`` is the
    :func:`_snapshot_layout` recorded at pack time. Each tensor is a fresh
    contiguous copy (the resident state is updated in place)."""
    out = []
    off = 0
    for shape, dt in layout:
        n = math.prod(shape)
        seg = flat[off:off + n]
        off += n
        dtype = getattr(torch, dt)
        if dtype == torch.float32:
            seg = seg.view(torch.float32)
        elif dtype in _VIA_INT16:
            seg = seg.to(torch.int16).view(dtype)
        else:
            seg = seg.to(dtype)
        out.append(seg.reshape(shape).clone())
    return out


class NonFiniteVerdict(RuntimeError):
    """The finite guard rejected a verdict fetch: serving NaN/inf to the
    workflow would poison hypotheses, approvals and remediation scoring
    downstream. Treated as state-suspect (the poison already reached the
    resident state), so recovery replays from store truth."""

    stage = "verdict"


class ShieldedScorer:
    """Fault-tolerance wrapper around a resident Streaming/GnnStreaming
    scorer: write-ahead journaling, periodic snapshots, watchdog, bounded
    retry and the degradation ladder. Unknown attributes delegate to the
    wrapped scorer, so the workflow worker and tests use it as a drop-in.

    Serving drivers must mutate the STORE and let the shield drain the
    store journal (``serve()``/``rescore()``/``tick()``/``sync()``): the
    write-ahead journal can only cover what flows through it; direct
    scorer mutation calls bypass durability.
    """

    def __init__(self, scorer, settings: "Settings | None" = None,
                 directory: "str | None" = None, injector=None,
                 pool=None) -> None:
        self.scorer = scorer
        self.settings = settings or get_settings()
        self.injector = injector
        # every kernel the scorer's tiers and the rules fallback can launch
        # is built and loaded now, so a build error raises here and never
        # walks the ladder
        self.kernels = prepare_kernels(scorer)
        scorer.fault_injector = injector
        scorer.finite_delta_guard = True
        scorer.make_replayable()
        d = directory or self.settings.shield_dir or os.path.join(
            ".kaeg_shield", str(os.getpid()))
        # flight-recorder dumps land next to the journal they explain
        # (unless the operator routed them elsewhere)
        self.flight_dir = (self.settings.scope_flight_dir
                           or os.path.join(d, "flight"))
        self.journal = DeltaJournal(
            d, fault_hook=injector.journal_hook if injector else None,
            fsync_every=self.settings.shield_wal_fsync_every_ticks)
        self.retry = RetryPolicy(
            max_attempts=max(int(self.settings.shield_retry_attempts), 0),
            initial_interval_s=float(self.settings.shield_retry_backoff_s),
            backoff=2.0, max_interval_s=5.0)
        self.snapshot_every = max(
            int(self.settings.shield_snapshot_every_ticks), 1)
        self.tick_timeout_s = float(self.settings.shield_tick_timeout_s)
        self._lock = threading.RLock()
        # store-lineage token: a snapshot only restores onto the store it
        # was captured from (stamped on the store object; files from a
        # different lineage are ignored and recovery falls back to rebuild)
        store = scorer.store
        tok = getattr(store, "_shield_epoch", None)
        if tok is None:
            tok = uuid.uuid4().hex
            store._shield_epoch = tok
        self._epoch = tok
        # observability / test surface
        self.tier = "steady"
        self.tier_log: list[str] = []
        self.snapshots = 0
        self.recoveries = 0
        self.replayed_records = 0
        self.quarantined_batches = 0
        self.watchdog_trips = 0
        self.last_recovery_seconds = 0.0
        self._journal_seconds = 0.0
        self._ticks_since_snapshot = 0
        # the next snapshot anchors a state re-derived from the store (a
        # rebuild or an edge re-mirror): see _force_anchor
        self._anchor_due = False
        self._last_batch = (0, 0)
        # the learned scorer that rules_fallback shed
        self._fallback_from = None
        self._snap_thread: "threading.Thread | None" = None
        self.last_capture_seconds = 0.0
        self.last_persist_seconds = 0.0
        # circuit breaker around device dispatch: bounded consecutive
        # dispatch-class failures open it; while open the NON-verdict
        # submission paths (tick()/absorb()) skip the device entirely (the
        # deltas wait in the store journal, whose cursor the skipped drain
        # never advanced, so crash recovery stays sound) and the half-open
        # probe after the cooldown re-walks the full path once. The
        # verdict boundary (rescore/serve) never consults it
        self.breaker = CircuitBreaker(
            "dispatch",
            failure_threshold=self.settings.breaker_failure_threshold,
            cooldown_s=self.settings.breaker_cooldown_s)
        self.breaker_skips = 0
        self._last_run_failures = 0
        self.attest_repairs = 0
        # shard-loss survival: per-position health and the live-reshard
        # bookkeeping. ``_pool`` is the list of positions the survivor
        # meshes are cut from (resolved on first use when not given);
        # ``_mesh_home`` the shard count to re-expand to; ``_mesh_excluded``
        # the pool indices currently healed AROUND; ``_heal_gen`` the
        # monotonic generation every journaled mesh_heal record carries
        # (compaction and replay key on it, as on params_swap)
        from .heal import ShardHealthTracker
        self.health = ShardHealthTracker(
            failure_threshold=self.settings.mesh_shard_failure_threshold,
            cooldown_s=self.settings.mesh_heal_cooldown_s)
        if pool is not None:
            from ..parallel.mesh import canonical_device
            pool = [canonical_device(d) for d in pool]
        self._pool = pool
        self._mesh_home = scorer._graph_size()
        self._mesh_excluded: tuple[int, ...] = ()
        self._heal_gen = 0
        self.heals = 0
        self.reexpansions = 0
        self.last_heal_seconds = 0.0
        self.scale_events = 0
        self.last_scale_seconds = 0.0

    @property
    def pool(self) -> list:
        """The positions survivor meshes are cut from: the pool given to
        the constructor, else the default pool of the scorer's platform
        (every card on CUDA, as JAX's ``jax.devices()``; the host
        positions on the CPU)."""
        if self._pool is None:
            from ..parallel.mesh import canonical_device, device_pool
            dev = canonical_device(self.scorer.device)
            self._pool = [canonical_device(d) for d in device_pool(dev)]
        return self._pool

    # -- delegation --------------------------------------------------------

    def __getattr__(self, name):
        try:
            scorer = object.__getattribute__(self, "scorer")
        except AttributeError:
            raise AttributeError(name) from None
        return getattr(scorer, name)

    # -- protected serving API --------------------------------------------

    def serve(self, newest: bool = False) -> dict:
        """Journal + sync + rescore under the shield lock. Callers are
        serialized here (the shield must observe every failure), so each
        caller's prior store writes are drained by its own staging pass.
        ``newest=True`` (the workflow's verdict path) prefers the scorer's
        deferred newest-tick fetch; the finite guard runs on the fetched
        result either way."""
        return self.rescore(newest=newest)

    def rescore(self, newest: bool = False) -> dict:
        with self._lock:
            self._maybe_reexpand()
            if newest:
                return self._run_with_recovery(
                    lambda: self._tick_rescore(newest=True))
            return self._run_with_recovery(self._tick_rescore)

    def tick(self) -> dict:
        """Protected pipelined submission (scorer.tick_async), behind the
        dispatch circuit breaker: while open, the submission is skipped
        outright and the deltas stay in the store journal for the
        half-open probe (or any verdict-boundary call) to drain."""
        with self._lock:
            self._maybe_reexpand()
            if not self.breaker.allow():
                return self._breaker_skip()
            try:
                out = self._run_with_recovery(self._tick_async)
            except (RuntimeError, OSError) as exc:
                if self.breaker.state == "open":
                    # the ladder exhausted AND the breaker just opened: the
                    # ingest path degrades to journal-only instead of
                    # surfacing a timeout per webhook
                    log.error("tick_degraded_breaker_open", error=str(exc))
                    return {"dispatched": False, "breaker_open": True,
                            "error": str(exc)}
                raise
            if self._last_run_failures == 0:
                # a clean pass closes a half-open probe / resets the
                # consecutive-failure count; a pass that only succeeded
                # through recovery leaves the breaker where it was
                self.breaker.record_success()
            return out

    def _breaker_skip(self) -> dict:
        self.breaker_skips += 1
        return {"dispatched": False, "breaker_open": True,
                "backlog": int(self.scorer._journal_backlog())}

    def absorb(self) -> dict:
        """Protected webhook-burst ingestion: WAL-journal + apply the delta
        batch, then a pipelined tick submission. MUST shadow the scorer's
        absorb(): a ``__getattr__`` fallthrough would drain the store
        journal without write-ahead logging it."""
        return self.tick()

    def swap_params(self, params, source: str = "") -> int:
        """Hot checkpoint swap, WAL-journaled BEFORE it is applied (the
        same order as delta batches). MUST shadow the scorer's
        swap_params: a fallthrough would swap without a journal record and
        recovery would replay post-swap deltas onto the pre-swap
        generation. The record carries the params leaves themselves, so
        replay restores the exact swapped values without a checkpoint
        file. Returns the new generation."""
        with self._lock:
            s = self.scorer
            gen = int(getattr(s, "params_generation", 0)) + 1
            seq = int(s._synced_seq)
            self.journal.append((), seq, seq, kind="params_swap",
                                force_sync=True, generation=gen,
                                leaves=_host_leaves(params), source=source)
            s.swap_params(params, generation=gen, source=source)
            obs_scope.FLIGHT_RECORDER.note_event(
                "params_swap_journaled", generation=gen, seq=seq)
            return gen

    def rollback_params(self) -> "int | None":
        """Journaled rollback to the previous generation. The restored
        params are re-journaled as a fresh swap record so replay ordering
        stays monotonic (the rollback applies first so the record holds
        the exact restored leaves; a crash in the gap replays the
        pre-rollback swap, and the guard that triggered the rollback
        fires again)."""
        with self._lock:
            s = self.scorer
            prev = getattr(s, "_params_prev", None)
            if prev is None:
                return None
            gen = s.rollback_params()
            if gen is None:
                return None
            seq = int(s._synced_seq)
            self.journal.append((), seq, seq, kind="params_swap",
                                force_sync=True, generation=gen,
                                leaves=_host_leaves(s._params),
                                source=prev[2], rollback=True)
            return gen

    def _replay_params_swap(self, batch) -> None:
        """Apply one WAL ``params_swap`` record during recovery: newer
        generations than the restored state re-install their exact
        leaves; older ones are already in the snapshot."""
        from .gnn import flat_params, unflat_params
        s = self.scorer
        gen = int(batch.meta.get("generation", 0))
        if gen <= int(getattr(s, "params_generation", 0)):
            return
        keys = list(flat_params(s._params))
        params = unflat_params(dict(zip(keys, batch.meta["leaves"])))
        s._swap_params_locked(params, gen,
                              source=batch.meta.get("source", ""))

    def sync(self) -> dict:
        """Journal + apply only (no dispatch), for drivers that tick
        elsewhere."""
        with self._lock:
            return self._run_with_recovery(self._stage_and_apply)

    # -- the guarded tick --------------------------------------------------

    def _tick_rescore(self, newest: bool = False) -> dict:
        self._stage_and_apply()
        out = (self.scorer.rescore_newest() if newest
               else self.scorer.rescore())
        self._finite_guard(out)
        self._ticks_since_snapshot += 1
        if self._ticks_since_snapshot >= self.snapshot_every:
            self.snapshot_now(background=True)
        # recovery visibility in the rescore timing splits
        out["shield_tier"] = self.tier
        out["journal_seconds"] = self._journal_seconds
        out["recovery_seconds"] = self.last_recovery_seconds
        out["recoveries"] = self.recoveries
        out["quarantined_batches"] = self.quarantined_batches
        out["watchdog_trips"] = self.watchdog_trips
        return out

    def _tick_async(self) -> dict:
        self._stage_and_apply()
        out = self.scorer.tick_async()
        self._ticks_since_snapshot += 1
        if self._ticks_since_snapshot >= self.snapshot_every:
            self.snapshot_now(background=True)
        return out

    def _stage_and_apply(self) -> dict:
        """Drain the store journal, write-ahead the batch (BEFORE any
        state mutation: the crash-consistency invariant), then apply it
        through the scorer's mutation path."""
        s = self.scorer
        if self.injector is not None:
            self.injector.at("staging", s)
        recs, seq, truncated = s.store.journal_since(s._synced_seq)
        if truncated:
            # the bounded store journal evicted unseen records: only a
            # store-derived rebuild is sound (same fallback as sync())
            self._transition("full_rebuild")
            s._rebuild()
            obs_metrics.SHIELD_RECOVERIES.inc(mode="full_rebuild")
            self.recoveries += 1
            self._force_anchor()
            s.syncs += 1
            return {"applied": 0, "rebuilt": True}
        lo = s._synced_seq
        if recs:
            t0 = time.perf_counter()
            nbytes = self.journal.append(recs, lo, seq)
            self._journal_seconds = time.perf_counter() - t0
            obs_metrics.SHIELD_JOURNAL_BYTES.inc(float(nbytes))
        self._last_batch = (lo, seq)
        mirrors = getattr(s, "mirror_builds", 0)
        res = s._apply_records(recs)
        s.syncs += 1
        if res.get("rebuilt"):
            # _init_from_store re-derived everything from the store and
            # advanced the cursors past this batch; the pre-rebuild
            # snapshot is stale: refresh at the next boundary
            self._force_anchor()
            return res
        s._synced_seq = max(seq, s._synced_seq)
        if hasattr(s, "_apply_edge_records"):
            s._apply_edge_records(recs)
            s._gnn_seq = max(seq, s._gnn_seq)
            if s.mirror_builds != mirrors:
                # a region overflowed and the edge mirror was rebuilt from
                # the store as it is NOW: a later replay of this batch
                # would read a later store and lay the edges out another
                # way, so anchor a snapshot past it at the next boundary
                self._force_anchor()
        return res

    def _finite_guard(self, out: dict) -> None:
        for k in ("probs", "scores", "top_score", "top_confidence"):
            v = out.get(k)
            if v is None:
                continue
            a = np.asarray(v)
            if a.dtype.kind == "f" and not np.isfinite(a).all():
                obs_metrics.SHIELD_NONFINITE_VERDICTS.inc(path="shield")
                raise NonFiniteVerdict(f"non-finite verdict field {k!r}")

    # -- failure handling: retry + degradation ladder ----------------------

    # a guarded call walks the ladder at most this many times before the
    # failure surfaces: a fault persisting through repeated recoveries,
    # rebuilds and (learned) the rules fallback is an outage, not a blip
    MAX_LADDER_ROUNDS = 3

    def _run_with_recovery(self, fn):
        """Run one guarded operation; failures walk the bounded-retry +
        degradation ladder until the operation succeeds or the ladder is
        exhausted. The watchdog checks the successful path's wall time."""
        state = {"applied": set(), "rounds": 0, "failures": 0}
        while True:
            t0 = time.perf_counter()
            try:
                out = fn()
            except Exception as exc:
                state["failures"] += 1
                self._escalate(exc, state)
                continue
            self._watchdog(time.perf_counter() - t0)
            self._last_run_failures = state["failures"]
            if state["failures"] == 0:
                # a CLEAN pass, not one that limped through recovery:
                # transient shard faults reset and half-open probes close
                # (the transient/persistent line the classifier draws)
                self.health.record_clean_pass()
            if state["failures"] and self.tier not in ("rules_fallback",
                                                       "breaker_open"):
                self.tier = "steady"
                self.scorer._scope_tier = "steady"
            return out

    def _escalate(self, exc: Exception, state: dict) -> None:
        """Pick and apply the next ladder step for this failure. Raises
        when the error is non-retryable (programming errors must surface,
        not degrade) or the ladder rounds are exhausted."""
        if isinstance(exc, (ValueError, TypeError, NonRetryableError,
                            _build.KernelError)):
            raise exc
        stage = getattr(exc, "stage", "")
        suspect = stage not in _RETRIABLE_STAGES
        shard = getattr(exc, "shard", None)
        if shard is not None:
            # the fault is localized to ONE mesh position: N consecutive
            # failures there open its breaker, which turns the ladder from
            # replay to mesh_heal
            self.health.record_failure(int(shard))
        if stage in ("dispatch", "execute", "pack", ""):
            # dispatch-class (or unattributed device-path) failure feeds
            # the circuit breaker; crossing the consecutive-failure
            # threshold opens it and becomes a visible shield tier
            was_open = self.breaker.state == "open"
            self.breaker.record_failure()
            if self.breaker.state == "open" and not was_open:
                self._transition("breaker_open")
        log.warning("guarded_tick_failed", stage=stage or "unknown",
                    error=str(exc), failures=state["failures"],
                    suspect=suspect)
        # forensic interleave: the failure lands in the flight ring at its
        # arrival order, so a dump shows what surrounded the fault
        obs_scope.FLIGHT_RECORDER.note_event(
            "guarded_tick_failed", stage=stage or "unknown",
            error=f"{type(exc).__name__}: {str(exc)[:200]}",
            failures=state["failures"], suspect=suspect)
        if isinstance(exc, (NonFiniteVerdict, NonFiniteDelta)):
            # NonFiniteDelta: poison caught at the dispatch boundary
            # before the copy; NonFiniteVerdict: the backstop at the fetch
            # boundary (e.g. silent device corruption). Both quarantine
            # the offending batch: replay serves store truth
            lo, hi = self._last_batch
            self.journal.mark_quarantined(lo, hi, reason=str(exc))
            self.quarantined_batches += 1
            obs_metrics.SHIELD_QUARANTINED_DELTAS.inc()
            obs_scope.FLIGHT_RECORDER.note_event(
                "quarantined", seq_lo=lo, seq_hi=hi,
                reason=str(exc)[:200])
        if isinstance(exc, NonFiniteVerdict) and \
                getattr(self.scorer, "_params_prev", None) is not None:
            # non-finite verdicts right after a hot checkpoint swap indict
            # the FRESHEST config change first: roll the swap back
            # (journaled, one-deep) and retry on the restored generation
            # before walking the heavier ladder
            if self.rollback_params() is not None:
                self._transition("params_rollback")
                return
        if not suspect and state["failures"] <= self.retry.max_attempts:
            # transient, state coherent: bounded retry with seeded-jitter
            # backoff (key = store lineage + batch)
            self._transition("retry")
            time.sleep(self.retry.delay(
                state["failures"],
                key=f"{self._epoch}:{self._last_batch[1]}"))
            return
        applied = state["applied"]
        while True:
            for step in LADDER:
                if step in applied:
                    continue
                applied.add(step)
                if self._apply_ladder_step(step, suspect):
                    return
            # every rung tried this round: a dense fault schedule may
            # outlast one pass (recoveries restore a consistent state, so
            # re-walking the ladder is sound), but only boundedly
            state["rounds"] += 1
            if state["rounds"] >= self.MAX_LADDER_ROUNDS:
                raise exc
            applied.clear()

    def _apply_ladder_step(self, step: str, suspect: bool) -> bool:
        """Apply one degradation rung; False = not applicable here (or
        recovery unavailable), the caller escalates to the next rung.
        State-suspect failures pair every configuration-only rung with a
        journal replay: no configuration change can restage lost deltas."""
        if step == "kernel_fallback":
            # the learned tick's tiers, top down: streamed (B4) → fused
            # (B3) → composed (B2 per layer). They update the resident
            # state alike and serve the same top-1 (on the card the fused
            # chain rounds its probs within ~2.4e-7 of the composed
            # tick's); a quantized table degrades with its tier to the
            # float32 verdict. Below the composed tick there is no rung: a
            # kernel's plain version never serves on the card
            s = self.scorer
            if getattr(s, "_use_dma", False):
                s._use_dma = False
            elif getattr(s, "_use_fused", False):
                s._use_fused = False
            else:
                return False
            self._transition(step)
            if suspect:
                self._try_recover()
            return True
        if step == "sync_depth1":
            if self.scorer.pipeline_depth <= 1:
                return False
            # depth parity is bit-identical: dropping to the serialized
            # loop narrows the blast radius of device faults to one tick
            self.scorer.pipeline_depth = 1
            self.scorer._supersede_inflight()
            self._transition(step)
            if suspect:
                self._try_recover()
            return True
        if step == "journal_replay":
            if self._heal_ready() is not None:
                # a position is CLASSIFIED persistently failed: replaying
                # the same state onto it is futile, the mesh_heal rung
                # takes over
                return False
            self._transition(step)
            return self._try_recover()
        if step == "mesh_heal":
            pos = self._heal_ready()
            if pos is None:
                return False
            self._transition(step)
            return self._try_heal(pos)
        if step == "full_rebuild":
            self._transition(step)
            self.scorer._rebuild()
            obs_metrics.SHIELD_RECOVERIES.inc(mode="full_rebuild")
            self.recoveries += 1
            self._force_anchor()
            return True
        if step == "rules_fallback":
            if not self._engage_rules_fallback():
                return False
            self._transition(step)
            return True
        return False

    def _try_recover(self) -> bool:
        """Journal-replay recovery as a ladder step: a failure here (bad
        snapshot, injected fault mid-recovery) reports False so the caller
        escalates to the deeper tiers instead of wedging."""
        try:
            self.recover()
            return True
        except (RuntimeError, OSError, KeyError, pickle.PickleError) as exc:
            log.error("recovery_failed", error=str(exc))
            return False

    # -- live resharding and re-expansion ----------------------------------

    def _heal_enabled(self) -> bool:
        return bool(self.settings.mesh_heal_enabled)

    def _heal_ready(self) -> "int | None":
        """The mesh position the classifier declared persistently failed,
        or None (nothing classified, heal disabled, or not graph-sharded:
        the replay and rebuild rungs apply as they are)."""
        if not self._heal_enabled() or self.scorer._graph_size() <= 1:
            return None
        return self.health.failed_position()

    def _try_heal(self, pos: int) -> bool:
        """The mesh_heal rung: a heal that fails (no survivor layout, a
        placement error) reports False so the ladder escalates to the
        full rebuild instead of wedging."""
        try:
            self.mesh_heal(positions=(int(pos),))
            return True
        except (RuntimeError, OSError, ValueError) as exc:
            if isinstance(exc, _build.KernelError):
                raise
            log.error("mesh_heal_failed", error=str(exc))
            obs_scope.FLIGHT_RECORDER.note_event(
                "mesh_heal_failed", error=str(exc)[:200])
            return False

    def _survivors(self, excluded: tuple[int, ...]) -> int:
        return len(self.pool) - len(excluded)

    def _survivor_mesh(self, shards: int, excluded: tuple[int, ...]):
        """The survivor mesh of ``shards`` positions from the pool less
        ``excluded``, checked before anything is journaled or adopted:
        None for one shard, which serves on the scorer's own device, so
        that device must be a survivor's (a heal never moves the serving
        state to another platform). Raises RuntimeError when the
        survivors cannot carry it."""
        from . import heal as heal_mod
        from ..parallel.mesh import canonical_device
        mesh = heal_mod.survivor_mesh(shards, excluded, self.pool)
        if mesh is None and shards > 1:
            raise RuntimeError(f"no survivor mesh of {shards} positions in "
                               f"a pool of {len(self.pool)} less "
                               f"{len(excluded)} excluded")
        if mesh is None:
            live = [d for i, d in enumerate(self.pool) if i not in excluded]
            if canonical_device(self.scorer.device) not in live:
                raise RuntimeError(
                    f"no survivor position on {self.scorer.device} to "
                    "serve one shard")
        return mesh

    def _journal_mesh(self, shards: int, excluded: tuple[int, ...],
                      d_old: int, **meta) -> int:
        """Write-ahead a ``mesh_heal`` record (forced to disk) BEFORE the
        reshard applies; returns its generation."""
        s = self.scorer
        seq = int(s._synced_seq)
        self._heal_gen += 1
        self.journal.append((), seq, seq, kind="mesh_heal", force_sync=True,
                            shards=shards, exclude=tuple(excluded),
                            from_shards=d_old, heal_gen=self._heal_gen,
                            **meta)
        return self._heal_gen

    def mesh_heal(self, positions: tuple[int, ...] = (),
                  exclude_devices: tuple[int, ...] = ()) -> dict:
        """Live D → D' resharding around failed positions: journal the heal
        FIRST (forced to disk, the order of delta batches and params
        swaps), then re-place the resident state onto a survivor mesh at
        the largest viable D' (``heal.plan_reshard``), under
        ``serve_lock``. ``positions`` are CURRENT mesh positions (the
        classifier's verdicts, translated to pool indices here since
        positions shift with every reshard); callers that know the dead
        pool index pass ``exclude_devices``. Forces the next snapshot.
        Returns the plan. Raises RuntimeError when no position survives."""
        from . import heal as heal_mod
        s = self.scorer
        t0 = time.perf_counter()
        with s.serve_lock:
            d_old = s._graph_size()
            dead = {int(i) for i in exclude_devices}
            for pos in positions:
                if s.mesh is not None and 0 <= int(pos) < s.mesh.size:
                    dead.add(heal_mod.device_index(s.mesh, int(pos)))
            excluded = tuple(sorted(set(self._mesh_excluded) | dead))
            survivors = self._survivors(excluded)
            if survivors < 1:
                raise RuntimeError(f"mesh heal: every position of the "
                                   f"pool of {len(self.pool)} is excluded")
            d_new = heal_mod.plan_reshard(s.snapshot.padded_nodes, d_old,
                                          survivors)
            mesh = self._survivor_mesh(d_new, excluded)
            heal_gen = self._journal_mesh(d_new, excluded, d_old)
            old_mesh = s.mesh
            s.adopt_mesh(mesh)
            self._mesh_excluded = excluded
        for pos in positions:
            if old_mesh is not None and 0 <= int(pos) < old_mesh.size:
                self.health.exclude(int(pos), heal_mod.device_index(
                    old_mesh, int(pos)))
        self.heals += 1
        self.last_heal_seconds = time.perf_counter() - t0
        obs_metrics.MESH_HEALS.inc()
        obs_metrics.MESH_SERVING_SHARDS.set(float(max(d_new, 1)))
        obs_scope.FLIGHT_RECORDER.note_event(
            "mesh_heal", from_shards=d_old, to_shards=d_new,
            excluded=list(excluded), heal_gen=heal_gen)
        # the on-disk snapshot carries the OLD mesh shape, and the state
        # was re-derived from the host mirrors: anchor a fresh one
        self._force_anchor()
        log.warning("mesh_healed", from_shards=d_old, to_shards=d_new,
                    excluded=excluded,
                    seconds=round(self.last_heal_seconds, 4))
        return {"from_shards": d_old, "shards": d_new,
                "excluded": excluded, "heal_gen": heal_gen}

    def _maybe_reexpand(self) -> None:
        """Half-open probe gate: once every excluded index's breaker has
        cooled down, grow D' back to the home mesh. The probe IS the next
        guarded tick: a clean pass closes the probing breakers; one more
        shard-localized failure re-opens and re-heals at once."""
        if (self._mesh_excluded and self._heal_enabled()
                and self.health.can_reexpand()):
            self.reexpand()

    def reexpand(self) -> "dict | None":
        """Grow D' → D (the home shard count) when the excluded positions
        return: in-flight ticks are superseded, journaled exactly like
        the heal. Forces the next snapshot. Returns the plan, or None when
        nothing is excluded."""
        from . import heal as heal_mod
        s = self.scorer
        with s.serve_lock:
            if not self._mesh_excluded:
                return None
            d_old = s._graph_size()
            d_new = self._mesh_home
            mesh = self._survivor_mesh(d_new, ())
            heal_gen = self._journal_mesh(d_new, (), d_old, reexpand=True)
            s.adopt_mesh(mesh)
            excluded, self._mesh_excluded = self._mesh_excluded, ()
        dev_to_pos = ({} if mesh is None else
                      {heal_mod.device_index(mesh, p): p
                       for p in range(mesh.size)})
        self.health.note_reexpanded(dev_to_pos)
        self.reexpansions += 1
        obs_metrics.MESH_REEXPANSIONS.inc()
        obs_metrics.MESH_SERVING_SHARDS.set(float(max(d_new, 1)))
        obs_scope.FLIGHT_RECORDER.note_event(
            "mesh_reexpand", from_shards=d_old, to_shards=d_new,
            probed=list(excluded), heal_gen=heal_gen)
        self._force_anchor()
        log.warning("mesh_reexpanded", from_shards=d_old, to_shards=d_new,
                    probed=excluded)
        return {"from_shards": d_old, "shards": d_new,
                "probed": excluded, "heal_gen": heal_gen}

    def scale_mesh(self, target_shards: int) -> "dict | None":
        """Load-driven D → D' reshard through the heal's seam: journaled
        first (recovery replays it as one more ``mesh_heal`` record), then
        ``adopt_mesh``, keeping the excluded positions out of the new
        layout. Moves the home shard count too, so a later heal and
        re-expansion return to the load-chosen D'. Raises ValueError for
        a target the node bucket does not divide (or below 1) and
        RuntimeError for one the non-excluded pool cannot carry. Returns
        the plan, or None when already at the target."""
        s = self.scorer
        d_target = int(target_shards)
        t0 = time.perf_counter()
        with s.serve_lock:
            d_old = s._graph_size()
            if d_target == d_old:
                return None
            excluded = self._mesh_excluded
            if d_target < 1 or s.snapshot.padded_nodes % d_target:
                raise ValueError(
                    f"scale target {d_target} does not divide "
                    f"padded_nodes={s.snapshot.padded_nodes}")
            survivors = self._survivors(excluded)
            if d_target > survivors:
                raise RuntimeError(
                    f"scale target {d_target} exceeds {survivors} "
                    "non-excluded positions")
            mesh = self._survivor_mesh(d_target, excluded)
            heal_gen = self._journal_mesh(d_target, excluded, d_old,
                                          scale=True)
            s.adopt_mesh(mesh)
            self._mesh_home = d_target
        direction = "up" if d_target > d_old else "down"
        self.scale_events += 1
        self.last_scale_seconds = time.perf_counter() - t0
        obs_metrics.MESH_SCALE_EVENTS.inc(direction=direction)
        obs_metrics.MESH_SERVING_SHARDS.set(float(max(d_target, 1)))
        obs_scope.FLIGHT_RECORDER.note_event(
            "mesh_scale", from_shards=d_old, to_shards=d_target,
            direction=direction, heal_gen=heal_gen)
        self._force_anchor()
        log.warning("mesh_scaled", from_shards=d_old, to_shards=d_target,
                    direction=direction,
                    seconds=round(self.last_scale_seconds, 4))
        return {"from_shards": d_old, "shards": d_target,
                "direction": direction, "heal_gen": heal_gen}

    def _attest_and_repair(self) -> tuple[int, ...]:
        """State attestation at a snapshot boundary (rca/heal.attest_fold
        on the device vs the host-truth oracle ``attest_host``): SILENT
        corruption, the class the finite guard can only catch after it
        serves a wrong verdict, is detected here, localized to its shard
        block and repaired by re-uploading exactly the mismatched blocks
        from the host mirrors (never a whole-state rebuild). On a
        graph-sharded mesh each position folds its own block on its own
        device (``g`` blocks); otherwise the table folds as one block.
        Caller holds ``serve_lock``. Returns the mismatched shard
        positions; each one also feeds the shard-loss classifier
        (recurring silent corruption on one position is a failing
        device)."""
        if not self.settings.mesh_attest:
            return ()
        from ..parallel import compat
        from ..parallel.compat import Sharded
        from ..parallel.mesh import graph_sharded
        from . import heal as heal_mod
        s = self.scorer
        if len(s._pending_feat):
            # staged-but-undrained deltas mean the host mirrors are
            # LEGITIMATELY ahead of the device: attest at the next
            # drained boundary instead
            return ()
        pairs = s._attest_arrays()
        g = max(s._graph_size(), 1) if s._graph_sharded(
            s.snapshot.padded_nodes, s.snapshot.padded_incidents) else 1

        tables = [getattr(s, attr) for attr, _host in pairs]

        def fold(t):
            """The table's ``g`` block sums in position order, on the
            first position's device: a graph-sharded table folds each
            block at its own position (on its stream) and gathers them
            in order; any other folds the ``g`` row blocks of its first
            copy where it lies."""
            if isinstance(t, Sharded) and t.placement.axis == "graph":
                sums = compat.run(
                    t.mesh, lambda p, b: heal_mod.attest_fold(
                        b, shards=1)[0], t, where=lambda p: p.dp == 0)
                return compat.whole(Sharded(graph_sharded(t.mesh), sums))
            first = t.blocks.ravel()[0] if isinstance(t, Sharded) else t
            rows = first.shape[0] // g
            return torch.cat([heal_mod.attest_fold(
                first[k * rows:(k + 1) * rows], shards=1)[0]
                for k in range(g)])

        with s._on_stream():
            # the [arrays, g] sums gather on the first position and reach
            # the host in one copy
            folds = [fold(t) for t in tables]
            home = folds[0].device
            dev = torch.stack([f.to(home) for f in folds]).cpu().numpy()
        host = heal_mod.attest_host([h for _a, h in pairs], g)
        mismatch = dev != host                     # [arrays, shards]
        bad = tuple(int(k) for k in np.flatnonzero(mismatch.any(axis=0)))
        if not bad:
            return ()
        with s._on_stream():
            for ai, (_attr, truth) in enumerate(pairs):
                truth = np.asarray(truth)
                rows = truth.shape[0] // g
                t = tables[ai]
                for k in bad:
                    if not mismatch[ai, k]:
                        continue
                    block = torch.from_numpy(np.ascontiguousarray(
                        truth[k * rows:(k + 1) * rows]))
                    if not isinstance(t, Sharded):
                        view = t[k * rows:(k + 1) * rows]
                        view.copy_(block.to(device=view.device,
                                            dtype=view.dtype))
                        continue
                    # every copy of the block (dp replicas), each
                    # rewritten at its position, on its stream
                    whole_blocks = t.placement.axis == "graph"

                    def put(p, b, block=block, k=k):
                        view = b if whole_blocks else \
                            b[k * rows:(k + 1) * rows]
                        view.copy_(block.to(device=view.device,
                                            dtype=view.dtype))

                    compat.run(t.mesh, put, t, where=(
                        lambda p, k=k: p.graph == k) if whole_blocks
                        else None)
        self.attest_repairs += 1
        for k in bad:
            obs_metrics.MESH_ATTEST_MISMATCH.inc(shard=str(k))
            self.health.record_failure(k)
        obs_metrics.MESH_ATTEST_REPAIRS.inc()
        obs_scope.FLIGHT_RECORDER.note_event(
            "attest_repair", shards=list(bad),
            arrays=[a for ai, (a, _h) in enumerate(pairs)
                    if mismatch[ai].any()])
        log.warning("attest_repaired_shards", shards=bad)
        return bad

    def _watchdog(self, elapsed_s: float) -> None:
        if not self.tick_timeout_s or elapsed_s <= self.tick_timeout_s:
            return
        # a launched kernel cannot be cancelled from the host: the
        # watchdog bounds RECURRENCE — count the trip and drop to the
        # serialized depth-1 loop so at most one tick is ever exposed to a
        # slow or wedged device
        self.watchdog_trips += 1
        obs_metrics.SHIELD_WATCHDOG_TRIPS.inc()
        log.warning("watchdog_trip", elapsed_s=round(elapsed_s, 3),
                    timeout_s=self.tick_timeout_s)
        if self.scorer.pipeline_depth > 1:
            self.scorer.pipeline_depth = 1
            self.scorer._supersede_inflight()
            self._transition("sync_depth1")

    def _engage_rules_fallback(self) -> bool:
        """Last functional tier for a learned scorer that cannot be
        revived: serve rules verdicts from a fresh StreamingScorer over the
        same store, on the same device (shared result fields:
        top_rule_index / any_match / top_confidence). The faulting scorer
        is shed; the injector does NOT follow: the fallback must serve."""
        from .gnn_streaming import GnnStreamingScorer
        from .streaming import StreamingScorer
        if not isinstance(self.scorer, GnnStreamingScorer):
            return False
        old = self.scorer
        fallback = StreamingScorer(old.store, self.settings, now_s=old.now_s,
                                   device=old.device)
        fallback.finite_delta_guard = True
        self._fallback_from = old
        self.scorer = fallback
        self._force_anchor()
        log.error("rules_fallback_engaged")
        return True

    def _transition(self, tier: str) -> None:
        self.tier = tier
        self.tier_log.append(tier)
        obs_metrics.SHIELD_TIER_TRANSITIONS.inc(tier=tier)
        # stamp the tier onto the scorer (every later TickSpan carries it)
        # and freeze the flight ring to disk: the forensic window AROUND
        # the degradation, not just its counter
        self.scorer._scope_tier = tier
        obs_scope.FLIGHT_RECORDER.dump(f"tier:{tier}", self.flight_dir)

    # -- snapshots + recovery ---------------------------------------------

    def snapshot_now(self, background: bool = False) -> int:
        """Capture the full resident state (host bookkeeping + the packed
        device tensors, ONE device→host copy) and persist it atomically,
        then compact the WAL to the uncovered suffix.

        The CAPTURE is synchronous under ``serve_lock``: the pack runs on
        the scorer's stream after its in-flight ticks, and the copy to the
        host completes before anything else sees the buffer. With
        ``background=True`` (the cadence path) the persist (write + fsync
        + rename + compact) runs on a writer thread while serving
        continues; recovery and the next snapshot join it first. Returns
        bytes written (0 when deferred to the writer thread)."""
        self._join_snapshot_writer()
        s = self.scorer
        t0 = time.perf_counter()
        with s.serve_lock:
            # attest BEFORE the capture: silently corrupted state must be
            # localized and repaired from host truth here, never persisted
            # into the recovery anchor
            self._attest_and_repair()
            arrays = s._resident_arrays()
            with s._on_stream():
                layout = _snapshot_layout(arrays)
                flat = _snapshot_pack(*arrays).cpu().numpy()
            host = pickle.dumps(s.capture_host_state(),
                                protocol=pickle.HIGHEST_PROTOCOL)
            store_seq = int(s._synced_seq)
            mesh_shards = s._graph_size()
        self.last_capture_seconds = time.perf_counter() - t0
        state = {"epoch": self._epoch, "store_seq": store_seq,
                 "klass": type(s).__name__, "layout": layout,
                 "flat": flat, "host": host,
                 # the generation this snapshot serves: compaction drops
                 # only the swap records the snapshot already reflects
                 "params_gen": int(getattr(s, "params_generation", 0)),
                 # the mesh shape the packed tensors were captured AT:
                 # recovery re-points the mesh before adopting them, and
                 # compaction drops only the heal records this snapshot
                 # already reflects (the params_swap discipline)
                 "mesh_shards": int(mesh_shards),
                 "mesh_exclude": tuple(self._mesh_excluded),
                 "mesh_home": int(self._mesh_home),
                 "heal_gen": int(self._heal_gen)}
        self.snapshots += 1
        self._ticks_since_snapshot = 0
        anchor, self._anchor_due = self._anchor_due, False
        obs_metrics.SHIELD_SNAPSHOTS.inc()
        if background:
            self._snap_thread = threading.Thread(
                target=self._persist_snapshot, args=(state, t0, anchor),
                name="kaeg-shield-snapshot", daemon=False)
            self._snap_thread.start()
            return 0
        return self._persist_snapshot(state, t0, anchor)

    def _persist_snapshot(self, state: dict, t0: float,
                          anchor: bool = False) -> int:
        t1 = time.perf_counter()
        for attempt in range(2 if anchor else 1):
            try:
                nbytes = self.journal.write_snapshot(state)
                self.journal.compact(state["store_seq"],
                                     through_params_gen=state["params_gen"],
                                     through_heal_gen=state["heal_gen"])
                break
            except (OSError, RuntimeError) as exc:
                # a failed persist leaves the previous snapshot intact; the
                # next cadence (or a recovery-time rebuild) covers the gap.
                # An anchor is tried once more at once, then again at the
                # next boundary (_force_anchor)
                log.error("snapshot_persist_failed", error=str(exc),
                          attempt=attempt + 1)
        else:
            if anchor:
                self._force_anchor()
            return 0
        self.last_persist_seconds = time.perf_counter() - t1
        log.info("snapshot_written", bytes=nbytes,
                 store_seq=state["store_seq"])
        return nbytes

    def _force_anchor(self) -> None:
        """Snapshot at the next boundary, and make that snapshot land: the
        state was re-derived from the store as it is now (a rebuild, a
        rules fallback, an edge re-mirror), which a replay from an older
        snapshot would re-derive from a later store, laid out another way.
        The JAX package forces the snapshot after a rebuild and waits for
        the cadence when its persist fails; here an anchor's persist is
        tried once more at once and, failing that, at the next boundary,
        and an edge re-mirror forces one too."""
        self._ticks_since_snapshot = self.snapshot_every
        self._anchor_due = True

    def _join_snapshot_writer(self) -> None:
        t = self._snap_thread
        if t is not None and t.is_alive():
            t.join()

    def recover(self) -> dict:
        """Load the last durable snapshot and replay the journal suffix:
        bit-identical to the pre-fault state, strictly cheaper than a
        rebuild. Falls back to the store-derived ``_rebuild()`` when no
        snapshot of this store lineage exists."""
        self._join_snapshot_writer()
        t0 = time.perf_counter()
        s = self.scorer
        state = self.journal.load_snapshot()
        if (state is None or state.get("epoch") != self._epoch
                or state.get("klass") != type(s).__name__):
            s._rebuild()
            dt = time.perf_counter() - t0
            self.recoveries += 1
            self.last_recovery_seconds = dt
            self._force_anchor()
            obs_metrics.SHIELD_RECOVERIES.inc(mode="full_rebuild")
            log.warning("recovered_via_rebuild", seconds=round(dt, 4))
            obs_scope.FLIGHT_RECORDER.dump("recovery:full_rebuild",
                                           self.flight_dir)
            return {"mode": "full_rebuild", "replayed": 0, "seconds": dt}
        replayed = 0
        with s.serve_lock:
            # the packed tensors were captured at the snapshot's mesh
            # shape: re-point the mesh BEFORE adopting them, so they are
            # placed at the layout they carry (a crash between a heal and
            # its covering snapshot restores here, then replays the heal
            # record below)
            snap_shards = int(state.get("mesh_shards", s._graph_size()))
            snap_excl = tuple(state.get("mesh_exclude", ()))
            self._heal_gen = int(state.get("heal_gen", self._heal_gen))
            self._mesh_home = int(state.get("mesh_home", self._mesh_home))
            if (snap_shards != s._graph_size()
                    or snap_excl != self._mesh_excluded):
                s.mesh = self._survivor_mesh(snap_shards, snap_excl)
                self._mesh_excluded = snap_excl
            s.restore_host_state(pickle.loads(state["host"]))
            with s._on_stream():
                flat = torch.from_numpy(state["flat"]).to(s.device)
                s._adopt_resident(_snapshot_unpack(flat, state["layout"]))
            batches, torn = self.journal.read()
            rb0 = s.rebuilds
            for b in batches:
                if b.kind == "mesh_heal":
                    # a heal, re-expansion or scale journaled after the
                    # snapshot: re-apply it in file order, so the later
                    # delta batches replay onto the shard count that
                    # actually served them
                    gen = int(b.meta.get("heal_gen", 0))
                    if gen <= self._heal_gen:
                        continue
                    excl = tuple(b.meta.get("exclude", ()))
                    s.adopt_mesh(self._survivor_mesh(int(b.meta["shards"]),
                                                     excl))
                    self._mesh_excluded = excl
                    self._heal_gen = gen
                    if b.meta.get("scale"):
                        self._mesh_home = int(b.meta["shards"])
                    obs_scope.FLIGHT_RECORDER.note_event(
                        "mesh_heal_replayed", shards=int(b.meta["shards"]),
                        heal_gen=gen)
                    continue
                if b.kind == "params_swap":
                    # a swap journaled after the snapshot: re-install its
                    # exact leaves so post-swap deltas replay onto the
                    # generation that actually served them (file order ==
                    # live order: both appended under the shield lock)
                    if hasattr(s, "_swap_params_locked"):
                        self._replay_params_swap(b)
                    continue
                if b.kind != "deltas" or b.seq_hi <= s._synced_seq:
                    continue
                s._apply_records(b.recs)
                replayed += len(b.recs)
                if s.rebuilds != rb0:
                    # replay re-hit a bucket overflow: the rebuild is
                    # store-derived as of NOW, which supersedes the rest
                    break
                if hasattr(s, "_apply_edge_records"):
                    s._apply_edge_records(b.recs)
                    s._gnn_seq = max(b.seq_hi, s._gnn_seq)
                s._synced_seq = max(b.seq_hi, s._synced_seq)
        dt = time.perf_counter() - t0
        self.recoveries += 1
        self.replayed_records += replayed
        self.last_recovery_seconds = dt
        obs_metrics.SHIELD_REPLAYED_DELTAS.inc(float(replayed))
        obs_metrics.SHIELD_RECOVERIES.inc(mode="journal_replay")
        log.warning("recovered_via_journal_replay", replayed=replayed,
                    torn_truncated=torn, seconds=round(dt, 4))
        obs_scope.FLIGHT_RECORDER.dump("recovery:journal_replay",
                                       self.flight_dir)
        return {"mode": "journal_replay", "replayed": replayed,
                "torn_truncated": torn, "seconds": dt}

    def recover_or_snapshot(self) -> dict:
        """Scorer-acquisition hook (workflow/worker.py): restore from a
        compatible on-disk snapshot+journal if one exists for this store
        lineage, otherwise anchor a fresh snapshot so every later fault is
        recoverable from tick one."""
        with self._lock:
            state = self.journal.load_snapshot()
            if (state is not None and state.get("epoch") == self._epoch
                    and state.get("klass") == type(self.scorer).__name__):
                return self.recover()
            return {"mode": "fresh_snapshot", "bytes": self.snapshot_now()}

    def stats(self) -> dict:
        return {
            "tier": self.tier,
            "tier_log": tuple(self.tier_log),
            "snapshots": self.snapshots,
            "recoveries": self.recoveries,
            "replayed_records": self.replayed_records,
            "quarantined_batches": self.quarantined_batches,
            "watchdog_trips": self.watchdog_trips,
            "journal_batches": self.journal.appended_batches,
            "journal_bytes": self.journal.appended_bytes,
            "torn_truncations": self.journal.torn_truncations,
            "breaker": self.breaker.stats(),
            "breaker_skips": self.breaker_skips,
            "attest_repairs": self.attest_repairs,
            "heals": self.heals,
            "reexpansions": self.reexpansions,
            "scale_events": self.scale_events,
            "mesh_excluded": self._mesh_excluded,
            "serving_shards": self.scorer._graph_size(),
            "shard_health": self.health.stats(),
        }

    def close(self) -> None:
        """Join the snapshot writer and close the journal."""
        self._join_snapshot_writer()
        self.journal.close()


def _host_leaves(params) -> list:
    """The params leaves as host numpy arrays, in ``gnn.flat_params``
    order: what a ``params_swap`` record carries."""
    from .gnn import flat_params
    return [np.array(v.detach().cpu() if isinstance(v, torch.Tensor) else v,
                     copy=True)
            for v in flat_params(params).values()]


def prepare_kernels(scorer) -> tuple[str, ...]:
    """Build and load every kernel a shielded scorer can launch, on the
    card: ``rules_fold`` (the rules tick, and the learned scorer's rules
    fallback), and for a learned scorer ``gms`` (its composed tier) and
    ``fused_tick`` when a fused or streamed tier is configured. Returns
    the names; none on the CPU, where every wrapper runs its plain
    version. Raises :class:`kernels._build.KernelError` on a build or
    load failure."""
    if scorer.device.type != "cuda":
        return ()
    names = ["rules_fold"]
    if hasattr(scorer, "_use_fused"):
        names.append("gms")
        if scorer._use_fused or scorer._use_dma:
            names.append("fused_tick")
    _build.build_all(tuple(names))
    for name in names:
        _build.load(name)
    return tuple(names)
