"""graft-scope: serving-path telemetry — the end-to-end latency story.

The serving stack has an async executor (graft-pipeline), a crash shield
(graft-shield) and a sharded fleet tick (graft-fleet), but until this
module nothing could attribute a verdict's latency across the pipeline:
the in-process Tracer only spanned workflow steps. graft-scope threads a
per-tick trace context through the entire hot path, with three pillars:

1. **Per-tick stage spans.** Every tick carries a :class:`TickSpan`
   recording host timestamps at the existing non-jitted boundaries —
   delta staging/packing, coalesce merges, queue wait (pipeline-full
   stalls), dispatch (the kernel launches), device completion (the first
   host OBSERVATION of the donated tick's ready event — graft-scope
   never injects a device sync the serving path would not already pay)
   and the deferred fetch. Stage splits aggregate into the
   ``aiops_tick_stage_seconds`` histogram, and for ticks fetched under a
   live trace context they materialize as child spans of the workflow
   span — one Tempo trace shows webhook → evidence → tick → verdict.

2. **Webhook→verdict SLO.** :class:`ServeScope` stamps each incident at
   webhook arrival (monotonic) and observes the latency into
   ``aiops_webhook_verdict_latency_seconds`` (per tenant / backend /
   shard count) when its verdict materializes, carrying the webhook's
   trace context across the async worker hop so the whole workflow joins
   the webhook's trace. p50/p99 come from ``Histogram.percentile``
   (linear interpolation) — the ROADMAP item-2 SLO surface, benched by
   ``bench.py bench_webhook_verdict_slo`` under 1k ev/s churn.

3. **Flight recorder + roofline drift.** A bounded ring of the last K
   per-tick records (stage splits, coalesced size, shard routing counts,
   shield tier, nonfinite/quarantine flags) is dumped to disk on every
   shield degradation transition or recovery. Roofline drift gauges
   price the LIVE tick at its padded shapes (``rca/device_metrics.
   tick_cost``, the closed form over the port's kernels; once per shape
   key) and track modeled-bytes/observed-seconds against the session's
   best, so a dashboard sees measured performance decaying away from the
   model without a bench run.

The resident scorers (``rca/streaming.py``, ``rca/gnn_streaming.py``)
stamp their ticks' stages and feed the roofline; the ingestion edge and
the workflow feed ``SCOPE``, spans and the flight ring; each pack of a
``rca/surge.SurgeServer`` fleet stamps its own ``pack`` label. On a mesh
the rules scorer's delta router (``parallel/sharded_streaming.
route_node_delta``) feeds ``SHARD_DELTA_ROWS`` and the flight records'
``shard_rows``, and the graph-sharded tick is priced under its own entry
point ``streaming.rules_tick.sharded`` (its sum over the graph axis in
``collective_bytes``).

Hard constraints this module keeps: all timestamps are host-side
monotonic reads (the epoch anchor for OTLP export is taken ONCE from
``utils.timeutils.utcnow`` — durations never touch the wall clock, so
the ``wall-clock`` lint stays clean with zero waivers); no jitted code
is touched; the telemetry cost is gated at
<1% of depth-2 steady-state throughput (tests/test_torch_scope_overhead.py,
marker ``perf_contract``).
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
import uuid
from typing import Any, Iterable

from ..utils.timeutils import utcnow
from . import metrics as m
from .logging import get_logger
from .tracing import TRACER, Span

log = get_logger("scope")

# one wall-clock read for the whole module: retrospectively-emitted spans
# anchor their epoch here and offset by monotonic deltas, so an NTP step
# mid-serve can never produce a negative stage span
_ANCHOR_EPOCH_S = utcnow().timestamp()
_ANCHOR_MONO = time.monotonic()
_monotonic = time.monotonic     # bound once: read at every stage mark


def _epoch_of(mono: float) -> float:
    return _ANCHOR_EPOCH_S + (mono - _ANCHOR_MONO)


epoch_of = _epoch_of


def emit_stage_span(name: str, stages: Iterable[tuple[str, float]],
                    **attributes: Any) -> None:
    """Retrospectively emit one span ending NOW, tiled by contiguous
    ``(stage, seconds)`` children, as a child of the calling thread's
    current span. No-op without a live trace context, so benches and
    tests driving scoring outside a trace add zero spans. Used by the
    snapshot-scoring verdict path (rca/tpu_backend.score_snapshot) whose
    timed windows must stay span-object-free."""
    parent = TRACER._current()
    if parent is None:
        return
    stages = [(s, max(float(d), 0.0)) for s, d in stages]
    now = time.monotonic()
    t0 = now - sum(d for _, d in stages)
    top = Span(trace_id=parent.trace_id, span_id=uuid.uuid4().hex[:16],
               parent_id=parent.span_id, name=name,
               start_s=_epoch_of(t0), start_mono=t0, end_mono=now,
               attributes=dict(attributes))
    top.end_s = _epoch_of(now)
    prev = t0
    for stage, dur in stages:
        t1 = prev + dur
        child = Span(trace_id=top.trace_id, span_id=uuid.uuid4().hex[:16],
                     parent_id=top.span_id, name=f"{name}.{stage}",
                     start_s=_epoch_of(prev), start_mono=prev, end_mono=t1)
        child.end_s = _epoch_of(t1)
        TRACER.emit(child)
        prev = t1
    TRACER.emit(top)


# -- per-tick trace context -------------------------------------------------

class TickSpan:
    """Host-boundary stage marks for one serving tick.

    The hot path pays one ``time.monotonic()`` read per stage mark and a
    list append — no span objects, no locks, no allocation beyond the
    marks list. Stages are CONTIGUOUS segments from ``t0``: the emitted
    child spans tile the parent tick span exactly, which is what lets a
    test pin "stage splits sum to the parent duration"."""

    __slots__ = ("tick_id", "t0", "marks", "queue_wait_s", "coalesced",
                 "pending", "shard_rows", "tier", "flags", "depth",
                 "backend", "fetched", "batch_incidents", "tenants",
                 "params_gen", "pack")

    def __init__(self, tick_id: int, backend: str, depth: int,
                 tier: str, queue_wait_s: float) -> None:
        self.tick_id = tick_id
        self.backend = backend
        self.depth = depth
        self.tier = tier
        self.queue_wait_s = queue_wait_s
        self.t0 = time.monotonic()
        self.marks: list[tuple[str, float]] = []
        self.coalesced = 0
        self.pending = 0
        self.shard_rows: tuple[int, ...] = ()
        self.flags: tuple[str, ...] = ()
        self.fetched = False
        # graft-surge: incidents scored by this tick's device pass and
        # how many tenants were packed onto the resident state — batched
        # passes must be visible in forensics, not just in the histogram
        self.batch_incidents = 0
        self.tenants = 1
        # graft-evolve: the params generation this tick dispatched
        # against (0 = the offline checkpoint) — stamped by the scorer at
        # dispatch so the flight ring shows exactly which ticks straddled
        # a hot checkpoint swap
        self.params_gen = 0
        # graft-swell: which serving pack (mesh) this tick belongs to —
        # with N packs the per-scorer gauges alias into one series unless
        # every record and gauge sample carries the pack identity
        self.pack = "0"

    def mark(self, stage: str) -> None:
        self.marks.append((stage, _monotonic()))

    def flag(self, name: str) -> None:
        if name not in self.flags:
            self.flags = self.flags + (name,)

    def splits(self) -> dict[str, float]:
        """Contiguous stage durations in seconds; ``queue_wait`` (time
        blocked for a pipeline slot BEFORE this tick began) leads."""
        out: dict[str, float] = {}
        if self.queue_wait_s:
            out["queue_wait"] = self.queue_wait_s
        prev = self.t0
        for stage, t in self.marks:
            out[stage] = out.get(stage, 0.0) + (t - prev)
            prev = t
        return out

    def to_record(self) -> dict:
        return {
            "tick": self.tick_id,
            "backend": self.backend,
            "depth": self.depth,
            "tier": self.tier,
            "fetched": self.fetched,
            "stages_ms": {k: round(v * 1e3, 4)
                          for k, v in self.splits().items()},
            "coalesced": self.coalesced,
            "pending": self.pending,
            "shard_rows": list(self.shard_rows),
            "flags": list(self.flags),
            "batch_incidents": self.batch_incidents,
            "tenants": self.tenants,
            "params_gen": self.params_gen,
            "pack": self.pack,
            "t_epoch_s": round(_epoch_of(self.t0), 6),
        }


# -- flight recorder --------------------------------------------------------

class FlightRecorder:
    """Bounded ring of the last K tick records plus interleaved event
    records (escalations, quarantines). ``dump()`` freezes the ring to a
    JSON file — called by the shield on every degradation transition or
    recovery, so the forensic window around a fault is always on disk."""

    def __init__(self, capacity: int = 256, retention: int = 64) -> None:
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self.dumps = 0
        self.pruned = 0
        # on-disk dump retention: repeated shield transitions (heal-ladder
        # chaos is exactly that) must not grow the dump dir without bound
        # — keep the newest K per directory (settings.flight_dump_keep)
        self.retention = int(retention)
        self.last_dump: dict | None = None
        self.last_dump_path: str | None = None

    def resize(self, capacity: int) -> None:
        with self._lock:
            if self._ring.maxlen != capacity:
                self._ring = collections.deque(self._ring, maxlen=capacity)

    def set_retention(self, keep: int) -> None:
        self.retention = int(keep)

    def record(self, rec) -> None:
        """Append one record — a plain dict, or a finalized TickSpan
        (materialized to a dict lazily at snapshot/dump time: the per-tick
        hot path pays one deque append, not a dict build)."""
        with self._lock:
            self._ring.append(rec)

    def note_event(self, kind: str, **fields: Any) -> None:
        """Interleave a non-tick forensic event (shield escalation,
        quarantine, nonfinite guard) into the ring at its arrival order."""
        rec = {"event": kind, "t_epoch_s": round(_epoch_of(
            time.monotonic()), 6), **fields}
        self.record(rec)

    def snapshot(self) -> list[dict]:
        with self._lock:
            ring = list(self._ring)
        return [r.to_record() if isinstance(r, TickSpan) else r
                for r in ring]

    def dump(self, reason: str, directory: str | None = None) -> str | None:
        """Write the current ring to ``<dir>/flight_<n>_<reason>.json``;
        returns the path (None when the write failed — a full disk must
        not take the recovery path down with it)."""
        doc = {
            "reason": reason,
            "dumped_at": utcnow().isoformat(),
            "records": self.snapshot(),
        }
        with self._lock:
            self.dumps += 1
            n = self.dumps
            self.last_dump = doc
        m.SCOPE_FLIGHT_DUMPS.inc(reason=reason.split(":", 1)[0])
        d = directory or _default_flight_dir()
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in reason)[:48]
        path = os.path.join(d, f"flight_{n:04d}_{safe}.json")
        try:
            os.makedirs(d, exist_ok=True)
            with open(path, "w") as f:
                json.dump(doc, f, indent=1)
        except OSError as exc:
            log.error("flight_dump_failed", path=path, error=str(exc))
            return None
        with self._lock:
            self.last_dump_path = path
        self._prune_dumps(d)
        log.warning("flight_recorder_dumped", reason=reason, path=path,
                    records=len(doc["records"]))
        return path

    def _prune_dumps(self, directory: str) -> None:
        """Retention: keep the newest ``retention`` dump files in this
        directory (by mtime — dump numbering restarts across processes),
        remove the rest. Best-effort: a prune failure must never take
        the recovery path down."""
        keep = self.retention
        if keep <= 0:
            return
        try:
            paths = [os.path.join(directory, f)
                     for f in os.listdir(directory)
                     if f.startswith("flight_") and f.endswith(".json")]
            # mtime first (dump numbering restarts across processes),
            # name as the tiebreak (same-process dumps can land within
            # one timestamp granule)
            paths.sort(key=lambda p: (os.path.getmtime(p), p))
        except OSError:
            return
        for p in paths[:-keep] if len(paths) > keep else []:
            try:
                os.remove(p)
            except OSError:
                continue
            with self._lock:
                self.pruned += 1
            m.SCOPE_FLIGHT_DUMPS_PRUNED.inc()


def _default_flight_dir() -> str:
    from ..config import get_settings
    d = getattr(get_settings(), "scope_flight_dir", "") or ""
    return d or os.path.join(".kaeg_scope", str(os.getpid()))


FLIGHT_RECORDER = FlightRecorder()

# graft-storm: process-wide storm-mode mirror, written ONLY by
# ingestion/admission.StormMode on its hysteresis transitions (which also
# interleave a note_event into the flight ring). A plain dict read keeps
# the tick hot path allocation- and import-free: TickScope.begin stamps a
# "storm" flag onto every tick dispatched while the ingest tier is
# degraded, and rca/streaming.py reads it for the harder coalescing
# bound — serving code never imports the ingestion layer.
STORM_FLAG = {"active": False}


# -- sharded routing visibility (parallel/sharded_streaming.py hook) --------

_route_tls = threading.local()
# set once any delta router has noted a route: until then (one card) a
# tick's retirement skips the thread-local read
_ROUTED = False

SHARD_DELTA_ROWS = m.REGISTRY.gauge(
    "aiops_serve_shard_delta_rows",
    "Delta rows routed to each graph shard by the last routed batch "
    "(imbalance = one hot shard setting the compiled delta width for "
    "all shards)")


def note_route(shard_rows: Iterable[int]) -> None:
    """Called by the sharded delta router with the per-shard delta row
    counts of the batch it just routed: sets the imbalance gauge and
    stashes the counts (thread-local — routing and dispatch happen on the
    same serving thread) for the next tick's flight record."""
    global _ROUTED
    rows = tuple(int(r) for r in shard_rows)
    _ROUTED = True
    _route_tls.last = rows
    for g, r in enumerate(rows):
        SHARD_DELTA_ROWS.set(float(r), shard=str(g))


def take_route() -> tuple[int, ...]:
    rows = getattr(_route_tls, "last", ())
    _route_tls.last = ()
    return rows


# -- roofline drift ---------------------------------------------------------

class _Roofline:
    """Price the LIVE tick and track achieved bandwidth against the
    session's best. The price is ``rca/device_metrics.tick_cost`` at the
    tick's padded shapes: a closed form costing microseconds, computed
    once per (entrypoint, shape key) on the calling thread; steady-state
    ticks pay a dict lookup. On one card no tick moves halo bytes."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._costs: dict[tuple, dict] = {}
        # achieved/best are PER (entrypoint, pack) series
        self._best: dict[tuple[str, str], float] = {}
        self._ewma: dict[tuple[str, str], float] = {}
        self._gauged: set[tuple[str, str]] = set()
        # (entrypoint, key, pack) already priced AND gauged: the per-tick
        # fast path is one set lookup
        self._steady: set[tuple] = set()
        # each series' gauge label key, built once
        self._labels: dict[tuple[str, str], tuple] = {}

    def model(self, entrypoint: str, key: tuple, shapes,
              pack: str = "0") -> None:
        """Price ``entrypoint`` at ``shapes()`` (a callable returning
        ``tick_cost``'s keyword arguments, called only for a new key) the
        first time ``key`` is seen, and set this pack's modeled gauges
        once per (entrypoint, pack)."""
        if (entrypoint, key, pack) in self._steady:
            return      # steady state (entries are never removed)
        k = (entrypoint, key)
        with self._lock:
            rec = self._costs.get(k)
            if rec is not None:
                # cost cache hit (shape-keyed, pack-independent): only
                # THIS pack's modeled gauges may still be missing
                if (entrypoint, pack) in self._gauged:
                    self._steady.add((entrypoint, key, pack))
                    return
                self._gauged.add((entrypoint, pack))
        if rec is None:
            rec = self._price(entrypoint, shapes())
            with self._lock:
                self._costs[k] = rec
                self._gauged.add((entrypoint, pack))
        m.ROOFLINE_MODELED_BYTES.set(
            float(rec["hbm_bytes"]), entrypoint=entrypoint, pack=pack)
        m.ROOFLINE_HALO_BYTES.set(
            float(rec["collective_bytes"]), entrypoint=entrypoint, pack=pack)
        with self._lock:
            self._steady.add((entrypoint, key, pack))

    @staticmethod
    def _price(entrypoint: str, shapes: dict) -> dict:
        from ..rca.device_metrics import tick_cost
        try:
            cost = tick_cost(entrypoint, **shapes)
            return {"hbm_bytes": int(cost["bytes"]),
                    "flops": int(cost["flops"]),
                    "collective_bytes": int(cost["collective_bytes"]),
                    "shapes": dict(shapes)}
        except (TypeError, ValueError, KeyError) as exc:
            # advisory gauge: a pricing failure must never surface into
            # the tick it describes — a zero-cost sentinel keeps it
            # visible (modeled bytes 0: no drift signal), priced once
            log.warning("roofline_price_failed", entrypoint=entrypoint,
                        error=str(exc))
            return {"hbm_bytes": 0, "flops": 0, "collective_bytes": 0,
                    "shapes": dict(shapes)}

    def join(self) -> None:
        """Kept for the callers of the JAX package's interface: pricing
        is synchronous here, so nothing is ever in flight."""

    def priced(self, entrypoint: str) -> dict[tuple, dict]:
        """Every shape key priced for ``entrypoint`` → its cost record
        (``hbm_bytes``, ``flops``, ``shapes``)."""
        with self._lock:
            return {key: dict(rec) for (e, key), rec in self._costs.items()
                    if e == entrypoint}

    def observe(self, entrypoint: str, key: tuple, seconds: float,
                pack: str = "0") -> None:
        """Host-observed device window of one tick → achieved-bandwidth
        proxy (modeled bytes / seconds, EWMA-smoothed) and drift vs the
        session high-water mark — per (entrypoint, pack) series."""
        if seconds <= 0:
            return
        rec = self._costs.get((entrypoint, key))   # entries never removed
        if not rec or not rec["hbm_bytes"]:
            return
        bps = rec["hbm_bytes"] / seconds
        series = (entrypoint, pack)
        with self._lock:
            prev = self._ewma.get(series)
            ewma = bps if prev is None else 0.9 * prev + 0.1 * bps
            self._ewma[series] = ewma
            best = max(self._best.get(series, 0.0), ewma)
            self._best[series] = best
            labels = self._labels.get(series)
            if labels is None:
                labels = self._labels[series] = tuple(sorted(
                    {"entrypoint": entrypoint, "pack": pack}.items()))
        m.ROOFLINE_ACHIEVED_BPS.set_key(ewma, labels)
        m.ROOFLINE_DRIFT.set_key(ewma / best if best else 0.0, labels)

    def achieved(self, entrypoint: str, pack: str = "0") -> float:
        """EWMA achieved-bytes/s for one (entrypoint, pack) series (0.0
        until the first observed tick)."""
        with self._lock:
            return self._ewma.get((entrypoint, pack), 0.0)

    def best(self, entrypoint: str, pack: str = "0") -> float:
        """Session high-water achieved-bytes/s for one series (0.0 until
        the first observed tick): the denominator of the drift signal."""
        with self._lock:
            return self._best.get((entrypoint, pack), 0.0)


ROOFLINE = _Roofline()


# -- the per-scorer telemetry front-end -------------------------------------

class TickScope:
    """One per resident scorer. ``begin()`` returns the tick's
    :class:`TickSpan` (or None when telemetry is off — the hot path then
    costs exactly one attribute read per boundary), ``finalize()`` folds
    it into the flight recorder + stage histograms and, when the calling
    thread carries a live trace context, emits the tick and its stage
    children as spans of that trace."""

    def __init__(self, backend: str, settings=None,
                 pack: str = "0") -> None:
        if settings is None:
            from ..config import get_settings
            settings = get_settings()
        self.enabled = bool(getattr(settings, "scope_telemetry", True))
        self.backend = backend
        # graft-swell: the owning serving pack's id — stamped onto every
        # TickSpan so multi-mesh flight records stay attributable
        self.pack = str(pack)
        self._serial = 0
        self._pending_queue_wait = 0.0
        self._stage_keys: dict[str, tuple] = {}
        FLIGHT_RECORDER.resize(
            int(getattr(settings, "scope_flight_records", 256)))
        FLIGHT_RECORDER.set_retention(
            int(getattr(settings, "flight_dump_keep", 64)))

    def _stage_key(self, stage: str) -> tuple:
        k = self._stage_keys.get(stage)
        if k is None:
            # must equal tuple(sorted({"backend":…, "stage":…}.items()))
            k = self._stage_keys[stage] = (("backend", self.backend),
                                           ("stage", stage))
        return k

    # hot-path producers ---------------------------------------------------

    def begin(self, scorer) -> TickSpan | None:
        if not self.enabled:
            return None
        self._serial += 1
        qw, self._pending_queue_wait = self._pending_queue_wait, 0.0
        span = TickSpan(self._serial, self.backend, scorer.pipeline_depth,
                        scorer._scope_tier, qw)
        span.pack = self.pack
        if STORM_FLAG["active"]:
            span.flag("storm")
        return span

    def note_queue_wait(self, seconds: float) -> None:
        """A pipeline-full stall (tick_async) or pre-dispatch drain
        (rescore) belongs to the NEXT dispatched tick's record."""
        if self.enabled:
            self._pending_queue_wait += seconds

    def note_coalesced(self, pending: int) -> None:
        """A submission whose deltas merged into a later tick: recorded as
        its own flight entry (the later tick's ``coalesced`` count tells
        the same story from the dispatch side)."""
        if not self.enabled:
            return
        FLIGHT_RECORDER.record({
            "event": "coalesced", "backend": self.backend,
            "pack": self.pack, "pending": int(pending),
            "t_epoch_s": round(_epoch_of(time.monotonic()), 6)})

    # retirement -----------------------------------------------------------

    def finalize(self, span: TickSpan | None, fetched: bool = False) -> None:
        """Retire one tick into the flight ring. FETCHED ticks — the
        caller boundary, whose latency a caller actually saw — also feed
        the stage histograms and (under a live trace context) the span
        emission; superseded ticks keep their full stage story in the
        ring only, so the per-submission hot path stays a handful of
        appends (the <1% overhead contract)."""
        if span is None:
            return
        span.fetched = fetched
        if _ROUTED and not span.shard_rows:
            span.shard_rows = take_route()
        FLIGHT_RECORDER.record(span)
        if not fetched:
            return
        m.TICK_STAGE_SECONDS.observe_keys(
            [(dur, self._stage_key(stage))
             for stage, dur in span.splits().items()])
        parent = TRACER._current()
        if parent is not None:
            self._emit_trace(span, parent)

    def _emit_trace(self, span: TickSpan, parent: Span) -> None:
        """Materialize the tick + its contiguous stage children as spans
        of the caller's trace. Runs once per FETCHED tick at the caller
        boundary — never in the per-stage hot path."""
        t_begin = span.t0 - span.queue_wait_s
        t_end = span.marks[-1][1] if span.marks else span.t0
        tick_span = Span(
            trace_id=parent.trace_id, span_id=uuid.uuid4().hex[:16],
            parent_id=parent.span_id, name="serve.tick",
            start_s=_epoch_of(t_begin), start_mono=t_begin,
            end_mono=t_end,
            attributes={"backend": span.backend, "tick": span.tick_id,
                        "depth": span.depth, "tier": span.tier,
                        "coalesced": span.coalesced,
                        "shard_rows": ",".join(map(str, span.shard_rows)),
                        "flags": ",".join(span.flags)})
        tick_span.end_s = _epoch_of(t_end)
        segments = []
        if span.queue_wait_s:
            segments.append(("queue_wait", t_begin, span.t0))
        prev = span.t0
        for stage, t in span.marks:
            segments.append((stage, prev, t))
            prev = t
        for stage, s0, s1 in segments:
            child = Span(
                trace_id=tick_span.trace_id,
                span_id=uuid.uuid4().hex[:16],
                parent_id=tick_span.span_id, name=f"tick.{stage}",
                start_s=_epoch_of(s0), start_mono=s0, end_mono=s1)
            child.end_s = _epoch_of(s1)
            TRACER.emit(child)
        TRACER.emit(tick_span)


# -- webhook→verdict SLO ----------------------------------------------------

class ServeScope:
    """Process-wide webhook→verdict correlation: bounded arrival registry
    keyed by incident id, each entry carrying the arrival's monotonic
    timestamp, tenant label, and the webhook span's trace context (so the
    async workflow joins the webhook's trace)."""

    _CAP = 4096

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._arrivals: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self.dropped = 0

    def webhook_received(self, incident_id: str,
                         tenant: str = "default") -> None:
        cur = TRACER._current()
        rec = {"t": time.monotonic(), "tenant": str(tenant),
               "trace": (cur.trace_id, cur.span_id) if cur else None}
        with self._lock:
            self._arrivals[str(incident_id)] = rec
            while len(self._arrivals) > self._CAP:
                self._arrivals.popitem(last=False)
                self.dropped += 1
                m.TRACE_SPANS_DROPPED.inc(site="scope_arrivals")

    def trace_parent(self, workflow_id: str) -> tuple | None:
        """(trace_id, span_id) of the webhook that created this workflow's
        incident, if it is still registered — workflow ids are
        ``incident-<uuid>`` (workflow/incident_workflow.py)."""
        iid = workflow_id[len("incident-"):] \
            if workflow_id.startswith("incident-") else workflow_id
        with self._lock:
            rec = self._arrivals.get(iid)
        return rec["trace"] if rec else None

    def verdict_served(self, incident_id: str, backend: str = "rules",
                       shards: int = 1) -> float | None:
        """Observe one webhook→verdict latency sample; returns the latency
        (None when the incident never passed through a webhook — e.g.
        simulator-injected incidents outside the SLO window)."""
        with self._lock:
            rec = self._arrivals.pop(str(incident_id), None)
        if rec is None:
            return None
        lat = time.monotonic() - rec["t"]
        m.WEBHOOK_VERDICT_LATENCY.observe(
            lat, tenant=rec["tenant"], backend=backend, shards=str(shards))
        m.SCOPE_VERDICTS_OBSERVED.inc(backend=backend)
        return lat

    def pending(self) -> int:
        with self._lock:
            return len(self._arrivals)

    def clear(self) -> None:
        with self._lock:
            self._arrivals.clear()


SCOPE = ServeScope()
