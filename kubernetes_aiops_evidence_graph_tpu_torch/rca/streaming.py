"""Streaming incremental re-scoring (churn at ~1k events/sec).

The resident device state is the feature matrix PLUS the dense evidence
tables (ev_idx/ev_cnt/ev_pair_slot). Every mutation kind — feature drift,
pod reschedule, node/edge creation and deletion, incident arrival and
closure — reduces to two padded deltas applied in place at the start of
each tick, followed by one ``kernels/rules_fold`` launch:

* feature delta: [K, DIM] rows copied into the feature matrix;
* row delta: [Kr, W] evidence-table rows (slots, counts, pair ids) for the
  incident rows whose evidence set changed.

The host keeps the authoritative per-incident evidence lists and per-row
pair maps (node -> row-local pair id for multiple_pods_same_node), so
structural churn is O(change) bookkeeping plus a bounded copy, without
ever rebuilding or re-uploading the snapshot. Free slots come from the
padding the buckets already carry: new nodes take free feature rows, new
incidents take free incident rows, new evidence appends into slot slack.
Only bucket overflow (feature rows, incident rows, slot width past the
ladder) falls back to a full snapshot rebuild, counted in ``rebuilds``.

Each tick's whole delta travels in ONE int32 slab (packed integers plus
the feature rows' bits) from pinned host memory to the device, and all of
the scorer's device work runs in order on its own CUDA stream; CUDA events
mark when a tick has finished, which is what the bounded in-flight queue
of :meth:`StreamingScorer.tick_async` waits on.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import threading
import time
from typing import Iterable, NamedTuple

import numpy as np
import torch

from ..config import Settings, get_settings
from ..device import resolve_device
from ..graph.schema import EntityKind, RelationKind
from ..graph.snapshot import GraphSnapshot, build_snapshot, extract_node_features
from ..graph.store import EvidenceGraphStore
from ..kernels.rules_fold import rules_fold
from ..observability import metrics as obs_metrics
from ..observability import scope as obs_scope
from ..ladders import (DELTA_BUCKETS as _DELTA_BUCKETS,
                       PAIR_WIDTH_BUCKETS as _PAIR_WIDTH_BUCKETS,
                       ROW_BUCKETS as _ROW_BUCKETS,
                       WIDTH_BUCKETS as _WIDTH_BUCKETS)
from ..utils.padding import bucket_for

_NO_PAIR = -1          # host-side "evidence has no scheduled node" marker

log = logging.getLogger(__name__)


class NonFiniteDelta(RuntimeError):
    """A staged feature delta carries NaN/inf rows. Copying it in would
    poison the resident state — and the rules fold absorbs NaN through its
    threshold comparisons (NaN > t is False), so the damage would surface
    as silently WRONG verdicts, not as NaN ones. Raised before the copy
    (the pending deltas are already drained, so only a journal replay
    restages them)."""

    stage = "dispatch"


class NeedsRebuild(Exception):
    """A growth ladder is exhausted: the next width/pair-width bucket lies
    beyond the ladder top. Raised by ``_grow_width``/``_grow_pair_width``
    and caught by ``_grow``, which escalates to a full store-derived
    ``_rebuild()``."""


def _tick(features, ints, f_rows, ev_idx, ev_cnt, ev_pair, chain,
          pair_width: int, pk: int, rk: int, width: int,
          f_live: int, r_live: int) -> tuple:
    """One tick: copy the feature delta and the evidence-row delta into
    the resident tensors IN PLACE, then score every incident row.

    All integer deltas arrive packed in one flat int32 tensor
    (f_idx | r_idx | r_cnt | r_ev | r_pair). Each delta is a live prefix
    (``f_live`` / ``r_live`` entries, every index in range and unique)
    followed by out-of-range padding; torch has no drop mode for an
    out-of-range index, so only the prefix is copied."""
    f_idx = ints[:pk]
    r_idx = ints[pk:pk + rk]
    r_cnt = ints[pk + rk:pk + 2 * rk]
    off = pk + 2 * rk
    r_ev = ints[off:off + rk * width].view(rk, width)
    r_pair = ints[off + rk * width:off + 2 * rk * width].view(rk, width)
    if f_live:
        features.index_copy_(0, f_idx[:f_live].long(), f_rows[:f_live])
    if r_live:
        rows = r_idx[:r_live].long()
        ev_idx.index_copy_(0, rows, r_ev[:r_live])
        ev_cnt.index_copy_(0, rows, r_cnt[:r_live])
        ev_pair.index_copy_(0, rows, r_pair[:r_live])
    return rules_fold(features, ev_idx, ev_cnt, ev_pair, chain, pair_width)


def _delta_pack(slab: torch.Tensor, li: int, pk: int, dim: int, gi: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor, "torch.Tensor | None"]:
    """Split one staged int32 slab into the tick's ``(ints, f_rows,
    extra)`` on the device: slices, and the feature rows' bits
    reinterpreted as float32 (bit-exact, no copy). ``extra`` is the
    ``gi``-long payload a subclass folded in after the feature rows
    (None when ``gi`` is 0)."""
    ints = slab[:li]
    rows = slab[li:li + pk * dim].view(torch.float32).view(pk, dim)
    extra = slab[li + pk * dim:li + pk * dim + gi] if gi else None
    return ints, rows, extra


def _pack_ints_sharded(f_idx, r_idx, r_cnt, r_ev, r_pair) -> np.ndarray:
    """[G, L] per-shard packed delta for the graph-sharded tick
    (parallel/sharded_streaming.sharded_rules_tick): each shard's row is
    its OWN routed feature-delta indices followed by the (small, [rk])
    row-delta payload duplicated per shard."""
    row_payload = np.concatenate(
        [r_idx, r_cnt, r_ev.ravel(), r_pair.ravel()]).astype(np.int32)
    g = f_idx.shape[0]
    return np.concatenate(
        [f_idx.astype(np.int32, copy=False),
         np.broadcast_to(row_payload, (g, row_payload.size))],
        axis=1).astype(np.int32, copy=False)


def _compact_delta(s_idx: np.ndarray, s_rows: np.ndarray,
                   idx_out: np.ndarray, rows_out: np.ndarray,
                   sentinel: int) -> int:
    """Write a screened feature delta back into the staged slab's views as
    a live prefix (its in-range rows, in order) followed by sentinel
    indices and zero rows. Returns the live count."""
    live = s_idx < sentinel
    m = int(live.sum())
    idx_out[:m] = s_idx[live]
    idx_out[m:] = sentinel
    rows_out[:m] = s_rows[live]
    rows_out[m:] = 0.0
    return m


class FeatureStage:
    """Columnar pending-feature staging: preallocated ``[cap]`` int32 node
    rows + ``[cap, DIM]`` float32 feature rows, plus a row→slot map for
    the latest-wins contract (an updated row overwrites its slot IN PLACE,
    keeping its original position, exactly like a dict key update).
    Draining into the tick's staged slab is two array copies."""

    def __init__(self, dim: int, capacity: int = _DELTA_BUCKETS[0]) -> None:
        self._dim = int(dim)
        cap = max(int(capacity), 1)
        self._idx = np.empty(cap, np.int32)
        self._rows = np.empty((cap, self._dim), np.float32)
        self._slots: dict[int, int] = {}
        self._n = 0

    def _grow_cap(self) -> None:
        cap = len(self._idx) * 2
        idx = np.empty(cap, np.int32)
        rows = np.empty((cap, self._dim), np.float32)
        idx[:self._n] = self._idx[:self._n]
        rows[:self._n] = self._rows[:self._n]
        self._idx, self._rows = idx, rows

    def __setitem__(self, row: int, feats) -> None:
        s = self._slots.get(row)
        if s is None:
            if self._n == len(self._idx):
                self._grow_cap()
            s = self._n
            self._slots[row] = s
            self._idx[s] = row
            self._n += 1
        self._rows[s] = feats

    def __len__(self) -> int:
        return self._n

    def keys(self) -> list[int]:
        """Staged node rows, in slot order (first staging order)."""
        return self._idx[:self._n].tolist()

    def overlay(self, table: np.ndarray) -> None:
        """Write the staged rows into ``table`` (a ``[Pn, DIM]`` host
        mirror) at their node rows: the host mirror of a staged row is
        its staged value."""
        table[self._idx[:self._n]] = self._rows[:self._n]

    def discard_range(self, lo: int, hi: int) -> int:
        """Drop every staged row in ``[lo, hi)`` (a quarantined or
        released tenant's region, ``rca/surge.py``) with one vectorized
        compaction; the surviving rows keep their relative order. Returns
        the rows dropped."""
        k = self._n
        idx = self._idx[:k]
        keep = (idx < lo) | (idx >= hi)
        m = int(keep.sum())
        if m == k:
            return 0
        self._idx[:m] = idx[keep]
        self._rows[:m] = self._rows[:k][keep]
        self._n = m
        self._slots = {int(r): j for j, r in enumerate(self._idx[:m])}
        return k - m

    def take(self) -> tuple[np.ndarray, np.ndarray]:
        """The staged (rows, features) in slot order, copied, and reset."""
        k = self._n
        out = (self._idx[:k].copy(), self._rows[:k].copy())
        self._slots.clear()
        self._n = 0
        return out

    def drain_into(self, idx_out: np.ndarray, rows_out: np.ndarray,
                   sentinel: int) -> int:
        """Copy the staged columns into the tick's padded delta views
        (tail = out-of-range sentinel indices + zero rows) and reset.
        Returns the live count."""
        k = self._n
        idx_out[:k] = self._idx[:k]
        idx_out[k:] = sentinel
        rows_out[:k] = self._rows[:k]
        rows_out[k:] = 0.0
        self._slots.clear()
        self._n = 0
        return k


@dataclasses.dataclass
class _Slab:
    host: torch.Tensor      # int32, pinned when the scorer runs on CUDA
    view: np.ndarray        # numpy view of ``host`` for the host writes
    # the last uploads that read it: one event per card (one on a single
    # device, none on the CPU)
    done: tuple = ()


class _SlabPool:
    """Rotating preallocated int32 staging slabs, keyed by length.

    A slab's upload is asynchronous (pinned memory, ``non_blocking``), so
    a slab must not be rewritten until every copy that read it has run:
    each upload records its events on the slab (one per card of a mesh),
    and reusing the slab waits for all of them (normally long past).
    Rotating ``copies`` slabs per length keeps that wait off the
    steady-state path; ``waits`` counts the reuses that found a copy
    still pending."""

    def __init__(self, copies: int, pin: bool) -> None:
        self.copies = max(int(copies), 2)
        self.pin = pin
        self._pools: dict[int, tuple[list[_Slab], int]] = {}
        self.waits = 0

    def acquire(self, n: int) -> _Slab:
        slabs, nxt = self._pools.get(n, ([], 0))
        if len(slabs) < self.copies:
            host = torch.zeros(n, dtype=torch.int32, pin_memory=self.pin)
            slab = _Slab(host, host.numpy())
            slabs.append(slab)
            self._pools[n] = (slabs, 0)
            return slab
        self._pools[n] = (slabs, (nxt + 1) % self.copies)
        slab = slabs[nxt]
        if slab.done:
            if not all(ev.query() for ev in slab.done):
                self.waits += 1
            for ev in slab.done:
                ev.synchronize()
        return slab


class _Tick(NamedTuple):
    """One dispatched tick: its seven device outputs and the event that
    marks their completion (None on the CPU, where a tick is synchronous)."""
    out: tuple
    done: "torch.cuda.Event | None"


class StreamingScorer:
    """Device-resident scorer with incremental structural + feature deltas."""

    def __init__(self, store: "EvidenceGraphStore | None",
                 settings: Settings | None = None,
                 now_s: float | None = None,
                 device: "str | torch.device | None" = None,
                 mesh=None, mesh_from_settings: bool = True) -> None:
        self.settings = settings or get_settings()
        self.store = store
        # optional device mesh (parallel/mesh.Mesh) with a "dp" axis and
        # maybe a "graph" axis: the resident incident tables split into
        # dp row blocks and, on a graph axis that the node bucket
        # divides, the feature table into node blocks, and every tick
        # runs the mesh tick (parallel/sharded_streaming.py); verdicts
        # are bit-identical to one device. With settings.serve_graph_shards
        # > 1, no explicit mesh and ``mesh_from_settings`` (a caller that
        # resolved the settings' mesh itself, as the worker does, passes
        # False), the scorer builds its own (1 x D) serving mesh from the
        # default pool of its device's platform (a short pool is logged).
        # Its positions may repeat one card or span several; each runs on
        # a stream of its own (parallel/compat.py).
        if mesh is not None and device is None:
            device = mesh.grid[0, 0]
        self.device = resolve_device(device)
        from ..parallel.mesh import settings_mesh
        if mesh is None and mesh_from_settings:
            mesh = settings_mesh(self.settings, self.device, dp=1)
        self.mesh = mesh
        # the scorer's own CUDA stream: uploads, in-place deltas, kernel
        # launches and fetches all run on it, in order
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        # deterministic replay clock: recency features (e.g. deploy age)
        # extract against THIS epoch instead of the wall clock when set,
        # so two replays of one seeded script give bit-identical rows
        self.now_s = now_s
        self.rebuilds = 0
        self.syncs = 0
        self.fetches = 0
        # device scoring passes actually enqueued (dispatch() calls)
        self.dispatches = 0
        # serializes sync()+dispatch() for multi-threaded serving
        self.serve_lock = threading.Lock()
        # pipelined serving executor: a bounded queue of dispatched but
        # unfetched ticks. tick_async() overlaps the host's delta packing
        # of tick t+1 with device execution of tick t; a full queue
        # coalesces pending deltas into one larger tick (bounded by the
        # top of the _DELTA_BUCKETS ladder). Results are fetched only at
        # the caller boundary (rescore()/serve()).
        self.pipeline_depth = max(1, int(self.settings.serve_pipeline_depth))
        # staging slabs: strictly more than the in-flight window
        self._stage_pool = _SlabPool(self.pipeline_depth + 3,
                                     pin=self.device.type == "cuda")
        self._inflight: collections.deque[_Tick] = collections.deque()
        # the on-device slice of a subclass's extra payload when it rode
        # this tick's staged slab (set by dispatch, read by the subclass)
        self._staged_gnn_dev: "torch.Tensor | None" = None
        self._coalesce_bound = _DELTA_BUCKETS[-1]
        self.coalesced_ticks = 0
        self.storm_coalesced_ticks = 0
        self.deferred_fetches = 0
        self.stall_seconds = 0.0
        # coalesced-serving state (see serve()): one device pass satisfies
        # every caller whose store writes preceded that pass's sync
        self._serve_cv = threading.Condition()
        self._serve_next_gen = 1
        self._serve_done_gen = 0
        self._serve_ticking = False
        self._serve_result: dict | None = None
        # the rules fold has no learned params; verdicts carry generation 0
        self.params_generation = 0
        # crash-shield seams: when a FaultInjector (rca/faults.py) is
        # attached, the tick consults it at each named stage (None, the
        # default, costs one attribute read per hook). The ShieldedScorer
        # (rca/shield.py) attaches one and turns finite_delta_guard on:
        # staged feature rows are then isfinite-checked (O(delta)) before
        # they are copied into the resident state
        self.fault_injector = None
        self.finite_delta_guard = False
        # absorb(): busy yields, and the synchronous drains past the
        # journal-backlog bound
        self.absorb_busy = 0
        self.absorb_sync_drains = 0
        self._max_journal_backlog = int(
            self.settings.ingest_max_journal_backlog)
        # per-tick telemetry (observability/scope.py): off, each boundary
        # costs one attribute read; on, host-monotonic stage marks only,
        # no device sync the serving path would not already pay.
        # _inflight_meta shadows _inflight with one TickSpan per queued
        # tick (None when telemetry is off), so a tick's completion is
        # stamped where the host first observes its CUDA event: retire,
        # stall or fetch, whichever comes first
        self.scope = obs_scope.TickScope(backend="rules",
                                         settings=self.settings)
        self._scope_tier = "steady"        # the shield re-stamps on ladder moves
        self._inflight_meta: collections.deque = collections.deque()
        self._last_tick_span = None
        self._scope_coalesced_since = 0
        self._scope_key: tuple = ()
        self._scope_entry = "streaming.rules_tick"
        # the owning serving pack's id (``SurgeServer`` stamps its packs)
        self._scope_pack = "0"
        self._init_from_store()

    # -- device helpers -----------------------------------------------------

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A fresh device copy of a host array (never aliasing it, also on
        the CPU: the host mirrors change before the tick that ships them)."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, copy=True)

    def _record(self) -> "torch.cuda.Event | None":
        if self._stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self._stream)
        return ev

    # -- (re)initialisation ------------------------------------------------

    def _drop_stale_inflight(self) -> None:
        """A rebuild supersedes every in-flight tick result (their tensors
        carry the OLD shapes): drop them unfetched."""
        stale = getattr(self, "_inflight", None)
        if stale:
            self.deferred_fetches += len(stale)
            obs_metrics.SERVE_DEFERRED_FETCHES.inc(float(len(stale)))
            stale.clear()
        stale_meta = getattr(self, "_inflight_meta", None)
        if stale_meta:
            for sp in stale_meta:
                self.scope.finalize(sp)
            stale_meta.clear()

    def _init_from_store(self) -> None:
        """Tensorize the store and derive the host-authoritative incremental
        state. Called at construction and on bucket-overflow rebuilds.
        Buckets are picked with 1/3 growth slack so structural churn lands
        in free padded rows instead of forcing mid-stream rebuilds."""
        self._drop_stale_inflight()
        # capture the journal cursor BEFORE tensorizing: mutations landing
        # in between are both in the snapshot and replayed by the next
        # sync(), and every mirror op is an idempotent MERGE, so replays
        # are safe while missed records would not be
        self._synced_seq = self.store.journal_seq
        snap = build_snapshot(self.store, self.settings, slack=1 / 3,
                              now_s=self.now_s)
        self.snapshot: GraphSnapshot = snap
        pn, pi = snap.padded_nodes, snap.padded_incidents

        # node rows
        self._node_ids: list[str | None] = list(snap.node_ids) + [None] * (
            pn - snap.num_nodes)
        self._id_to_idx: dict[str, int] = {
            nid: i for i, nid in enumerate(snap.node_ids)}
        self._free_node_rows: list[int] = list(
            range(pn - 1, snap.num_nodes - 1, -1))

        # incident rows
        self._inc_row_of: dict[str, int] = {
            iid: r for r, iid in enumerate(snap.incident_ids)}
        self._row_inc: list[str | None] = list(snap.incident_ids) + [None] * (
            pi - snap.num_incidents)
        self._free_inc_rows: list[int] = list(
            range(pi - 1, snap.num_incidents - 1, -1))

        # pod -> scheduled node (for pair ids of new/retargeted evidence),
        # plus the reverse index node -> pods so entity removal finds its
        # stranded pods in O(degree) instead of scanning every pod
        self._pod_node: dict[int, int] = {}
        self._sched_pods: dict[int, set[int]] = {}
        live = snap.edge_mask > 0
        sched = live & (snap.edge_rel == int(RelationKind.SCHEDULED_ON))
        for pos in np.nonzero(sched)[0]:
            s, d = int(snap.edge_src[pos]), int(snap.edge_dst[pos])
            pod, node = (s, d) if snap.node_kind[s] == int(EntityKind.POD) else (d, s)
            self._set_pod_node(pod, node)

        # per-incident evidence lists + pair maps (authoritative host state)
        is_ev = live & ((snap.edge_rel == int(RelationKind.AFFECTS))
                        | (snap.edge_rel == int(RelationKind.CORRELATES_WITH)))
        inc_row = np.full(pn, -1, dtype=np.int64)
        real = snap.incident_mask > 0
        inc_row[snap.incident_nodes[real]] = np.arange(int(real.sum()))
        self._row_nodes: list[list[int]] = [[] for _ in range(pi)]
        self._row_pairs: list[list[int]] = [[] for _ in range(pi)]
        self._pair_map: list[dict[int, int]] = [{} for _ in range(pi)]
        self._ev_rows_of_node: dict[int, set[int]] = {}
        for pos in np.nonzero(is_ev)[0]:
            r = int(inc_row[snap.edge_src[pos]])
            if r < 0:
                continue  # undirected duplicate (dst is the incident)
            dst = int(snap.edge_dst[pos])
            self._append_evidence_host(r, dst)

        # slot width carries 1/3 slack too: appended evidence must not
        # cross a width bucket right away
        self.width, self.pair_width = self._rebuild_widths()

        # device state
        with self._on_stream():
            self._features_dev = self._upload(snap.features)
            self._upload_tables()
            # every tick scores with a zero chain
            self._chain0 = torch.zeros(pi, dtype=torch.float32,
                                       device=self.device)

        # pending deltas. The feature delta is keyed by node row so the
        # LATEST update per row wins: a remove-then-reuse of the same row
        # within one tick collapses to one entry.
        self._pending_feat = FeatureStage(snap.features.shape[1])
        self._dirty_rows: set[int] = set()
        self._apply_sharding()

    def _upload_tables(self) -> None:
        """Re-ship all evidence tables from host state (caller is on the
        scorer's stream)."""
        ev_idx, ev_cnt, ev_pair = self._materialize_rows(
            range(self.snapshot.padded_incidents))
        self._ev_idx_dev = self._upload(ev_idx)
        self._ev_cnt_dev = self._upload(ev_cnt)
        self._pair_dev = self._upload(ev_pair)

    # -- slot-space seams ---------------------------------------------------
    #
    # The multi-tenant pack (rca/surge.py) carves the node and incident
    # slot spaces into per-tenant regions: allocation must stay inside the
    # id's region and store lookups must resolve through the id's tenant
    # store. The base scorer serves ONE store, so these default to the
    # single free lists and the single store.

    def _node_row_available(self, node_id: str) -> bool:
        return bool(self._free_node_rows)

    def _take_node_row(self, node_id: str) -> int:
        return self._free_node_rows.pop()

    def _put_node_row(self, row: int) -> None:
        self._free_node_rows.append(row)

    def _inc_row_available(self, node_id: str) -> bool:
        return bool(self._free_inc_rows)

    def _take_inc_row(self, node_id: str) -> int:
        return self._free_inc_rows.pop()

    def _put_inc_row(self, row: int) -> None:
        self._free_inc_rows.append(row)

    def _store_node(self, node_id: str):
        """The live store node behind a (possibly tenant-namespaced) id."""
        return self.store._nodes.get(node_id)

    def _canon_incident_id(self, incident_node_id: str) -> str:
        """Canonical incident node id: bare uuids gain the ``incident:``
        prefix. The multi-tenant pack overrides this: its journal-driven
        ids arrive canonical and namespaced already."""
        return (incident_node_id if incident_node_id.startswith("incident:")
                else f"incident:{incident_node_id}")

    def _tenant_count(self) -> int:
        """Tenants packed onto this resident state (1 for the base
        scorer); labels the per-pass incident-batch histogram."""
        return 1

    def serving_node_id(self, node_id: str, tenant: str = "default") -> str:
        """Translate a store-local node id into this scorer's slot-space
        id (the multi-tenant pack namespaces it per tenant)."""
        return node_id

    # -- the mesh seams (parallel/) ------------------------------------------

    def _sharded(self, pi: int) -> bool:
        """True when `pi` incident rows can shard over the mesh's dp axis."""
        return (self.mesh is not None
                and pi % self.mesh.shape["dp"] == 0)

    def _graph_size(self) -> int:
        if self.mesh is None or "graph" not in self.mesh.axis_names:
            return 1
        return self.mesh.shape["graph"]

    def _graph_sharded(self, pn: int, pi: int) -> bool:
        """True when the mesh carries a real ``graph`` axis AND both the
        node and incident buckets divide over it: the (dp × graph)
        serving mode with the features split into node blocks."""
        g = self._graph_size()
        return g > 1 and pn % g == 0 and self._sharded(pi)

    def _shardings(self, pn: int | None = None, pi: int | None = None):
        """(features, [Pi] rows, [Pi, W] tables) placements for state at
        shape (pn, pi) (default: current). Features split into node
        blocks over ``graph`` in graph mode and stay whole otherwise;
        row tables split into row blocks over ``dp``."""
        from ..parallel.mesh import dp_sharded, graph_sharded, replicated
        m = self.mesh
        if pn is None:
            pn = self.snapshot.padded_nodes
        if pi is None:
            pi = self.snapshot.padded_incidents
        feat = (graph_sharded(m) if self._graph_sharded(pn, pi)
                else replicated(m))
        return feat, dp_sharded(m), dp_sharded(m)

    def _apply_sharding(self) -> None:
        """Place the resident state per the mesh (no-op without one).
        Called after every (re)build and width growth re-materializes the
        tables; a tensor already placed stays where it is."""
        if not self._sharded(self.snapshot.padded_incidents):
            if self.mesh is not None:
                # surface the single-device fallback: the operator
                # configured a mesh but the bucket doesn't divide over it
                log.warning("mesh_sharding_skipped: padded_incidents=%d "
                            "dp=%d", self.snapshot.padded_incidents,
                            self.mesh.shape["dp"])
            return
        from ..parallel.compat import place
        feat, row1, row2 = self._shardings()
        with self._on_stream():
            for name, placement in (("_features_dev", feat),
                                    ("_ev_idx_dev", row2),
                                    ("_ev_cnt_dev", row1),
                                    ("_pair_dev", row2),
                                    ("_chain0", row1)):
                t = getattr(self, name)
                if isinstance(t, torch.Tensor):
                    setattr(self, name, place(t, placement))

    def adopt_mesh(self, mesh) -> None:
        """Re-point the resident serving state at a DIFFERENT ``(1 x D')``
        mesh (or ``None``, one device): live resharding after a classified
        shard loss (D' < D onto the survivors), re-expansion when the
        position returns, or a load-driven scale. Caller holds
        ``serve_lock`` (the shield's ``mesh_heal`` / ``reexpand`` /
        ``scale_mesh``). Every in-flight tick is superseded (its result
        is dropped unfetched) and the device state is RE-DERIVED from the
        host-truth mirrors (``snapshot.features`` holds the resident
        features' bits, mutations write the host first; the evidence
        tables re-materialize from the host lists), so a corrupted block
        of a dead position never survives into the new placement. Host
        bookkeeping (row maps, free lists, pair maps) is untouched: the
        healed scorer is the same scorer on another mesh, which is what
        makes its verdicts bit-identical to a fresh D' build. Pending
        deltas are already in the host mirrors, so they are dropped rather
        than copied again. The JAX package's warm-growth re-arm and
        ``warm_mesh`` have no counterpart: a CUDA kernel builds once. The
        old blocks are read by nothing here; their memory goes back to
        their positions' streams, whose later work follows the old
        mesh's last tick (every compat call joins into the scorer's
        stream)."""
        self._supersede_inflight()
        self.mesh = mesh
        pi = self.snapshot.padded_incidents
        with self._on_stream():
            self._features_dev = self._upload(self.snapshot.features)
            self._upload_tables()
            self._chain0 = torch.zeros(pi, dtype=torch.float32,
                                       device=self.device)
        self._pending_feat.take()
        self._dirty_rows.clear()
        self._apply_sharding()

    def _set_pod_node(self, pod: int, node: int) -> None:
        """Point `pod` at `node`, keeping the reverse index coherent."""
        old = self._pod_node.get(pod)
        if old == node:
            return
        if old is not None:
            s = self._sched_pods.get(old)
            if s is not None:
                s.discard(pod)
                if not s:
                    del self._sched_pods[old]
        self._pod_node[pod] = node
        self._sched_pods.setdefault(node, set()).add(pod)

    def _del_pod_node(self, pod: int) -> int | None:
        """Unmap `pod`; returns its former node (reverse index updated)."""
        node = self._pod_node.pop(pod, None)
        if node is not None:
            s = self._sched_pods.get(node)
            if s is not None:
                s.discard(pod)
                if not s:
                    del self._sched_pods[node]
        return node

    def _append_evidence_host(self, r: int, dst: int) -> None:
        """Host bookkeeping for one evidence slot (no width checks)."""
        self._row_nodes[r].append(dst)
        node = self._pod_node.get(dst)
        if node is None:
            self._row_pairs[r].append(_NO_PAIR)
        else:
            pm = self._pair_map[r]
            pid = pm.get(node)
            if pid is None:
                # max+1, NOT len(pm): removals can leave holes, and len(pm)
                # could collide with a live pid
                pid = max(pm.values(), default=-1) + 1
                pm[node] = pid
            self._row_pairs[r].append(pid)
        self._ev_rows_of_node.setdefault(dst, set()).add(r)

    def _recompact_pairs(self, r: int) -> None:
        """Rebuild row r's pair map dense (0..K-1) from its live slots.

        Called whenever a pair key can go stale — evidence removal, entity
        removal, pod retarget — so pair ids never develop holes: every pm
        key is referenced by at least one slot and max pid == len(pm)-1.
        Without this, a popped key lets ``len(pm)`` alias a live pid and
        lets the max pid reach ``pair_width`` (the no-node sentinel),
        silently dropping a real pod from the same-node condition."""
        pm: dict[int, int] = {}
        nodes = self._row_nodes[r]
        pairs = self._row_pairs[r]
        for i, dst in enumerate(nodes):
            node = self._pod_node.get(dst)
            if node is None:
                pairs[i] = _NO_PAIR
            else:
                pairs[i] = pm.setdefault(node, len(pm))
        self._pair_map[r] = pm
        self._dirty_rows.add(r)

    def _materialize_pairs(self, rows: Iterable[int]) -> np.ndarray:
        """[K, W] pair table only (_NO_PAIR becomes the out-of-range
        sentinel == pair_width)."""
        rows = list(rows)
        ev_pair = np.full((len(rows), self.width), self.pair_width, np.int32)
        for j, r in enumerate(rows):
            pairs = np.asarray(self._row_pairs[r], np.int32)
            if len(pairs):
                ev_pair[j, :len(pairs)] = np.where(
                    pairs < 0, self.pair_width, pairs)
        return ev_pair

    def _materialize_rows(self, rows: Iterable[int]
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """[K, W] slot tables for the given incident rows from host state."""
        rows = list(rows)
        k = len(rows)
        ev_idx = np.zeros((k, self.width), np.int32)
        ev_cnt = np.zeros(k, np.int32)
        for j, r in enumerate(rows):
            nodes = self._row_nodes[r]
            ev_cnt[j] = len(nodes)
            if nodes:
                ev_idx[j, :len(nodes)] = nodes
        return ev_idx, ev_cnt, self._materialize_pairs(rows)

    # -- bucket management -------------------------------------------------

    def _grow(self, grower) -> bool:
        """Run one growth step; on ladder exhaustion (NeedsRebuild)
        escalate to a full store-derived rebuild. Returns True when the
        escalation rebuilt (callers must stop touching pre-growth rows)."""
        try:
            grower()
            return False
        except NeedsRebuild as exc:
            log.warning("growth ladder exhausted: %s", exc)
            self._rebuild()
            return True

    def _grow_width(self) -> None:
        """Slot-width bucket overflow: next bucket, re-ship ALL rows.
        Raises NeedsRebuild past the ladder top (see _grow)."""
        nxt = bucket_for(self.width + 1, _WIDTH_BUCKETS)
        if nxt > _WIDTH_BUCKETS[-1]:
            raise NeedsRebuild(
                f"slot width {nxt} beyond ladder top {_WIDTH_BUCKETS[-1]}")
        self.width = nxt
        with self._on_stream():
            self._upload_tables()
        self._dirty_rows.clear()
        self._apply_sharding()

    def _grow_pair_width(self) -> None:
        """Pair bucket overflow: bump the bucket and re-stamp sentinels.
        Never shrinks mid-stream (a shrunk sentinel would land in range
        of the wider histogram). Raises NeedsRebuild past the ladder top
        (see _grow)."""
        nxt = bucket_for(self.pair_width + 1, _PAIR_WIDTH_BUCKETS)
        if nxt > _PAIR_WIDTH_BUCKETS[-1]:
            raise NeedsRebuild(
                f"pair width {nxt} beyond ladder top "
                f"{_PAIR_WIDTH_BUCKETS[-1]}")
        self.pair_width = nxt
        with self._on_stream():
            self._pair_dev = self._upload(
                self._materialize_pairs(range(self.snapshot.padded_incidents)))
        self._apply_sharding()

    def _rebuild(self) -> None:
        self.rebuilds += 1
        self._init_from_store()

    def _rebuild_widths(self) -> tuple[int, int]:
        """(width, pair_width) a rebuild derives from CURRENT host state:
        4/3 slack on the slot width, none on pairs."""
        max_w = max(max((len(v) for v in self._row_nodes), default=1), 1)
        width = bucket_for(max(int(np.ceil(max_w * 4 / 3)), 1),
                           _WIDTH_BUCKETS)
        pw = bucket_for(
            max(max((len(m) for m in self._pair_map), default=1), 1),
            _PAIR_WIDTH_BUCKETS)
        return width, pw

    # -- structural mutation API ------------------------------------------
    #
    # Callers mutate the store FIRST (it stays authoritative — rebuilds and
    # parity checks read it), then mirror the change here. Every method is
    # O(change); on bucket overflow it falls back to _rebuild().

    def add_entity(self, node_id: str) -> int:
        """New non-incident node: takes a free padded feature row.

        Returns -1 when row exhaustion forced a rebuild and the node is
        already gone from the store again (its add AND remove were both
        pending in one sync batch)."""
        if node_id in self._id_to_idx:
            return self._id_to_idx[node_id]
        if not self._node_row_available(node_id):
            self._rebuild()
            return self._id_to_idx.get(node_id, -1)
        row = self._take_node_row(node_id)
        node = self._store_node(node_id)
        self._node_ids[row] = node_id
        self._id_to_idx[node_id] = row
        self.snapshot.node_mask[row] = 1.0
        if node is not None:
            self.snapshot.node_kind[row] = int(node.kind)
            feats = extract_node_features(node, now_s=self.now_s)
        else:
            feats = np.zeros(self.snapshot.features.shape[1], np.float32)
        self.snapshot.features[row] = feats
        self._pending_feat[row] = feats
        return row

    def remove_entity(self, node_id: str) -> bool:
        """Remove a node: drop its evidence occurrences everywhere, free
        its feature row, zero its features."""
        row = self._id_to_idx.pop(node_id, None)
        if row is None:
            return False
        for r in self._ev_rows_of_node.pop(row, set()):
            keep = [i for i, n in enumerate(self._row_nodes[r]) if n != row]
            self._row_nodes[r] = [self._row_nodes[r][i] for i in keep]
            self._row_pairs[r] = [self._row_pairs[r][i] for i in keep]
            self._recompact_pairs(r)  # the slot's pair key may now be stale
        self._del_pod_node(row)
        # if the removed entity was a SCHEDULED_ON target, pods lose their
        # node: their evidence slots revert to the no-pair sentinel (a full
        # rebuild would see no edge). Recompacting each affected row both
        # re-stamps those slots and evicts the dead node's pair key.
        stranded = self._sched_pods.pop(row, set())
        if stranded:
            affected: set[int] = set()
            for p in stranded:
                del self._pod_node[p]
                affected |= self._ev_rows_of_node.get(p, set())
            for r in affected:
                self._recompact_pairs(r)
        self._node_ids[row] = None
        self._put_node_row(row)
        self.snapshot.node_mask[row] = 0.0
        self.snapshot.features[row] = 0.0
        self._pending_feat[row] = np.zeros(
            self.snapshot.features.shape[1], np.float32)
        return True

    def add_incident(self, incident_node_id: str,
                     evidence_node_ids: Iterable[str] = ()) -> int:
        """Incident arrival: a free incident row + its evidence slots.

        Returns -1 when bucket overflow forced a rebuild and the incident
        is already closed in the store (arrival and closure both pending
        in one sync batch)."""
        if incident_node_id in self._inc_row_of:
            r = self._inc_row_of[incident_node_id]
        else:
            if not self._inc_row_available(incident_node_id):
                self._rebuild()
                return self._inc_row_of.get(incident_node_id, -1)
            rb = self.rebuilds
            nrow = self.add_entity(incident_node_id)
            if self.rebuilds != rb:
                # node-row exhaustion rebuilt from the (already upserted)
                # store, which registered the incident
                return self._inc_row_of.get(incident_node_id, -1)
            r = self._take_inc_row(incident_node_id)
            self._inc_row_of[incident_node_id] = r
            self._row_inc[r] = incident_node_id
            self.snapshot.incident_nodes[r] = nrow
            self.snapshot.incident_mask[r] = 1.0
        for eid in evidence_node_ids:
            self.add_evidence(incident_node_id, eid)
        return r

    def close_incident(self, incident_node_id: str) -> bool:
        """Incident closure: clear the row's evidence and free it."""
        nid = self._canon_incident_id(incident_node_id)
        r = self._inc_row_of.pop(nid, None)
        if r is None:
            return False
        for dst in set(self._row_nodes[r]):
            s = self._ev_rows_of_node.get(dst)
            if s is not None:
                s.discard(r)
        self._row_nodes[r] = []
        self._row_pairs[r] = []
        self._pair_map[r] = {}
        self._row_inc[r] = None
        self._put_inc_row(r)
        self.snapshot.incident_mask[r] = 0.0
        self._dirty_rows.add(r)
        self.remove_entity(nid)
        return True

    def add_evidence(self, incident_node_id: str, entity_node_id: str) -> bool:
        """New AFFECTS/CORRELATES_WITH evidence edge."""
        r = self._inc_row_of.get(incident_node_id)
        dst = self._id_to_idx.get(entity_node_id)
        if r is None or dst is None:
            return False
        if dst in self._row_nodes[r]:
            return True  # MERGE semantics: duplicate edge is a no-op
        if len(self._row_nodes[r]) >= self.width:
            self._append_evidence_host(r, dst)
            # width first: the pair-growth path re-materializes at the
            # current width. A ladder-exhaustion rebuild supersedes row
            # state entirely (store-derived), so stop on escalation.
            if self._grow(self._grow_width):
                return True
            if self._pair_overflowed(r):
                self._grow(self._grow_pair_width)
            return True
        self._append_evidence_host(r, dst)
        if self._pair_overflowed(r):
            if self._grow(self._grow_pair_width):
                return True
        self._dirty_rows.add(r)
        return True

    def _pair_overflowed(self, r: int) -> bool:
        # check the MAX pid, not the map size: with holes (possible only
        # transiently mid-mutation) the max can reach pair_width — the
        # "no node" sentinel — while len(pm) still passes
        return max(self._pair_map[r].values(), default=-1) + 1 > self.pair_width

    def remove_evidence(self, incident_node_id: str,
                        entity_node_id: str) -> bool:
        r = self._inc_row_of.get(incident_node_id)
        dst = self._id_to_idx.get(entity_node_id)
        if r is None or dst is None or dst not in self._row_nodes[r]:
            return False
        i = self._row_nodes[r].index(dst)
        del self._row_nodes[r][i]
        del self._row_pairs[r][i]
        if dst not in self._row_nodes[r]:
            s = self._ev_rows_of_node.get(dst)
            if s is not None:
                s.discard(r)
        self._recompact_pairs(r)  # prune the pair key if it lost its last ref
        return True

    def schedule_pod(self, pod_id: str, node_id: str) -> bool:
        """New or retargeted SCHEDULED_ON edge: every evidence slot holding
        this pod gets the pair id of the new node (allocating a row-local id
        if the node is new to that row)."""
        pod = self._id_to_idx.get(pod_id)
        node = self._id_to_idx.get(node_id)
        if pod is None or node is None:
            return False
        self._set_pod_node(pod, node)
        grew = False
        for r in self._ev_rows_of_node.get(pod, set()):
            # recompact rather than setdefault(len(pm)): the pod's OLD node
            # may have just lost its last reference in this row
            self._recompact_pairs(r)
            if self._pair_overflowed(r):
                grew = True
        if grew:
            self._grow(self._grow_pair_width)
        return True

    def unschedule_pod(self, pod_id: str, node_id: str | None = None) -> bool:
        """SCHEDULED_ON edge deleted without a replacement: the pod's
        evidence slots revert to the no-pair sentinel. With ``node_id``,
        only applies if the pod is still mapped to THAT node — so an
        add-new-then-remove-old reschedule replays order-insensitively."""
        pod = self._id_to_idx.get(pod_id)
        if pod is None or pod not in self._pod_node:
            return False
        if node_id is not None:
            node = self._id_to_idx.get(node_id)
            if node is not None and self._pod_node[pod] != node:
                return False   # already rescheduled elsewhere; stale delete
        self._del_pod_node(pod)
        for r in self._ev_rows_of_node.get(pod, set()):
            self._recompact_pairs(r)
        return True

    # -- store-journal mirroring (the serving path) ------------------------

    def sync(self) -> dict:
        """Drain the store's change journal into the resident state, in
        O(changes). Falls back to one full rebuild if the bounded journal
        evicted unseen records."""
        recs, seq, truncated = self.store.journal_since(self._synced_seq)
        self.syncs += 1
        if truncated:
            self._rebuild()
            return {"applied": 0, "rebuilt": True}
        res = self._apply_records(recs)
        if not res["rebuilt"]:
            self._synced_seq = max(seq, self._synced_seq)
        return res

    def _apply_records(self, recs: list) -> dict:
        """Apply one batch of store-journal records through the mutation
        API. The caller owns cursor bookkeeping; a mid-batch rebuild
        supersedes the batch (state is store-derived as of NOW)."""
        changed: set[str] = set()
        structural = 0
        incident_kind = int(EntityKind.INCIDENT)
        affects = (int(RelationKind.AFFECTS),
                   int(RelationKind.CORRELATES_WITH))
        sched = int(RelationKind.SCHEDULED_ON)
        rb0 = self.rebuilds
        for rec in recs:
            if self.rebuilds != rb0:
                # a mutation overflowed a bucket and rebuilt: the rebuild
                # tensorized the store as of NOW, which already includes
                # every remaining record in this batch
                return {"applied": len(recs), "rebuilt": True}
            op = rec[1]
            if op == "node~":
                changed.add(rec[2])
            elif op == "node+":
                if rec[3] == incident_kind:
                    self.add_incident(rec[2])
                else:
                    self.add_entity(rec[2])
                structural += 1
            elif op == "node-":
                if rec[3] == incident_kind:
                    self.close_incident(rec[2])
                else:
                    self.remove_entity(rec[2])
                structural += 1
            elif op == "edge+":
                src, dst, kind = rec[2], rec[3], rec[4]
                if kind == sched:
                    self.schedule_pod(src, dst)
                elif kind in affects:
                    if src in self._inc_row_of:
                        self.add_evidence(src, dst)
                    elif dst in self._inc_row_of:
                        self.add_evidence(dst, src)
                structural += 1
            elif op == "edge-":
                src, dst, kind = rec[2], rec[3], rec[4]
                if kind == sched:
                    self.unschedule_pod(src, dst)
                elif kind in affects:
                    if src in self._inc_row_of:
                        self.remove_evidence(src, dst)
                    elif dst in self._inc_row_of:
                        self.remove_evidence(dst, src)
                structural += 1
        if self.rebuilds != rb0:   # rebuild fired on the last record
            return {"applied": len(recs), "rebuilt": True}
        if changed:
            # applied last with CURRENT store state: latest feature wins
            # regardless of interleaving, and removed ids just skip
            self.update_nodes(changed)
        return {"applied": len(recs), "structural": structural,
                "feature": len(changed), "rebuilt": False}

    def update_nodes(self, node_ids: Iterable[str]) -> int:
        """Queue feature re-extraction for nodes whose properties changed."""
        n = 0
        for nid in node_ids:
            idx = self._id_to_idx.get(nid)
            node = self._store_node(nid)
            if idx is None or node is None:
                continue
            row = extract_node_features(node, now_s=self.now_s)
            self.snapshot.features[idx] = row  # keep host copy coherent
            self._pending_feat[idx] = row
            n += 1
        return n

    # -- scoring -----------------------------------------------------------

    def _pending_row_delta(self) -> tuple[np.ndarray, ...]:
        """Drain dirty incident rows into padded arrays (live rows first,
        in ascending order, then out-of-range padding)."""
        rows = sorted(self._dirty_rows)
        self._dirty_rows.clear()
        k = len(rows)
        pk = bucket_for(max(k, 1), _ROW_BUCKETS)
        pi = self.snapshot.padded_incidents
        r_idx = np.full(pk, pi, dtype=np.int32)    # out-of-range padding
        r_ev = np.zeros((pk, self.width), np.int32)
        r_cnt = np.zeros(pk, np.int32)
        r_pair = np.full((pk, self.width), self.pair_width, np.int32)
        if k:
            ev_idx, ev_cnt, ev_pair = self._materialize_rows(rows)
            r_idx[:k] = rows
            r_ev[:k], r_cnt[:k], r_pair[:k] = ev_idx, ev_cnt, ev_pair
        return r_idx, r_ev, r_cnt, r_pair

    def _pending_feature_delta_sharded(self, shards: int
                                       ) -> tuple[np.ndarray, np.ndarray,
                                                  list[int]]:
        """Route the staged feature rows to their owner shards with
        per-shard ``_DELTA_BUCKETS`` sub-buckets: ([D, pk] shard-local
        indices, [D, pk, DIM] rows, live rows per shard). The delta width
        follows the MAX per-shard count, and each shard's rows keep
        their staging order (store-journal order: the router must not
        reorder). Drains the stage."""
        from ..parallel.sharded_streaming import route_node_delta
        nps = self.snapshot.padded_nodes // shards
        rows_idx, rows = self._pending_feat.take()
        idx, per_shard, pk = route_node_delta(
            [(int(r), j) for j, r in enumerate(rows_idx)], nps, shards,
            _DELTA_BUCKETS)
        out = np.zeros((shards, pk, self.snapshot.features.shape[1]),
                       np.float32)
        for g, ents in enumerate(per_shard):
            if ents:
                out[g, :len(ents)] = rows[[j for _r, j in ents]]
        return idx, out, [len(e) for e in per_shard]

    def _pending_feat_bound(self) -> int:
        """Pending feature-delta entries as the tick will see them: the
        max per-shard count in graph-sharded mode (per-shard sub-buckets
        bound the coalescing ladder per shard), the total otherwise."""
        g = self._graph_size()
        if g > 1 and self._graph_sharded(self.snapshot.padded_nodes,
                                         self.snapshot.padded_incidents):
            nps = self.snapshot.padded_nodes // g
            counts = np.bincount(
                np.asarray(self._pending_feat.keys(), np.int64) // nps,
                minlength=g)
            return int(counts.max(initial=0))
        return len(self._pending_feat)

    def _staged_delta_sharded(self, shards: int):
        """The mesh tick's staged delta in ONE int32 slab, uploaded once
        per device: ``[ints: D x L | rows: D x pk x DIM as int32]`` with
        each shard's ``ints`` row its own routed feature-delta indices
        (shard-local) followed by the row-delta payload, the same for
        every shard (``_pack_ints_sharded``). Returns ``(slab, f_idx [D,
        pk] view, f_rows [D, pk, DIM] view, li, pk, rk, f_live per shard,
        r_idx)``."""
        dim = self.snapshot.features.shape[1]
        f_idx, f_rows, f_live = self._pending_feature_delta_sharded(shards)
        pk = f_idx.shape[1]
        r_idx, r_ev, r_cnt, r_pair = self._pending_row_delta()
        rk = len(r_idx)
        ints = _pack_ints_sharded(f_idx, r_idx, r_cnt, r_ev, r_pair)
        li = ints.shape[1]
        slab = self._stage_pool.acquire(shards * li + shards * pk * dim)
        buf = slab.view
        buf[:shards * li] = ints.ravel()
        rows_view = buf[shards * li:].view(np.float32).reshape(
            shards, pk, dim)
        rows_view[...] = f_rows
        k = sum(f_live)
        obs_metrics.INGEST_BATCH_FILL.set(k / max(pk * shards, 1),
                                          site="delta")
        return (slab, buf[:shards * li].reshape(shards, li)[:, :pk],
                rows_view, li, pk, rk, f_live, r_idx)

    def _staged_extra_ints(self) -> "np.ndarray | None":
        """Extra int32 payload a subclass wants folded into the staged slab
        (the GNN scorer rides its packed aux/edge delta on the base slab's
        transfer). The base scorer stages nothing extra."""
        return None

    def _staged_delta(self):
        """Drain pending deltas into ONE int32 staging slab laid out as
        ``[f_idx | r_idx | r_cnt | r_ev | r_pair | f_rows as int32 |
        extra]`` — the packed integer deltas, the feature rows' bits and a
        subclass's extra payload (:meth:`_staged_extra_ints`) — so a tick
        pays a single host→device copy. Returns ``(slab, f_rows view, li,
        pk, rk, gi, f_live, r_live)``."""
        stage = self._pending_feat
        pn = self.snapshot.padded_nodes
        dim = self.snapshot.features.shape[1]
        width = self.width
        k = len(stage)
        pk = bucket_for(max(k, 1), _DELTA_BUCKETS)
        r_live = len(self._dirty_rows)
        r_idx, r_ev, r_cnt, r_pair = self._pending_row_delta()
        rk = len(r_idx)
        li = pk + 2 * rk + 2 * rk * width
        extra = self._staged_extra_ints()
        gi = 0 if extra is None else int(extra.size)
        slab = self._stage_pool.acquire(li + pk * dim + gi)
        buf = slab.view
        buf[pk:pk + rk] = r_idx
        buf[pk + rk:pk + 2 * rk] = r_cnt
        off = pk + 2 * rk
        buf[off:off + rk * width] = r_ev.ravel()
        buf[off + rk * width:li] = r_pair.ravel()
        f_rows = buf[li:li + pk * dim].view(np.float32).reshape(pk, dim)
        f_live = stage.drain_into(buf[:pk], f_rows, pn)
        if gi:
            buf[li + pk * dim:] = extra
        obs_metrics.INGEST_BATCH_FILL.set(k / pk, site="delta")
        return slab, f_rows, li, pk, rk, gi, f_live, r_live

    def dispatch(self) -> tuple:
        """Flush pending deltas and enqueue one scoring pass; returns the
        seven device outputs without a host fetch.

        The tick's TickSpan opens here and is stamped at each host
        boundary: ``pack`` when the staged slab is filled, ``staging``
        when its upload is enqueued, ``dispatch`` when the tick's launches
        have returned. The span parks in ``_last_tick_span`` for the
        caller (tick_async queues it with the in-flight handles; rescore
        finalizes it at the fetch)."""
        if self._last_tick_span is not None:
            # the previous tick aborted between dispatch and its caller
            # boundary (an injected fault, a device error): record it
            # rather than silently overwrite it
            self._last_tick_span.flag("abandoned")
            self.scope.finalize(self._last_tick_span)
            self._last_tick_span = None
        span = self.scope.begin(self)
        self._last_tick_span = span
        if span is not None:
            span.pending = len(self._pending_feat) + len(self._dirty_rows)
            span.coalesced = self._scope_coalesced_since
            span.params_gen = self.params_generation
            self._scope_coalesced_since = 0
        pn, pi = self.snapshot.padded_nodes, self.snapshot.padded_incidents
        on_mesh = self._sharded(pi)
        graph_sharded = self._graph_sharded(pn, pi)
        if on_mesh:
            # the mesh tick: feature rows routed to their owner shards
            # (one shard unless the features are split over graph)
            shards = self._graph_size() if graph_sharded else 1
            (slab, f_idx, f_rows, li, pk, rk, f_live,
             r_idx) = self._staged_delta_sharded(shards)
            gi = 0
        else:
            slab, f_rows, li, pk, rk, gi, f_live, r_live = \
                self._staged_delta()
            f_idx = slab.view[:pk]
        if span is not None:
            span.mark("pack")
        # fault seams: value poisoning lands on the STAGED rows inside the
        # slab the device reads (the host mirror stays clean: store
        # truth), and the dispatch and pack faults fire after the pending
        # deltas were drained into the slab, so a bare retry cannot
        # restage them: only a journal replay can
        poisoned = self._fault_value("delta_values", f_rows)
        if poisoned is not f_rows:
            f_rows[...] = poisoned
        s_idx, s_rows = self._screen_delta(f_idx, f_rows, span)
        if s_idx is not f_idx:
            # the screen dropped rows (index set to the out-of-range
            # sentinel): the tick copies a live prefix, so compact it
            if on_mesh:
                nps = pn // shards
                f_live = [_compact_delta(s_idx[g], s_rows[g], f_idx[g],
                                         f_rows[g], nps)
                          for g in range(shards)]
            else:
                f_live = _compact_delta(s_idx, s_rows, f_idx, f_rows, pn)
        self._fault_point("dispatch")
        self._fault_point("pack")
        dim = self.snapshot.features.shape[1]
        with self._on_stream():
            if on_mesh:
                # one upload of the slab per card, on the stream of the
                # card's first position; the slab is free again once
                # every card's upload has run
                from ..parallel import compat
                slabs, slab.done = compat.upload(self.mesh, slab.host)
                self._staged_gnn_dev = None
            else:
                slab_dev = slab.host.to(self.device, non_blocking=True)
                ints, rows, self._staged_gnn_dev = _delta_pack(
                    slab_dev, li, pk, dim, gi)
                ev = self._record()
                slab.done = () if ev is None else (ev,)
            if span is not None:
                span.mark("staging")
                # roofline drift: price THIS tick at its padded shapes,
                # once per shape key
                self._scope_key = (pn, pi, self.width, self.pair_width, pk,
                                   rk) + ((shards,) if graph_sharded else ())
                self._scope_entry = self._scope_entrypoint(graph_sharded)
                shapes = {"pn": pn, "pi": pi, "width": self.width,
                          "pk": pk, "rk": rk, "dim": dim}
                if graph_sharded:
                    shapes.update(shards=shards, pair_width=self.pair_width)
                obs_scope.ROOFLINE.model(self._scope_entry, self._scope_key,
                                         lambda: shapes,
                                         pack=self._scope_pack)
            if on_mesh:
                out = self._mesh_tick(graph_sharded, shards, pk, rk)(
                    self._features_dev, slabs, self._ev_idx_dev,
                    self._ev_cnt_dev, self._pair_dev, self._chain0, f_live,
                    self._row_spans(r_idx))
            else:
                out = _tick(self._features_dev, ints, rows,
                            self._ev_idx_dev, self._ev_cnt_dev,
                            self._pair_dev, self._chain0, self.pair_width,
                            pk, rk, self.width, f_live, r_live)
        # a device error mid-pipeline: the resident tensors were already
        # updated in place and may be poisoned; then a fault localized to
        # one shard of the resident state
        self._fault_point("execute")
        self._fault_point("shard_loss")
        self.dispatches += 1
        # every device pass scores EVERY live incident on the resident
        # state (labeled by how many tenants share it)
        batch = len(self._inc_row_of)
        obs_metrics.SERVE_BATCH_INCIDENTS.observe(
            float(batch), tenants=str(self._tenant_count()))
        if span is not None:
            span.batch_incidents = batch
            span.tenants = self._tenant_count()
            span.mark("dispatch")
        return out

    def _scope_entrypoint(self, sharded: bool) -> str:
        return ("streaming.rules_tick.sharded" if sharded
                else "streaming.rules_tick")

    def _mesh_tick(self, graph_sharded: bool, shards: int, pk: int,
                   rk: int):
        """The mesh tick for the current shapes: the owner fold with one
        sum over ``graph`` when the features are split into node blocks,
        the whole fold on each dp position otherwise
        (parallel/sharded_streaming.py)."""
        from ..parallel.sharded_streaming import (dp_rules_tick,
                                                  sharded_rules_tick)
        pn, pi = self.snapshot.padded_nodes, self.snapshot.padded_incidents
        rows = pi // self.mesh.shape["dp"]
        if graph_sharded:
            return sharded_rules_tick(self.mesh, pn // shards, rows,
                                      self.pair_width, pk, rk, self.width)
        return dp_rules_tick(self.mesh, rows, self.pair_width, pk, rk,
                             self.width)

    def _row_spans(self, r_idx: np.ndarray) -> list[tuple[int, int]]:
        """Each dp block's span ``[a, b)`` of the row delta's live prefix
        (its rows are ascending, so a block's rows are contiguous)."""
        pi = self.snapshot.padded_incidents
        live = r_idx[r_idx < pi]
        rows = pi // self.mesh.shape["dp"]
        bounds = np.searchsorted(live, np.arange(self.mesh.shape["dp"] + 1)
                                 * rows)
        return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]

    def _screen_delta(self, f_idx: np.ndarray, f_rows: np.ndarray,
                      span) -> tuple[np.ndarray, np.ndarray]:
        """Finite guard over the staged feature rows (the padded delta:
        its padding rows are zeros), after the pending deltas were drained
        and before they reach the resident state. The base scorer raises
        :class:`NonFiniteDelta` (the shield quarantines the batch and
        replays); the multi-tenant pack overrides this to drop only the
        poisoned tenants' rows, so the other tenants' tick proceeds
        (rca/surge.py). Returns ``(f_idx, f_rows)``, the same arrays when
        nothing was dropped."""
        if self.finite_delta_guard and not np.isfinite(f_rows).all():
            if span is not None:
                span.flag("nonfinite_delta")
                self.scope.finalize(span)
                self._last_tick_span = None
            raise NonFiniteDelta(
                f"{int((~np.isfinite(f_rows)).any(axis=-1).sum())} "
                "non-finite staged feature rows")
        return f_idx, f_rows

    # -- crash-shield seams (fault injection + snapshot/restore) -----------

    def _fault_point(self, stage: str) -> None:
        inj = self.fault_injector
        if inj is not None:
            inj.at(stage, self)

    def _fault_value(self, stage: str, value: np.ndarray) -> np.ndarray:
        inj = self.fault_injector
        if inj is not None:
            return inj.poison(stage, value)
        return value

    def make_replayable(self) -> None:
        """Called by the crash shield before its first snapshot: keep every
        order-bearing host structure a function of the applied journal
        alone. The rules scorer's sets are only ever walked in an order
        that does not matter (each row it visits is rebuilt on its own);
        the learned scorer overrides this."""

    # Host-authoritative attributes a state snapshot must carry: together
    # with the resident device tensors they reproduce the scorer exactly
    # (free lists included: replayed mutations must allocate the same
    # rows for bit-identical recovery). An explicit tuple, so the shield
    # can pickle and restore without knowing the scorer's internals.
    _HOST_STATE_ATTRS: tuple[str, ...] = (
        "snapshot", "width", "pair_width", "_synced_seq",
        "_node_ids", "_id_to_idx", "_free_node_rows",
        "_inc_row_of", "_row_inc", "_free_inc_rows",
        "_pod_node", "_sched_pods",
        "_row_nodes", "_row_pairs", "_pair_map", "_ev_rows_of_node",
        "_pending_feat", "_dirty_rows",
    )

    def capture_host_state(self) -> dict:
        """References to the host-side serving state (the shield pickles
        them at once, under ``serve_lock``, so later mutation cannot leak
        into the snapshot).

        The GraphSnapshot is captured SLIM: ``features`` is dropped (the
        resident feature tensor, which the snapshot packs, holds the same
        bits apart from the staged rows, which the staged delta carries;
        restore re-stitches the mirror from both) and so are the edge
        arrays (read only by ``_init_from_store``)."""
        d = {k: getattr(self, k) for k in self._HOST_STATE_ATTRS}
        d["snapshot"] = dataclasses.replace(
            self.snapshot,
            features=np.zeros((0, self.snapshot.features.shape[1]),
                              np.float32),
            edge_src=np.zeros(0, np.int32), edge_dst=np.zeros(0, np.int32),
            edge_rel=np.zeros(0, np.int32),
            edge_mask=np.zeros(0, np.float32))
        return d

    def restore_host_state(self, state: dict) -> None:
        """Adopt a deserialized host-state dict (fresh objects from
        pickle, never shared with a live scorer). The feature mirror is
        re-stitched by :meth:`_adopt_resident`."""
        for k in self._HOST_STATE_ATTRS:
            setattr(self, k, state[k])
        self._inflight.clear()
        self._inflight_meta.clear()

    def _resident_arrays(self) -> list:
        """The device-resident tensors a snapshot packs, in a fixed order
        matching :meth:`_adopt_resident`. Subclasses extend the list."""
        return [self._features_dev, self._ev_idx_dev, self._ev_cnt_dev,
                self._pair_dev]

    def _adopt_resident(self, parts: list) -> None:
        """Install unpacked device tensors (whole, as packed) as the
        resident state, placed per the scorer's mesh (caller is on the
        scorer's stream), and re-stitch the host feature mirror from
        the restored feature tensor plus the staged rows (a staged row's
        mirror is its staged value; every other row's is the device's)."""
        (self._features_dev, self._ev_idx_dev, self._ev_cnt_dev,
         self._pair_dev) = parts[:4]
        if self.snapshot.features.size == 0:
            feats = self._features_dev.cpu().numpy().copy()
            self._pending_feat.overlay(feats)
            self.snapshot = dataclasses.replace(self.snapshot,
                                                features=feats)
        self._chain0 = torch.zeros(self.snapshot.padded_incidents,
                                   dtype=torch.float32, device=self.device)
        # the whole tensors as packed: placed on the mesh they were
        # captured at (the shield re-points the mesh first)
        self._apply_sharding()

    def _attest_arrays(self) -> list:
        """(device attribute, host-truth mirror) pairs the attestation
        fold covers: node-addressed resident tensors whose host copies
        hold the same bits. Subclasses extend the list."""
        return [("_features_dev", self.snapshot.features)]

    # -- pipelined executor ------------------------------------------------
    #
    # dispatch() is asynchronous: it enqueues on the scorer's stream and
    # returns. tick_async() submits ticks into a bounded in-flight queue
    # (depth = settings.serve_pipeline_depth) so the host packs tick t+1
    # while the device runs tick t, and the fetch happens once at the
    # caller boundary (rescore()/serve()), dropping superseded results
    # without a readback. Backpressure is adaptive coalescing: a full
    # queue leaves the deltas pending, where they merge into one larger
    # tick — the queue never grows past depth and no delta is dropped.
    # Only when the merged delta would overflow the ladder's top bucket
    # does the executor block for a slot (counted as stall time).

    def _tick_handles(self, out: tuple) -> _Tick:
        """What the in-flight queue holds for one dispatched tick: the
        outputs a fetch reads, and the event that marks them complete.
        A subclass whose tick produces other outputs points this at them."""
        return _Tick(out, self._record())

    def _tick_ready(self, handles: _Tick) -> bool:
        return handles.done is None or handles.done.query()

    def _wait(self, handles: _Tick) -> None:
        if handles.done is not None:
            handles.done.synchronize()

    def _retire_ready(self) -> None:
        """Pop completed ticks off the head of the in-flight queue; their
        results are superseded without ever being fetched. Retirement is
        where the host first observes a queued tick's completion (its
        CUDA event), so its TickSpan gets its ``execute`` stamp here."""
        n0 = len(self._inflight)
        while self._inflight and self._tick_ready(self._inflight[0]):
            self._inflight.popleft()
            self._retire_meta(mark_execute=True)
            self.deferred_fetches += 1
        if n0 != len(self._inflight):
            obs_metrics.SERVE_DEFERRED_FETCHES.inc(
                float(n0 - len(self._inflight)))
        obs_metrics.SERVE_PIPELINE_INFLIGHT.set(
            float(len(self._inflight)), pack=self._scope_pack)

    def _retire_meta(self, mark_execute: bool = False) -> None:
        if not self._inflight_meta:
            return
        sp = self._inflight_meta.popleft()
        if sp is not None and mark_execute:
            sp.mark("execute")
        self.scope.finalize(sp)

    def _pending_delta_count(self) -> int:
        """Host-side delta entries a coalesced tick would carry, as the
        tick will see them (bounds the merge against the delta ladder:
        per shard in graph-sharded mode)."""
        return self._pending_feat_bound() + len(self._dirty_rows)

    def tick_async(self) -> dict:
        """Pipelined tick submission for streaming drivers: flush pending
        deltas into one tick and enqueue it WITHOUT fetching, as long as a
        pipeline slot is free. On a full queue the deltas stay pending and
        merge into the next submitted tick (adaptive coalescing) instead
        of blocking — unless the merged delta would overflow the top
        _DELTA_BUCKETS bucket, in which case the executor waits for the
        oldest tick (counted in ``stall_seconds``). Returns a small stats
        dict; results are fetched later via rescore()/serve()."""
        with self.serve_lock:
            return self._tick_async_locked()

    def _tick_async_locked(self) -> dict:
        """tick_async body; the caller holds ``serve_lock``."""
        self._retire_ready()
        # storm tier: while the ingest layer is in storm mode, coalesce
        # whenever ANY tick is already in flight (not just on a full
        # queue), so storm ticks merge toward the delta-ladder top: one
        # larger dispatch instead of many small ones. Host-side only and
        # bit-preserving: the same merge as the full-queue path, and the
        # caller boundary (rescore/serve) still drains everything.
        if (obs_scope.STORM_FLAG["active"] and self._inflight
                and len(self._inflight) < self.pipeline_depth):
            pending = self._pending_delta_count()
            if pending < self._coalesce_bound:
                self.coalesced_ticks += 1
                self.storm_coalesced_ticks += 1
                self._scope_coalesced_since += 1
                self.scope.note_coalesced(pending)
                obs_metrics.SERVE_COALESCED_TICKS.inc()
                obs_metrics.SERVE_COALESCED_TICK_SIZE.set(float(pending))
                return {"dispatched": False, "coalesced": True,
                        "storm": True, "inflight": len(self._inflight),
                        "pending": pending}
        if len(self._inflight) >= self.pipeline_depth:
            pending = self._pending_delta_count()
            if pending < self._coalesce_bound:
                self.coalesced_ticks += 1
                self._scope_coalesced_since += 1
                self.scope.note_coalesced(pending)
                obs_metrics.SERVE_COALESCED_TICKS.inc()
                obs_metrics.SERVE_COALESCED_TICK_SIZE.set(float(pending))
                return {"dispatched": False, "coalesced": True,
                        "inflight": len(self._inflight),
                        "pending": pending}
            t0 = time.perf_counter()
            self._wait(self._inflight.popleft())
            stall = time.perf_counter() - t0
            self.stall_seconds += stall
            self.deferred_fetches += 1
            # the stall is queue pressure charged to the tick about to
            # dispatch; the drained tick's completion was just observed
            self.scope.note_queue_wait(stall)
            self._retire_meta(mark_execute=True)
            obs_metrics.SERVE_PIPELINE_STALL_SECONDS.inc(
                stall, pack=self._scope_pack)
            obs_metrics.SERVE_DEFERRED_FETCHES.inc()
        out = self.dispatch()
        self._inflight.append(self._tick_handles(out))
        self._inflight_meta.append(self._last_tick_span)
        self._last_tick_span = None
        obs_metrics.SERVE_PIPELINE_INFLIGHT.set(
            float(len(self._inflight)), pack=self._scope_pack)
        return {"dispatched": True, "coalesced": False,
                "inflight": len(self._inflight), "pending": 0}

    def absorb(self) -> dict:
        """Webhook-burst ingestion: drain the store journal and submit ONE
        pipelined tick without fetching. The workflow calls this right
        after graph ingest, so the incident's deltas ride the bounded
        tick_async queue (coalescing under bursts) while the workflow's
        host steps continue; the verdict boundary then pays a deferred
        newest-tick fetch (``serve(newest=True)``). One lock acquisition
        covers sync + submit. Non-blocking: when a caller-boundary tick or
        fetch holds the serving state, absorb yields (``busy``) and the
        deltas stay in the journal for that boundary's own sync — unless
        the unsynced journal backlog exceeds
        ``settings.ingest_max_journal_backlog``, when it drains
        synchronously instead (counted)."""
        if not self.serve_lock.acquire(blocking=False):
            self.absorb_busy += 1
            obs_metrics.SERVE_ABSORB_BUSY.inc()
            backlog = self._journal_backlog()
            if backlog <= self._max_journal_backlog:
                return {"dispatched": False, "coalesced": False,
                        "busy": True, "backlog": backlog}
            self.absorb_sync_drains += 1
            obs_metrics.SERVE_ABSORB_SYNC_DRAINS.inc()
            self.serve_lock.acquire()
        try:
            self.sync()
            return self._tick_async_locked()
        finally:
            self.serve_lock.release()

    def _journal_backlog(self) -> int:
        """Store-journal records not yet drained into the resident state."""
        return max(int(self.store.journal_seq) - int(self._synced_seq), 0)

    def _supersede_inflight(self) -> None:
        """A fresh caller-boundary tick makes every queued result stale:
        drop them all, unfetched."""
        if self._inflight:
            self.deferred_fetches += len(self._inflight)
            obs_metrics.SERVE_DEFERRED_FETCHES.inc(
                float(len(self._inflight)))
            self._inflight.clear()
        while self._inflight_meta:
            self._retire_meta()
        obs_metrics.SERVE_PIPELINE_INFLIGHT.set(0.0, pack=self._scope_pack)

    def serve(self, newest: bool = False) -> dict:
        """Coalesced sync + rescore for concurrent serving callers.

        The first arrival becomes the ticker — it drains the journal and
        runs one rescore(); every caller that arrived before that tick
        started reads the shared result. Callers arriving while a tick is
        in flight wait for the NEXT tick (their store writes may postdate
        the running tick's sync). N concurrent incidents therefore cost
        at most 2 device fetches, and each caller's result reflects its
        own prior store writes. With ``newest=True`` the ticker prefers the
        newest in-flight tick's result (see :meth:`rescore_newest`)."""
        with self._serve_cv:
            need = self._serve_next_gen
            while self._serve_done_gen < need:
                if not self._serve_ticking:
                    gen = self._serve_next_gen
                    self._serve_next_gen = gen + 1
                    self._serve_ticking = True
                    break
                self._serve_cv.wait()
            else:
                return self._serve_result
        try:
            with self.serve_lock:
                self.sync()
                result = self.rescore_newest() if newest else self.rescore()
        except BaseException:
            with self._serve_cv:
                # roll back so a waiter can claim this generation
                self._serve_next_gen = gen
                self._serve_ticking = False
                self._serve_cv.notify_all()
            raise
        with self._serve_cv:
            self._serve_done_gen = gen
            self._serve_result = result
            self._serve_ticking = False
            self._serve_cv.notify_all()
        return result

    def live_incidents(self) -> tuple[list[str], list[int]]:
        """(incident ids, their rows) for live incidents, in row order —
        before any arrival/closure this is exactly the snapshot's incident
        order, so results align with a fresh build_snapshot."""
        pairs = sorted((r, iid) for iid, r in self._inc_row_of.items())
        return [p[1] for p in pairs], [p[0] for p in pairs]

    def _drain_queue_wait(self) -> float:
        """With a FULL pipeline, wait for the oldest slot before the
        caller-boundary tick dispatches, so that wait is reported as
        ``queue_wait_seconds`` and not inside dispatch or fetch."""
        if len(self._inflight) < self.pipeline_depth:
            return 0.0
        t0 = time.perf_counter()
        self._wait(self._inflight[0])
        qw = time.perf_counter() - t0
        self.scope.note_queue_wait(qw)
        return qw

    def rescore(self) -> dict:
        """Caller-boundary tick + fetch. The dispatched tick reflects every
        pending delta (including coalesced ones), so its result supersedes
        the whole in-flight queue — older results are dropped without a
        readback and exactly ONE fetch runs here."""
        stats = {"feature_updates": len(self._pending_feat),
                 "structural_refresh": bool(self._dirty_rows),
                 "rebuilds": self.rebuilds,
                 "coalesced_ticks": self.coalesced_ticks,
                 "deferred_fetches": self.deferred_fetches,
                 "newest_fetch": False}
        queue_wait_s = self._drain_queue_wait()
        t1 = time.perf_counter()
        out = self.dispatch()
        span, self._last_tick_span = self._last_tick_span, None
        handles = self._tick_handles(out)
        self._supersede_inflight()
        dispatch_s = time.perf_counter() - t1
        return self._fetch_verdicts(handles, span, stats, queue_wait_s,
                                    dispatch_s)

    def rescore_newest(self) -> dict:
        """Deferred newest-tick fetch: when NO deltas are pending, the
        newest in-flight tick already reflects every store write — fetch
        ITS result (older queued results dropped unfetched) without
        dispatching a fresh tick. Falls back to rescore() whenever deltas
        are pending or nothing is in flight. Caller holds ``serve_lock``."""
        if self._pending_delta_count() or not self._inflight:
            return self.rescore()
        stats = {"feature_updates": 0,
                 "structural_refresh": False,
                 "rebuilds": self.rebuilds,
                 "coalesced_ticks": self.coalesced_ticks,
                 "deferred_fetches": self.deferred_fetches,
                 "newest_fetch": True}
        handles = self._inflight.pop()          # newest submission
        span = self._inflight_meta.pop() if self._inflight_meta else None
        self._supersede_inflight()              # rest superseded, unfetched
        return self._fetch_verdicts(handles, span, stats, 0.0, 0.0)

    def _scope_fetched(self, span) -> None:
        """The fetched tick's caller boundary: ``fetch`` stamped, the span
        retired as fetched (stage histograms, spans under a live trace),
        and the roofline fed the tick's device window: from its
        ``staging`` stamp (every launch of the tick is enqueued after it)
        to its ``execute`` stamp (the host saw it complete). That window
        holds every kernel of the tick whatever the host's launch pace,
        so modeled bytes over it never exceed the rate the kernels
        reached; the ``execute`` split alone is shorter than the tick's
        device time when the launches run behind the device."""
        span.mark("fetch")
        at = dict(span.marks)
        window = at["execute"] - at["staging"]
        self.scope.finalize(span, fetched=True)
        obs_scope.ROOFLINE.observe(self._scope_entry, self._scope_key,
                                   window, pack=self._scope_pack)

    def _fetch_verdicts(self, handles: _Tick, span, stats: dict,
                        queue_wait_s: float, dispatch_s: float) -> dict:
        """One wait for a tick's outputs and their readback → the
        caller-facing raw verdict dict. The wait is the host boundary
        where the tick's ``execute`` stamp lands."""
        t2 = time.perf_counter()
        self._fault_point("fetch")
        self._wait(handles)
        if span is not None:
            span.mark("execute")
        with self._on_stream():
            fetched = tuple(t.cpu().numpy() for t in handles.out)
        fetch_s = time.perf_counter() - t2
        if span is not None:
            self._scope_fetched(span)
        conds, matched, scores, top_idx, any_match, top_conf, top_score = (
            fetched)
        self.fetches += 1
        obs_metrics.SERVE_FETCHED_BYTES.inc(
            float(sum(a.nbytes for a in fetched)), path="rules_rescore")
        ids, rows = self.live_incidents()
        return {
            "incident_ids": tuple(ids),
            "conditions": conds[rows],
            "matched": matched[rows],
            "scores": scores[rows],
            "top_rule_index": top_idx[rows],
            "any_match": any_match[rows],
            "top_confidence": top_conf[rows],
            "top_score": top_score[rows],
            "queue_wait_seconds": queue_wait_s,
            "dispatch_seconds": dispatch_s,
            "fetch_seconds": fetch_s,
            "device_seconds": queue_wait_s + dispatch_s + fetch_s,
            "params_generation": self.params_generation,
            **stats,
        }
