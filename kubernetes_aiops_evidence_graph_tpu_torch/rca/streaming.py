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
    done: "torch.cuda.Event | None" = None   # the last upload that read it


class _SlabPool:
    """Rotating preallocated int32 staging slabs, keyed by length.

    A slab's upload is asynchronous (pinned memory, ``non_blocking``), so
    a slab must not be rewritten until the copy that read it has run:
    each upload records an event on the slab, and reusing the slab waits
    for it (normally long past). Rotating ``copies`` slabs per length
    keeps that wait off the steady-state path."""

    def __init__(self, copies: int, pin: bool) -> None:
        self.copies = max(int(copies), 2)
        self.pin = pin
        self._pools: dict[int, tuple[list[_Slab], int]] = {}

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
        if slab.done is not None:
            slab.done.synchronize()
        return slab


class _Tick(NamedTuple):
    """One dispatched tick: its seven device outputs and the event that
    marks their completion (None on the CPU, where a tick is synchronous)."""
    out: tuple
    done: "torch.cuda.Event | None"


class StreamingScorer:
    """Device-resident scorer with incremental structural + feature deltas."""

    def __init__(self, store: EvidenceGraphStore,
                 settings: Settings | None = None,
                 now_s: float | None = None,
                 device: "str | torch.device | None" = None) -> None:
        self.settings = settings or get_settings()
        self.store = store
        self.device = resolve_device(device)
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
        # when set, staged feature rows are isfinite-checked (O(delta))
        # before they are copied into the resident state
        self.finite_delta_guard = False
        # absorb(): busy yields, and the synchronous drains past the
        # journal-backlog bound
        self.absorb_busy = 0
        self.absorb_sync_drains = 0
        self._max_journal_backlog = int(
            self.settings.ingest_max_journal_backlog)
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
            stale.clear()

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

    def _upload_tables(self) -> None:
        """Re-ship all evidence tables from host state (caller is on the
        scorer's stream)."""
        ev_idx, ev_cnt, ev_pair = self._materialize_rows(
            range(self.snapshot.padded_incidents))
        self._ev_idx_dev = self._upload(ev_idx)
        self._ev_cnt_dev = self._upload(ev_cnt)
        self._pair_dev = self._upload(ev_pair)

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
        if not self._free_node_rows:
            self._rebuild()
            return self._id_to_idx.get(node_id, -1)
        row = self._free_node_rows.pop()
        node = self.store._nodes.get(node_id)
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
        self._free_node_rows.append(row)
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
            if not self._free_inc_rows:
                self._rebuild()
                return self._inc_row_of.get(incident_node_id, -1)
            rb = self.rebuilds
            nrow = self.add_entity(incident_node_id)
            if self.rebuilds != rb:
                # node-row exhaustion rebuilt from the (already upserted)
                # store, which registered the incident
                return self._inc_row_of.get(incident_node_id, -1)
            r = self._free_inc_rows.pop()
            self._inc_row_of[incident_node_id] = r
            self._row_inc[r] = incident_node_id
            self.snapshot.incident_nodes[r] = nrow
            self.snapshot.incident_mask[r] = 1.0
        for eid in evidence_node_ids:
            self.add_evidence(incident_node_id, eid)
        return r

    def close_incident(self, incident_node_id: str) -> bool:
        """Incident closure: clear the row's evidence and free it."""
        nid = (incident_node_id if incident_node_id.startswith("incident:")
               else f"incident:{incident_node_id}")
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
        self._free_inc_rows.append(r)
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
            node = self.store._nodes.get(nid)
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
        pk = bucket_for(max(len(stage), 1), _DELTA_BUCKETS)
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
        return slab, f_rows, li, pk, rk, gi, f_live, r_live

    def dispatch(self) -> tuple:
        """Flush pending deltas and enqueue one scoring pass; returns the
        seven device outputs without a host fetch."""
        slab, f_rows, li, pk, rk, gi, f_live, r_live = self._staged_delta()
        self._screen_delta(f_rows[:f_live])
        dim = self.snapshot.features.shape[1]
        with self._on_stream():
            slab_dev = slab.host.to(self.device, non_blocking=True)
            slab.done = self._record()
            ints, rows, self._staged_gnn_dev = _delta_pack(slab_dev, li, pk,
                                                           dim, gi)
            out = _tick(self._features_dev, ints, rows, self._ev_idx_dev,
                        self._ev_cnt_dev, self._pair_dev, self._chain0,
                        self.pair_width, pk, rk, self.width, f_live, r_live)
        self.dispatches += 1
        return out

    def _screen_delta(self, f_rows: np.ndarray) -> None:
        """Finite guard over the staged feature rows, after the pending
        deltas were drained and before they reach the resident state."""
        if self.finite_delta_guard and not np.isfinite(f_rows).all():
            raise NonFiniteDelta(
                f"{int((~np.isfinite(f_rows)).any(axis=-1).sum())} "
                "non-finite staged feature rows")

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
        results are superseded without ever being fetched."""
        while self._inflight and self._tick_ready(self._inflight[0]):
            self._inflight.popleft()
            self.deferred_fetches += 1

    def _pending_delta_count(self) -> int:
        """Host-side delta entries a coalesced tick would carry."""
        return len(self._pending_feat) + len(self._dirty_rows)

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
        if len(self._inflight) >= self.pipeline_depth:
            pending = self._pending_delta_count()
            if pending < self._coalesce_bound:
                self.coalesced_ticks += 1
                return {"dispatched": False, "coalesced": True,
                        "inflight": len(self._inflight),
                        "pending": pending}
            t0 = time.perf_counter()
            self._wait(self._inflight.popleft())
            self.stall_seconds += time.perf_counter() - t0
            self.deferred_fetches += 1
        out = self.dispatch()
        self._inflight.append(self._tick_handles(out))
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

    def serving_node_id(self, node_id: str, tenant: str = "default") -> str:
        """A store-local node id in this scorer's slot space (the same id:
        the multi-tenant pack that namespaces it is ROADMAP item 7)."""
        return node_id

    def _supersede_inflight(self) -> None:
        """A fresh caller-boundary tick makes every queued result stale:
        drop them all, unfetched."""
        if self._inflight:
            self.deferred_fetches += len(self._inflight)
            self._inflight.clear()

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
        return time.perf_counter() - t0

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
        handles = self._tick_handles(self.dispatch())
        self._supersede_inflight()
        dispatch_s = time.perf_counter() - t1
        return self._fetch_verdicts(handles, stats, queue_wait_s, dispatch_s)

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
        self._supersede_inflight()              # rest superseded, unfetched
        return self._fetch_verdicts(handles, stats, 0.0, 0.0)

    def _fetch_verdicts(self, handles: _Tick, stats: dict,
                        queue_wait_s: float, dispatch_s: float) -> dict:
        """One wait for a tick's outputs and their readback → the
        caller-facing raw verdict dict."""
        t2 = time.perf_counter()
        self._wait(handles)
        with self._on_stream():
            fetched = tuple(t.cpu().numpy() for t in handles.out)
        fetch_s = time.perf_counter() - t2
        conds, matched, scores, top_idx, any_match, top_conf, top_score = (
            fetched)
        self.fetches += 1
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
