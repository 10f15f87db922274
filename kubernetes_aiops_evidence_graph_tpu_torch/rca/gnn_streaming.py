"""GNN serving under churn — ``rca_backend="gnn"`` on the streaming path.

``GnnStreamingScorer`` extends the resident ``StreamingScorer``
(``rca/streaming.py``): the GNN shares its device-resident feature matrix
and O(change) bookkeeping, and adds a device-resident **edge mirror** (the
full COO the message passing consumes, both directions of every store
edge) plus the node kinds and node mask. The mirror carries the same
relation-bucketed layout as ``build_snapshot`` (static per-relation slice
offsets, see :meth:`GnnStreamingScorer._mirror_init`), so every tick runs
the forward through ``kernels/gms``. Slots allocate from per-relation free
lists, which keeps the offsets valid under churn; a region that runs out
of slots falls back to a full re-mirror. The free lists, the stable dst
sort of a re-mirror and the padding pinned to the last row are the JAX
package's, so both packages hold the same mirror arrays after the same
churn.

Each tick re-embeds the whole padded graph: one forward scores every
incident at once. The mirror is journal-driven: it drains the store
journal with its own cursor at each dispatch, and mirrors the store's
cascade of a node removal from a per-node adjacency of live edge keys.

One tick's GNN delta (node kinds and masks, edge slots, the incident
tables) rides the base scorer's staged slab, so the whole tick pays one
host→device copy; the GNN tick then copies the live prefix of each delta
into the resident mirror in place and runs the forward on the updated
features, on the scorer's stream. The base rules tick still runs (it
applies the shared feature delta); its outputs are not fetched.
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..device import resolve_device
from ..graph.schema import RelationKind
from ..graph.snapshot import rel_slice_offsets
from ..graph.store import EvidenceGraphStore
from ..ladders import DELTA_BUCKETS as _DELTA_BUCKETS, REL_SLICE_BUCKETS
from ..utils.padding import bucket_for
from . import gnn
from .gnn_backend import resolve_params
from .ruleset import NUM_RULES
from .streaming import StreamingScorer, _Tick

log = logging.getLogger(__name__)

_EdgeKey = tuple[str, str, int]   # (src_id, dst_id, kind) — store edge key


def _gnn_tick(params, features, kind, nmask, esrc, edst, erel, emask, ints,
              pk: int, ek: int, pi: int, f_live: int, e_live: int,
              rel_offsets: tuple[int, ...], compute_dtype=None) -> tuple:
    """Copy the packed aux/edge deltas into the resident mirror IN PLACE,
    then run the full forward. All deltas arrive in one int32 tensor:

      [ f_idx pk | kind_v pk | nmask_v pk |
        e_idx ek | e_src ek | e_dst ek | e_rel ek | e_mask ek |
        incident_nodes pi | incident_mask pi ]

    Each delta is a live prefix (``f_live`` / ``e_live`` entries, unique
    in-range indices) followed by out-of-range padding; torch has no drop
    mode, so only the prefix is copied. Masks ship as 0/1 ints. Returns
    ``(logits, probs)``, probs zeroed on dead incident rows."""
    f_idx, kind_v, nmask_v = (ints[j * pk:(j + 1) * pk] for j in range(3))
    e_idx, e_src, e_dst, e_rel, e_mask = (
        ints[3 * pk + j * ek:3 * pk + (j + 1) * ek] for j in range(5))
    o = 3 * pk + 5 * ek
    inc_nodes = ints[o:o + pi]
    inc_mask = ints[o + pi:o + 2 * pi].to(torch.float32)
    if f_live:
        rows = f_idx[:f_live].long()
        for resident, delta in ((kind, kind_v), (nmask, nmask_v)):
            resident.index_copy_(0, rows, delta[:f_live].to(resident.dtype))
    if e_live:
        slots = e_idx[:e_live].long()
        for resident, delta in ((esrc, e_src), (edst, e_dst), (erel, e_rel),
                                (emask, e_mask)):
            resident.index_copy_(0, slots, delta[:e_live].to(resident.dtype))
    logits = gnn.forward(params, features, kind, nmask, esrc, edst, erel,
                         emask, inc_nodes, rel_offsets=rel_offsets,
                         compute_dtype=compute_dtype)
    # mask dead incident rows so a stale row can never surface a score
    probs = torch.softmax(logits, dim=-1) * inc_mask[:, None]
    return logits, probs


class GnnStreamingScorer(StreamingScorer):
    """StreamingScorer + resident edge mirror + per-tick GNN forward.

    ``rescore()``/``serve()`` return the GnnRcaBackend raw-dict surface
    (incident_ids / probs / top_rule_index / any_match / top_confidence),
    so ``GnnRcaBackend.results(raw=...)`` works unchanged."""

    def __init__(self, store: EvidenceGraphStore, settings=None,
                 params: gnn.Params | None = None,
                 now_s: float | None = None,
                 device: "str | torch.device | None" = None) -> None:
        from ..config import get_settings
        cfg = settings or get_settings()
        dev = resolve_device(device)
        self._params = resolve_params(params, cfg, dev)
        # previous (params, generation, source) kept for one swap, so a
        # post-swap regression can roll back without a checkpoint reload
        self._params_prev: "tuple | None" = None
        self._params_source = ""
        self._compute_dtype = cfg.gnn_compute_dtype or None
        # the packed GNN delta the staged slab carries this dispatch
        self._gnn_stage: "np.ndarray | None" = None
        self._last_gnn: "tuple | None" = None
        super().__init__(store, cfg, now_s=now_s, device=dev)

    def _staged_extra_ints(self) -> "np.ndarray | None":
        return self._gnn_stage

    # -- mirror (re)initialisation ---------------------------------------

    def _init_from_store(self) -> None:
        super()._init_from_store()
        # the base captured _synced_seq BEFORE tensorizing; the mirror is
        # built from the same store (records between the capture and now
        # replay idempotently at the next drain)
        self._gnn_seq = self._synced_seq
        self._mirror_init()

    def _mirror_offsets_now(self) -> tuple[int, ...]:
        """The relation-region offsets a re-mirror of the CURRENT store
        derives: both directions of every edge, 1/3 growth slack per
        region and a minimum slice per relation, so first-edge churn of an
        unseen relation lands in a free slot instead of forcing an
        immediate re-mirror."""
        num_rels = len(RelationKind)
        _, edges = self.store._raw()
        counts = np.zeros(num_rels, np.int64)
        for e in edges:
            counts[int(e.kind)] += 2           # both directions
        return rel_slice_offsets(counts, slack=1 / 3,
                                 min_cap=REL_SLICE_BUCKETS[0])

    def _mirror_init(self) -> None:
        """Rebuild the edge mirror + aux device tensors from the store,
        resolving rows through the base scorer's CURRENT id->row map (not
        a fresh snapshot: rows must match the resident features).

        Relation r owns slice [off[r], off[r+1]) of the edge arrays; a
        re-mirror emits each slice's directed edges sorted by dst (stable,
        so a dst's edges keep store order) with padding dst pinned to the
        last node row. Under churn, directed slots allocate individually
        from their relation's free list, popped from the low end of the
        slice's free tail; a region out of slots falls back to a full
        re-mirror with re-derived capacities."""
        offs = self._mirror_offsets_now()
        num_rels = len(RelationKind)
        pn = self.snapshot.padded_nodes
        pe = max(int(offs[-1]), 1)
        _, edges = self.store._raw()
        esrc = np.zeros(pe, np.int32)
        edst = np.full(pe, pn - 1, np.int32)
        erel = np.full(pe, -1, np.int32)
        emask = np.zeros(pe, np.float32)
        self._edge_slot: dict[_EdgeKey, tuple[int, int]] = {}
        self._node_edges: dict[str, set[_EdgeKey]] = {}
        # (dst, src_row, key, is_fwd) per relation, then dst-sorted
        directed: list[list[tuple[int, int, _EdgeKey, bool]]] = [
            [] for _ in range(num_rels)]
        for e in edges:
            srow = self._id_to_idx.get(e.src)
            drow = self._id_to_idx.get(e.dst)
            if srow is None or drow is None:   # placeholder outside base rows
                continue
            key = (e.src, e.dst, int(e.kind))
            r = int(e.kind)
            directed[r].append((drow, srow, key, True))
            directed[r].append((srow, drow, key, False))
            self._node_edges.setdefault(e.src, set()).add(key)
            self._node_edges.setdefault(e.dst, set()).add(key)
        slots_by_key: dict[_EdgeKey, dict[bool, int]] = {}
        self._free_edge_slots: list[list[int]] = []
        for r in range(num_rels):
            ents = directed[r]
            ents.sort(key=lambda t: t[0])   # stable: dst only
            fill = int(offs[r])
            for d, srow, key, fwd in ents:
                esrc[fill], edst[fill], emask[fill] = srow, d, 1.0
                erel[fill] = r
                slots_by_key.setdefault(key, {})[fwd] = fill
                fill += 1
            # per-relation free slot lists (allocation stays region-local,
            # which keeps the static offsets valid)
            self._free_edge_slots.append(
                list(range(int(offs[r + 1]) - 1, fill - 1, -1)))
        for key, by_dir in slots_by_key.items():
            self._edge_slot[key] = (by_dir[True], by_dir[False])
        self._rel_offsets: tuple[int, ...] = offs
        with self._on_stream():
            self._esrc_dev = self._upload(esrc)
            self._edst_dev = self._upload(edst)
            self._erel_dev = self._upload(erel)
            self._emask_dev = self._upload(emask)
            self._kind_dev = self._upload(self.snapshot.node_kind)
            self._nmask_dev = self._upload(self.snapshot.node_mask)
        # directed slot -> (src_row, dst_row, rel_kind, mask)
        self._pending_edges: dict[int, tuple[int, int, int, int]] = {}
        self._last_gnn = None

    # -- journal-driven mirror maintenance --------------------------------

    def _mirror_add(self, src: str, dst: str, kind: int) -> None:
        key = (src, dst, kind)
        if key in self._edge_slot:
            return
        srow = self._id_to_idx.get(src)
        drow = self._id_to_idx.get(dst)
        if srow is None or drow is None:
            return   # endpoint removed later in this batch: edge is gone too
        free = self._free_edge_slots[kind]
        if len(free) < 2:
            # the region overflowed: full re-mirror with re-derived
            # capacities (the static offsets can't stretch in place)
            self._mirror_init()
            return
        slot_f, slot_r = free.pop(), free.pop()
        self._edge_slot[key] = (slot_f, slot_r)
        self._node_edges.setdefault(src, set()).add(key)
        self._node_edges.setdefault(dst, set()).add(key)
        self._pending_edges[slot_f] = (srow, drow, kind, 1)
        self._pending_edges[slot_r] = (drow, srow, kind, 1)

    def _mirror_del(self, key: _EdgeKey) -> None:
        slots = self._edge_slot.pop(key, None)
        if slots is None:
            return
        src, dst, kind = key
        for nid in (src, dst):
            s = self._node_edges.get(nid)
            if s is not None:
                s.discard(key)
                if not s:
                    del self._node_edges[nid]
        for slot in slots:
            self._free_edge_slots[kind].append(slot)
            self._pending_edges[slot] = (0, 0, -1, 0)

    def _drain_edges(self) -> None:
        recs, seq, truncated = self.store.journal_since(self._gnn_seq)
        if truncated:
            self._mirror_init()
            self._gnn_seq = self.store.journal_seq
            return
        self._apply_edge_records(recs)
        self._gnn_seq = max(seq, self._gnn_seq)

    def _apply_edge_records(self, recs: list) -> None:
        """Mirror one batch of store-journal records onto the edge mirror
        (the caller owns the cursor)."""
        for rec in recs:
            op = rec[1]
            if op == "edge+":
                self._mirror_add(rec[2], rec[3], rec[4])
            elif op == "edge-":
                self._mirror_del((rec[2], rec[3], rec[4]))
            elif op == "node-":
                # the store cascade-removes a node's edges without per-edge
                # records; mirror the cascade from the adjacency
                for key in list(self._node_edges.get(rec[2], ())):
                    self._mirror_del(key)

    def _pending_delta_count(self) -> int:
        # each pending edge entry is one directed slot in the packed delta
        return super()._pending_delta_count() + len(self._pending_edges)

    # -- scoring -----------------------------------------------------------

    def _packed_gnn_delta(self, aux_rows: list[int]
                          ) -> tuple[np.ndarray, int, int, int, int]:
        """The tick's GNN delta in the layout of :func:`_gnn_tick`:
        ``(ints, pk, ek, f_live, e_live)``."""
        pi = self.snapshot.padded_incidents
        pn = self.snapshot.padded_nodes
        pe = int(self._esrc_dev.shape[0])

        pk = bucket_for(max(len(aux_rows), 1), _DELTA_BUCKETS)
        f_idx = np.full(pk, pn, np.int32)
        kind_v = np.zeros(pk, np.int32)
        nmask_v = np.zeros(pk, np.int32)
        if aux_rows:
            f_idx[:len(aux_rows)] = aux_rows
            kind_v[:len(aux_rows)] = self.snapshot.node_kind[aux_rows]
            nmask_v[:len(aux_rows)] = self.snapshot.node_mask[
                aux_rows].astype(np.int32)

        ents = [(slot, srow, drow, rel, m)
                for slot, (srow, drow, rel, m) in self._pending_edges.items()]
        self._pending_edges = {}
        if len(ents) > _DELTA_BUCKETS[-1]:
            # a delta beyond the ladder: a full re-mirror (one upload at
            # unchanged pe) is cheaper and resets pending entirely
            self._mirror_init()
            ents = []
            pe = int(self._esrc_dev.shape[0])
        ek = bucket_for(max(len(ents), 1), _DELTA_BUCKETS)
        e_idx = np.full(ek, pe, np.int32)
        e_src = np.zeros(ek, np.int32)
        e_dst = np.zeros(ek, np.int32)
        e_rel = np.full(ek, -1, np.int32)
        e_mask = np.zeros(ek, np.int32)
        for j, (slot, s, d, r, m) in enumerate(ents):
            e_idx[j], e_src[j], e_dst[j] = slot, s, d
            e_rel[j], e_mask[j] = r, m

        ints = np.concatenate([
            f_idx, kind_v, nmask_v, e_idx, e_src, e_dst, e_rel, e_mask,
            self.snapshot.incident_nodes.astype(np.int32),
            self.snapshot.incident_mask.astype(np.int32),
        ]).astype(np.int32, copy=False)
        return ints, pk, ek, len(aux_rows), len(ents)

    def dispatch(self) -> tuple:
        """The base tick (shared feature delta + rules score), then the GNN
        tick on the UPDATED features. The edge-journal drain and the GNN
        delta pack run BEFORE the base dispatch, so the packed GNN ints
        ride the base scorer's staged slab (one host→device copy). Returns
        the base device outputs; the GNN outputs land in ``_last_gnn``."""
        aux_rows = self._pending_feat.keys()
        self._drain_edges()
        ints, pk, ek, f_live, e_live = self._packed_gnn_delta(aux_rows)
        self._gnn_stage = ints
        try:
            out = super().dispatch()
        finally:
            self._gnn_stage = None
        ints_dev, self._staged_gnn_dev = self._staged_gnn_dev, None
        with self._on_stream():
            logits, probs = _gnn_tick(
                self._params, self._features_dev, self._kind_dev,
                self._nmask_dev, self._esrc_dev, self._edst_dev,
                self._erel_dev, self._emask_dev, ints_dev, pk, ek,
                self.snapshot.padded_incidents, f_live, e_live,
                self._rel_offsets, self._compute_dtype)
        self._last_gnn = (self.params_generation, logits, probs)
        return out

    def _tick_handles(self, out: tuple) -> _Tick:
        """In GNN mode the queue tracks the GNN tick's outputs
        ``(params generation, logits, probs)``: the generation the tick
        dispatched against travels with it, so a deferred fetch after a
        hot swap reports the generation that produced the verdict."""
        return _Tick(self._last_gnn, self._record())

    def _fetch_verdicts(self, handles: _Tick, stats: dict,
                        queue_wait_s: float, dispatch_s: float) -> dict:
        """GnnRcaBackend.score_snapshot-shaped raw dict for live incidents:
        one wait and one readback of the probs."""
        t2 = time.perf_counter()
        self._wait(handles)
        tick_gen, _logits, probs = handles.out
        with self._on_stream():
            probs = probs.cpu().numpy()
        fetch_s = time.perf_counter() - t2
        self.fetches += 1
        ids, rows = self.live_incidents()
        p = probs[rows]
        pred = p.argmax(axis=-1)
        return {
            "incident_ids": tuple(ids),
            "probs": p,
            "top_rule_index": pred,
            "any_match": pred != NUM_RULES,
            "top_confidence": p.max(axis=-1),
            "queue_wait_seconds": queue_wait_s,
            "dispatch_seconds": dispatch_s,
            "fetch_seconds": fetch_s,
            "device_seconds": queue_wait_s + dispatch_s + fetch_s,
            "params_generation": int(tick_gen),
            **stats,
        }

    # -- hot checkpoint swap -----------------------------------------------

    def _swap_params_locked(self, params, generation: int,
                            source: str = "") -> None:
        """Install new params under an already-held ``serve_lock``. Ticks in
        flight keep the old tensors (they captured them at dispatch); the
        next dispatch uses the new ones. A tree or shape change is
        refused."""
        new = resolve_params(params, None, self.device)
        old_flat, new_flat = gnn.flat_params(self._params), gnn.flat_params(new)
        if old_flat.keys() != new_flat.keys() or any(
                old_flat[k].shape != new_flat[k].shape for k in old_flat):
            raise ValueError(
                "hot swap rejected: candidate params tree/shapes differ "
                "from the serving checkpoint")
        self._params_prev = (self._params, self.params_generation,
                             self._params_source)
        self._params = new
        self.params_generation = int(generation)
        self._params_source = source
        log.info("params swapped to generation %d (%s)",
                 self.params_generation, source)

    def swap_params(self, params, generation: "int | None" = None,
                    source: str = "") -> int:
        """Hot-swap the serving checkpoint without dropping in-flight ticks
        (see :meth:`_swap_params_locked`). Returns the new generation."""
        with self.serve_lock:
            gen = (self.params_generation + 1 if generation is None
                   else int(generation))
            self._swap_params_locked(params, gen, source=source)
        return gen

    def rollback_params(self) -> "int | None":
        """Revert to the previous params, served under a fresh (advanced)
        generation number. Returns it, or None when there is nothing to
        roll back to (one-deep: no rollback ping-pong)."""
        with self.serve_lock:
            if self._params_prev is None:
                return None
            params, _old_gen, source = self._params_prev
            gen = self.params_generation + 1
            self._swap_params_locked(params, gen, source=source)
            self._params_prev = None
        return gen

    # -- introspection (tests) ---------------------------------------------

    def mirror_edge_rows(self) -> set[tuple[int, int]]:
        """Live directed (src_row, dst_row) pairs per the HOST mirror maps."""
        out: set[tuple[int, int]] = set()
        for (src, dst, _kind) in self._edge_slot:
            srow = self._id_to_idx.get(src)
            drow = self._id_to_idx.get(dst)
            if srow is not None and drow is not None:
                out.add((srow, drow))
                out.add((drow, srow))
        return out
