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
host→device copy; the GNN tick then applies it to the resident mirror in
place and runs the forward on the updated features, on the scorer's
stream. The base rules tick still runs (it applies the shared feature
delta); its outputs are not fetched.

The GNN tick runs in one of three tiers (:meth:`GnnStreamingScorer.
_call_gnn_tick`), all with the same verdicts at float32:

* **streamed** (``settings.gnn_tick_dma``): ``kernels/fused_tick.
  fused_gnn_tick_dma`` over two persistent activation buffers, optionally
  on a bf16 or int8 copy of the feature table (``gnn_feature_quant``);
* **fused** (``settings.gnn_fused_tick``): ``kernels/fused_tick.
  fused_gnn_tick``;
* **composed** (otherwise): :func:`_gnn_tick`, the scatter then
  ``rca/gnn.forward`` (``kernels/gms`` per layer).

On a mesh with a real ``graph`` axis (``settings.serve_graph_shards`` or
an explicit ``mesh``) the mirror is graph-sharded: D stacked per-shard
region sets, each edge on its destination's owner shard with its dst
shard-local, and every tick runs ``parallel/sharded_streaming.
sharded_gnn_tick`` (the ring-halo message pass, ``kernels/gms``
shard-local) after the base scorer's sharded rules tick. The three tiers
are single-device layouts: on a sharded mirror every setting serves the
sharded composed tick. A dp-only mesh has no sharded learned mapping and
serves on one device (logged).
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
from ..kernels import fused_tick
from ..ladders import DELTA_BUCKETS as _DELTA_BUCKETS, REL_SLICE_BUCKETS
from ..observability import metrics as obs_metrics
from ..observability import scope as obs_scope
from ..ops.fused_tick import quantize_features, tiles_align
from ..utils.padding import bucket_for
from . import gnn
from .gnn_backend import resolve_params
from .ruleset import NUM_RULES
from .streaming import StreamingScorer, _Tick

log = logging.getLogger(__name__)

_EdgeKey = tuple[str, str, int]   # (src_id, dst_id, kind) — store edge key


def copy_mirror_delta(ints, pk: int, ek: int, f_live: int, e_live: int,
                      kind, nmask, esrc, edst, erel, emask) -> None:
    """Copy a packed aux/edge delta into the resident mirror IN PLACE. The
    deltas arrive in one int32 tensor:

      [ f_idx pk | kind_v pk | nmask_v pk |
        e_idx ek | e_src ek | e_dst ek | e_rel ek | e_mask ek | ... ]

    Each delta is a live prefix (``f_live`` / ``e_live`` entries, unique
    in-range indices) followed by out-of-range padding; torch has no drop
    mode, so only the prefix is copied. Masks ship as 0/1 ints."""
    f_idx, kind_v, nmask_v = (ints[j * pk:(j + 1) * pk] for j in range(3))
    e_idx, e_src, e_dst, e_rel, e_mask = (
        ints[3 * pk + j * ek:3 * pk + (j + 1) * ek] for j in range(5))
    if f_live:
        rows = f_idx[:f_live].long()
        for resident, delta in ((kind, kind_v), (nmask, nmask_v)):
            resident.index_copy_(0, rows, delta[:f_live].to(resident.dtype))
    if e_live:
        slots = e_idx[:e_live].long()
        for resident, delta in ((esrc, e_src), (edst, e_dst), (erel, e_rel),
                                (emask, e_mask)):
            resident.index_copy_(0, slots, delta[:e_live].to(resident.dtype))


def _gnn_tick(params, features, kind, nmask, esrc, edst, erel, emask, ints,
              pk: int, ek: int, pi: int, f_live: int, e_live: int,
              rel_offsets: tuple[int, ...], compute_dtype=None) -> tuple:
    """Copy the packed delta into the resident mirror
    (:func:`copy_mirror_delta`; the incident tables follow the edge
    delta, ``[... | incident_nodes pi | incident_mask pi]``), then run the
    full forward. Returns ``(logits, probs)``, probs zeroed on dead
    incident rows."""
    o = 3 * pk + 5 * ek
    inc_nodes = ints[o:o + pi]
    inc_mask = ints[o + pi:o + 2 * pi].to(torch.float32)
    copy_mirror_delta(ints, pk, ek, f_live, e_live, kind, nmask, esrc, edst,
                      erel, emask)
    logits = gnn.forward(params, features, kind, nmask, esrc, edst, erel,
                         emask, inc_nodes, rel_offsets=rel_offsets,
                         compute_dtype=compute_dtype)
    # mask dead incident rows so a stale row can never surface a score
    probs = torch.softmax(logits, dim=-1) * inc_mask[:, None]
    return logits, probs


def _gnn_fused_tick(params, features, kind, nmask, esrc, edst, erel, emask,
                    ints, pk: int, ek: int, pi: int,
                    rel_offsets: tuple[int, ...], compute_dtype=None) -> tuple:
    """The fused tier (``settings.gnn_fused_tick``): :func:`_gnn_tick`'s
    operands and result, the whole tick in ``kernels/fused_tick.
    fused_gnn_tick`` — the delta scatter (which drops the padding itself),
    the message pass and the verdict. ``compute_dtype`` None or
    "bfloat16". Returns ``(logits, probs)``."""
    out = fused_tick.fused_gnn_tick(
        params, features, kind, nmask, esrc, edst, erel, emask, ints, pk=pk,
        ek=ek, pi=pi, rel_offsets=rel_offsets, compute_dtype=compute_dtype)
    return out[6], out[7]


def _gnn_dma_tick(params, features, kind, nmask, esrc, edst, erel, emask,
                  ints, h_a, h_b, pk: int, ek: int, pi: int,
                  rel_offsets: tuple[int, ...], node_block: int = 2048,
                  compute_dtype=None) -> tuple:
    """The streamed tier (``settings.gnn_tick_dma``) on the float32
    features: the fused tick in ``kernels/fused_tick.fused_gnn_tick_dma``,
    over the scorer's two persistent ``[Pn, H]`` activation buffers
    ``h_a``/``h_b`` (pure per-tick scratch, rewritten in place).
    ``node_block`` rows per block. Returns ``(logits, probs)``."""
    out = fused_tick.fused_gnn_tick_dma(
        params, features, kind, nmask, esrc, edst, erel, emask, ints, h_a, h_b,
        pk=pk, ek=ek, pi=pi, rel_offsets=rel_offsets, node_block=node_block,
        compute_dtype=compute_dtype)
    return out[6], out[7]


def _gnn_dma_tick_q(params, features_q, kind, nmask, esrc, edst, erel, emask,
                    ints, h_a, h_b, fq_rows, feat_scale, pk: int, ek: int,
                    pi: int, rel_offsets: tuple[int, ...],
                    node_block: int = 2048, compute_dtype=None,
                    feat_quant: str = "int8") -> tuple:
    """The streamed tier's quantized tables (``settings.
    gnn_feature_quant``): the node features are the resident bf16 or int8
    table ``features_q``; the tick's ``fq_rows`` (the aux rows quantized
    against the frozen scale) land in it in place, and the embed
    dequantizes (int8 times ``feat_scale``). Returns ``(logits, probs)``."""
    out = fused_tick.fused_gnn_tick_dma(
        params, features_q, kind, nmask, esrc, edst, erel, emask, ints, h_a,
        h_b, pk=pk, ek=ek, pi=pi, rel_offsets=rel_offsets,
        node_block=node_block, compute_dtype=compute_dtype,
        feat_quant=feat_quant, fq_rows=fq_rows, feat_scale=feat_scale)
    return out[6], out[7]


class GnnStreamingScorer(StreamingScorer):
    """StreamingScorer + resident edge mirror + per-tick GNN forward.

    ``rescore()``/``serve()`` return the GnnRcaBackend raw-dict surface
    (incident_ids / probs / top_rule_index / any_match / top_confidence),
    so ``GnnRcaBackend.results(raw=...)`` works unchanged."""

    def __init__(self, store: EvidenceGraphStore, settings=None,
                 params: gnn.Params | None = None,
                 now_s: float | None = None,
                 device: "str | torch.device | None" = None,
                 mesh=None, mesh_from_settings: bool = True) -> None:
        from ..config import get_settings
        cfg = settings or get_settings()
        # a mesh with a real ``graph`` axis serves the sharded learned
        # tick; a dp-only mesh has no sharded learned mapping (the
        # incident readout is not dp-sharded here): one device, as before
        if mesh is not None and ("graph" not in mesh.axis_names
                                 or mesh.shape["graph"] <= 1):
            log.warning("gnn_streaming_mesh_unsupported: %s", mesh)
            if device is None:
                device = mesh.grid[0, 0]
            mesh = None
        if mesh is not None and device is None:
            device = mesh.grid[0, 0]
        dev = resolve_device(device)
        self._params = resolve_params(params, cfg, dev)
        # previous (params, generation, source) kept for one swap, so a
        # post-swap regression can roll back without a checkpoint reload
        self._params_prev: "tuple | None" = None
        self._params_source = ""
        self._compute_dtype = cfg.gnn_compute_dtype or None
        # the tick's tier (see _call_gnn_tick): fused, streamed, and the
        # streamed tier's quantized feature table
        self._use_fused = bool(cfg.gnn_fused_tick)
        self._use_dma = bool(cfg.gnn_tick_dma)
        self._dma_node_block = int(cfg.gnn_dma_node_block)
        self._feat_quant = str(cfg.gnn_feature_quant or "")
        # the streamed tier's two [Pn, H] activation buffers, kept across
        # ticks (rewritten in place by every tick)
        self._dma_h: "tuple[torch.Tensor, torch.Tensor] | None" = None
        # the quantized feature table and its per-column scale, re-derived
        # from the host features at every mirror (re)build (_quant_refresh)
        self._features_q_dev: "torch.Tensor | None" = None
        self._feat_scale_dev: "torch.Tensor | None" = None
        self._feat_scale_host: "np.ndarray | None" = None
        # this dispatch's quantized delta rows, staged by dispatch() and
        # consumed by _dispatch_dma
        self._dma_stage_fq: "np.ndarray | None" = None
        # the packed GNN delta the staged slab carries this dispatch
        self._gnn_stage: "np.ndarray | None" = None
        self._last_gnn: "tuple | None" = None
        # replayable mode (make_replayable): a node-removal cascade walks
        # its edges in sorted order
        self._replayable = False
        # edge mirrors built from the store (construction, rebuilds and
        # region overflows)
        self.mirror_builds = 0
        # the roofline's price of a tick reads the params' shapes, which
        # a swap may not change (_swap_params_locked refuses)
        self._scope_consts = {
            "hidden": int(self._params["embed_b"].shape[0]),
            "layers": len(self._params["layers"]),
            "compute_dtype": self._compute_dtype}
        super().__init__(store, cfg, now_s=now_s, device=dev, mesh=mesh,
                         mesh_from_settings=mesh_from_settings)
        # this scorer's ticks and SLO samples carry the backend that
        # produced the verdict
        self.scope.backend = "gnn"

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

    def _mirror_graph_sharded(self) -> bool:
        """Whether a (re)mirror of the CURRENT shapes lands sharded."""
        return self._graph_sharded(self.snapshot.padded_nodes,
                                   self.snapshot.padded_incidents)

    def _mirror_offsets_now(self) -> tuple[int, ...]:
        """The relation-region offsets a re-mirror of the CURRENT store
        derives: both directions of every edge, 1/3 growth slack per
        region and a minimum slice per relation, so first-edge churn of an
        unseen relation lands in a free slot instead of forcing an
        immediate re-mirror. On a graph-sharded mirror these are the
        SHARED per-shard region capacities (the max live count over
        shards, the ``parallel/partition.py`` contract): one tuple
        describes every shard."""
        num_rels = len(RelationKind)
        _, edges = self.store._raw()
        if self._mirror_graph_sharded():
            from ..parallel.sharded_streaming import shared_shard_offsets
            g = self._graph_size()
            nps = self.snapshot.padded_nodes // g
            counts = np.zeros((g, num_rels), np.int64)
            for e in edges:
                srow = self._id_to_idx.get(e.src)
                drow = self._id_to_idx.get(e.dst)
                if srow is None or drow is None:
                    continue
                # each direction lives on its DESTINATION's owner shard
                counts[drow // nps, int(e.kind)] += 1
                counts[srow // nps, int(e.kind)] += 1
            return shared_shard_offsets(counts, slack=1 / 3,
                                        min_cap=REL_SLICE_BUCKETS[0])
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
        re-mirror with re-derived capacities.

        On a graph-sharded mirror the slot space is D stacked per-shard
        region sets: shard g owns slots ``[g·Pe_shard, (g+1)·Pe_shard)``
        with the shared offsets per relation. Each directed entry lives on
        its DESTINATION row's owner shard and stores its dst shard-local;
        src stays global (the tick's ring assembly resolves it). The fill
        keeps the same stable dst sort, so a dst's edges keep store order
        in both layouts, which makes a fresh sharded tick bit-identical
        to the single-device one."""
        self.mirror_builds += 1
        offs = self._mirror_offsets_now()
        num_rels = len(RelationKind)
        pn = self.snapshot.padded_nodes
        self._mirror_sharded = self._mirror_graph_sharded()
        g = self._graph_size() if self._mirror_sharded else 1
        nps = pn // g
        pe_shard = max(int(offs[-1]), 1)
        self._pe_shard = pe_shard
        pe = pe_shard * g
        _, edges = self.store._raw()
        esrc = np.zeros(pe, np.int32)
        # padding dst pinned to the last (shard-local) row
        edst = np.full(pe, nps - 1, np.int32)
        erel = np.full(pe, -1, np.int32)
        emask = np.zeros(pe, np.float32)
        self._edge_slot: dict[_EdgeKey, tuple[int, int]] = {}
        self._node_edges: dict[str, set[_EdgeKey]] = {}
        # (dst_local, src_row, key, is_fwd) per (shard, relation) region,
        # then dst-sorted (one region set when unsharded: dst_local == dst)
        directed: list[list[tuple[int, int, _EdgeKey, bool]]] = [
            [] for _ in range(g * num_rels)]
        for e in edges:
            srow = self._id_to_idx.get(e.src)
            drow = self._id_to_idx.get(e.dst)
            if srow is None or drow is None:   # placeholder outside base rows
                continue
            key = (e.src, e.dst, int(e.kind))
            r = int(e.kind)
            directed[(drow // nps) * num_rels + r].append(
                (drow % nps, srow, key, True))
            directed[(srow // nps) * num_rels + r].append(
                (srow % nps, drow, key, False))
            self._node_edges.setdefault(e.src, set()).add(key)
            self._node_edges.setdefault(e.dst, set()).add(key)
        slots_by_key: dict[_EdgeKey, dict[bool, int]] = {}
        self._free_edge_slots: list[list[int]] = []
        for region in range(g * num_rels):
            gi, r = divmod(region, num_rels)
            base = gi * pe_shard
            ents = directed[region]
            ents.sort(key=lambda t: t[0])   # stable: dst_local only
            fill = base + int(offs[r])
            for d, srow, key, fwd in ents:
                esrc[fill], edst[fill], emask[fill] = srow, d, 1.0
                erel[fill] = r
                slots_by_key.setdefault(key, {})[fwd] = fill
                fill += 1
            # per-(shard, relation) free slot lists (allocation stays
            # region-local, which keeps the static offsets valid)
            self._free_edge_slots.append(
                list(range(base + int(offs[r + 1]) - 1, fill - 1, -1)))
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
        # directed slot -> (src_row, dst_local, rel_kind, mask)
        self._pending_edges: dict[int, tuple[int, int, int, int]] = {}
        self._last_gnn = None
        self._apply_sharding()   # place a sharded mirror on the mesh
        self._quant_refresh()

    # -- the streamed tier's quantized feature table -----------------------

    def _quant_refresh(self) -> None:
        """(Re)derive the quantized feature table and its per-column
        scale from the host features, at every mirror (re)build. The scale
        then stays frozen until the next refresh; each tick's delta rows
        quantize against it (clipped, within the tier's tolerance). None
        on a sharded mirror (the streamed tier is single-device)."""
        if not self._feat_quant or self._mirror_sharded:
            self._features_q_dev = self._feat_scale_dev = None
            self._feat_scale_host = None
            return
        with self._on_stream():
            q, scale = quantize_features(self._upload(self.snapshot.features),
                                         self._feat_quant)
        self._features_q_dev, self._feat_scale_dev = q, scale
        self._feat_scale_host = (None if scale is None
                                 else scale.cpu().numpy())

    def _quant_rows(self, rows: list[int], pk: int) -> np.ndarray:
        """The tick's quantized feature delta: the aux rows' current host
        features quantized against the frozen scale, padded to the
        ``[pk, DIM]`` delta bucket (same slots as the aux delta). float32
        values for the bf16 tier (cast on the device), int8 otherwise."""
        dim = self.snapshot.features.shape[1]
        out = np.zeros((pk, dim), np.float32)
        if rows:
            out[:len(rows)] = self.snapshot.features[rows]
        if self._feat_quant == "bfloat16":
            return out
        scale = self._feat_scale_host
        safe = np.where(scale > 0, scale, 1.0)
        q = np.clip(np.round(out / safe[None, :]), -127, 127)
        return np.where(scale[None, :] > 0, q, 0.0).astype(np.int8)

    # -- journal-driven mirror maintenance --------------------------------

    def _nodes_per_shard(self) -> int:
        return self.snapshot.padded_nodes // (
            self._graph_size() if self._mirror_sharded else 1)

    def _dst_region(self, kind: int, dst_row: int) -> int:
        """Free-list index of the region a directed slot targeting
        ``dst_row`` allocates from: (owner shard, relation) on a sharded
        mirror, the relation alone otherwise."""
        if not self._mirror_sharded:
            return kind
        return (dst_row // self._nodes_per_shard()) * len(RelationKind) \
            + kind

    def _slot_region(self, kind: int, slot: int) -> int:
        """Region index of an EXISTING slot (owner from the slot space)."""
        if not self._mirror_sharded:
            return kind
        return (slot // self._pe_shard) * len(RelationKind) + kind

    def _dst_local(self, row: int) -> int:
        return row % self._nodes_per_shard() if self._mirror_sharded \
            else row

    def _mirror_add(self, src: str, dst: str, kind: int) -> None:
        key = (src, dst, kind)
        if key in self._edge_slot:
            return
        srow = self._id_to_idx.get(src)
        drow = self._id_to_idx.get(dst)
        if srow is None or drow is None:
            return   # endpoint removed later in this batch: edge is gone too
        rf = self._dst_region(kind, drow)   # fwd entry: dst-owner region
        rr = self._dst_region(kind, srow)   # rev entry: src-owner region
        free_f, free_r = self._free_edge_slots[rf], self._free_edge_slots[rr]
        if len(free_f) < (2 if rf == rr else 1) or len(free_r) < 1:
            # a region overflowed: full re-mirror with re-derived
            # capacities (the static offsets can't stretch in place)
            self._mirror_init()
            return
        slot_f, slot_r = free_f.pop(), free_r.pop()
        self._edge_slot[key] = (slot_f, slot_r)
        self._node_edges.setdefault(src, set()).add(key)
        self._node_edges.setdefault(dst, set()).add(key)
        self._pending_edges[slot_f] = (srow, self._dst_local(drow), kind, 1)
        self._pending_edges[slot_r] = (drow, self._dst_local(srow), kind, 1)

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
            # back to ITS region (per (shard, relation) when sharded)
            self._free_edge_slots[self._slot_region(kind, slot)].append(slot)
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
                # records; mirror the cascade from the adjacency. Its order
                # sets the free lists': the set's own order, as the JAX
                # package walks it, or sorted when replayable
                keys = self._node_edges.get(rec[2], ())
                for key in (sorted(keys) if self._replayable
                            else list(keys)):
                    self._mirror_del(key)

    def make_replayable(self) -> None:
        """Make the order a node-removal cascade walks a function of the
        applied journal alone, so that a state restored from a snapshot
        evolves bit for bit as the live one would. A Python set iterates
        in its table's order, which depends on its whole add/discard
        history, and a set rebuilt from its elements (as unpickling
        rebuilds it) can iterate in another; the cascade's order sets the
        free lists. In this mode the cascade walks the keys sorted. The
        crash shield turns this on; off (the default), the cascade walks
        the set as the JAX package does."""
        self._replayable = True

    def _pending_delta_count(self) -> int:
        # each pending edge entry is one directed slot in the packed delta;
        # on a sharded mirror the delta width follows the MAX per-shard
        # count (per-shard sub-buckets bound the ladder)
        if self._mirror_sharded:
            per = [0] * self._graph_size()
            for slot in self._pending_edges:
                per[slot // self._pe_shard] += 1
            return super()._pending_delta_count() + max(per)
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

    def _packed_gnn_delta_sharded(self, aux_rows: list[int]
                                  ) -> tuple[np.ndarray, int, int, list, list]:
        """Per-shard packed delta for ``sharded_gnn_tick``: aux
        (kind/nmask) deltas route to their node-owner shard, edge-slot
        deltas to their slot-owner shard, each with per-shard
        ``DELTA_BUCKETS`` sub-buckets (width = max over shards); the [Pi]
        incident tables ride in every shard's row. Store-journal order is
        kept WITHIN each shard (the router walks the pending maps in
        insertion order). Returns ``(ints [D, L], pk, ek, f_live per
        shard, e_live per shard)``."""
        from ..parallel.sharded_streaming import route_node_delta
        g = self._graph_size()
        pi = self.snapshot.padded_incidents
        nps = self.snapshot.padded_nodes // g

        f_idx, per_aux, pk = route_node_delta(
            [(r,) for r in aux_rows], nps, g, _DELTA_BUCKETS)
        kind_v = np.zeros((g, pk), np.int32)
        nmask_v = np.zeros((g, pk), np.int32)
        for gi, ents in enumerate(per_aux):
            for j, (row,) in enumerate(ents):
                kind_v[gi, j] = self.snapshot.node_kind[row]
                nmask_v[gi, j] = int(self.snapshot.node_mask[row])

        pe_shard = self._pe_shard
        per_edge: list[list] = [[] for _ in range(g)]
        for slot, (srow, dloc, rel, m) in self._pending_edges.items():
            per_edge[slot // pe_shard].append(
                (slot % pe_shard, srow, dloc, rel, m))
        self._pending_edges = {}
        if max(len(e) for e in per_edge) > _DELTA_BUCKETS[-1]:
            # a per-shard delta beyond the ladder: a full re-mirror resets
            # pending entirely
            self._mirror_init()
            per_edge = [[] for _ in range(g)]
            pe_shard = self._pe_shard
        ek = bucket_for(max(max(len(e) for e in per_edge), 1),
                        _DELTA_BUCKETS)
        e_idx = np.full((g, ek), pe_shard, np.int32)
        e_src = np.zeros((g, ek), np.int32)
        e_dst = np.zeros((g, ek), np.int32)
        e_rel = np.full((g, ek), -1, np.int32)
        e_mask = np.zeros((g, ek), np.int32)
        for gi, shard_ents in enumerate(per_edge):
            for j, (sl, s_, d, r, m) in enumerate(shard_ents):
                e_idx[gi, j], e_src[gi, j], e_dst[gi, j] = sl, s_, d
                e_rel[gi, j], e_mask[gi, j] = r, m
        inc_n = np.broadcast_to(
            self.snapshot.incident_nodes.astype(np.int32), (g, pi))
        inc_m = np.broadcast_to(
            self.snapshot.incident_mask.astype(np.int32), (g, pi))
        ints = np.concatenate(
            [f_idx, kind_v, nmask_v, e_idx, e_src, e_dst, e_rel, e_mask,
             inc_n, inc_m], axis=1).astype(np.int32, copy=False)
        return (ints, pk, ek, [len(e) for e in per_aux],
                [len(e) for e in per_edge])

    def _sharded_tick_fn(self, pk: int, ek: int):
        """The sharded learned tick for the CURRENT shapes
        (``parallel/sharded_streaming.sharded_gnn_tick``)."""
        from ..parallel.sharded_streaming import sharded_gnn_tick
        g = self._graph_size()
        return sharded_gnn_tick(
            self.mesh, self.snapshot.padded_nodes // g, self._pe_shard,
            self.snapshot.padded_incidents, pk, ek,
            rel_offsets=self._rel_offsets,
            compute_dtype=self._compute_dtype,
            use_pallas=self._use_fused)

    # -- the tick's tier ----------------------------------------------------

    def _kernel_tier_ok(self, rel_offsets) -> bool:
        """The kernel tiers' common check: compute dtype None or
        "bfloat16", and a non-empty EDGE_TILE-aligned relation layout (the
        current one, or the one given)."""
        offs = self._rel_offsets if rel_offsets is None else rel_offsets
        return (self._compute_dtype in (None, "bfloat16") and len(offs) >= 2
                and int(offs[-1]) > 0 and tiles_align(offs))

    def _fused_ok(self, rel_offsets=None) -> bool:
        """Whether the fused tier serves: ``gnn_fused_tick`` on, a
        single-device mirror and :meth:`_kernel_tier_ok`."""
        return (self._use_fused and not self._mirror_sharded
                and self._kernel_tier_ok(rel_offsets))

    def _dma_ok(self, rel_offsets=None) -> bool:
        """Whether the streamed tier serves: ``gnn_tick_dma`` on,
        :meth:`_kernel_tier_ok`, and a node count that the node block
        (clamped to it) divides. No device-memory threshold: on the card
        both tiers keep their activations in device memory, and their
        float32 verdicts are the same. ``gnn_feature_quant`` without
        ``gnn_tick_dma`` selects nothing."""
        pn = self.snapshot.padded_nodes
        return (self._use_dma and not self._mirror_sharded
                and self._kernel_tier_ok(rel_offsets)
                and pn % min(self._dma_node_block, pn) == 0)

    def _dispatch_dma(self, args: tuple, pk: int, ek: int, pi: int,
                      offs: tuple[int, ...]) -> tuple:
        """One streamed tick over the persistent activation buffers (made
        at the first tick of a node count) and, under a quant tier, the
        resident quantized table with this dispatch's delta rows."""
        params, features = args[0], args[1]
        pn = int(features.shape[0])
        hid = int(params["embed_b"].shape[0])
        nb = min(self._dma_node_block, pn)
        if self._dma_h is None or tuple(self._dma_h[0].shape) != (pn, hid):
            self._dma_h = tuple(torch.zeros((pn, hid), dtype=torch.float32,
                                            device=self.device)
                                for _ in range(2))
        if not self._feat_quant:
            return _gnn_dma_tick(*args, *self._dma_h, pk, ek, pi, offs,
                                 node_block=nb,
                                 compute_dtype=self._compute_dtype)
        fq_rows = self._upload(self._dma_stage_fq).to(
            self._features_q_dev.dtype)
        self._dma_stage_fq = None
        return _gnn_dma_tick_q(params, self._features_q_dev, *args[2:],
                               *self._dma_h, fq_rows, self._feat_scale_dev,
                               pk, ek, pi, offs, node_block=nb,
                               compute_dtype=self._compute_dtype,
                               feat_quant=self._feat_quant)

    def _call_gnn_tick(self, args: tuple, pk: int, ek: int, pi: int,
                       f_live: int, e_live: int, rel_offsets=None) -> tuple:
        """Run one GNN tick through the tier the settings select: the
        streamed tier when :meth:`_dma_ok`, else the fused tier when
        :meth:`_fused_ok`, else the composed :func:`_gnn_tick` (which
        copies the ``f_live``/``e_live`` live prefixes; the kernel tiers
        drop the padding themselves). ``args`` are :func:`_gnn_tick`'s
        first nine operands. Returns ``(logits, probs)``."""
        offs = self._rel_offsets if rel_offsets is None else rel_offsets
        if self._dma_ok(offs):
            return self._dispatch_dma(args, pk, ek, pi, offs)
        if self._fused_ok(offs):
            return _gnn_fused_tick(*args, pk, ek, pi, offs,
                                   compute_dtype=self._compute_dtype)
        return _gnn_tick(*args, pk, ek, pi, f_live, e_live, offs,
                         self._compute_dtype)

    def _tick_entrypoint(self) -> str:
        """Cost-model entry point of the tier :meth:`_call_gnn_tick` will
        launch for the current layout: the roofline prices the variant
        that actually serves (the streamed tiers move their activations
        and quantized tables through device memory, the fused tier does
        not, the composed tick materializes each layer; the sharded tick
        adds its ring)."""
        offs = self._rel_offsets
        if self._mirror_sharded:
            return "streaming.gnn_tick.sharded"
        if self._dma_ok(offs):
            if self._feat_quant == "int8":
                return "streaming.gnn_tick.dma.int8"
            if self._feat_quant == "bfloat16":
                return "streaming.gnn_tick.dma.bf16"
            return "streaming.gnn_tick.dma"
        if self._fused_ok(offs):
            return ("streaming.gnn_tick.fused.bf16"
                    if self._compute_dtype == "bfloat16"
                    else "streaming.gnn_tick.fused")
        return "streaming.gnn_tick.bucketed"

    def _scope_gnn(self, span, pk: int, ek: int) -> None:
        """Roofline-model the GNN tick at its live padded shapes (priced
        once per shape key). The GNN tick supersedes the rules tick as
        the entry point this scorer reports: its verdict is the one
        served."""
        if span is None:
            return
        pi = self.snapshot.padded_incidents
        pn = self.snapshot.padded_nodes
        pe = self._pe_shard   # the whole mirror when unsharded
        shards = {"shards": self._graph_size()} if self._mirror_sharded \
            else {}
        self._scope_entry = self._tick_entrypoint()
        self._scope_key = (pn, pi, pe, pk, ek) + tuple(shards.values())
        obs_scope.ROOFLINE.model(
            self._scope_entry, self._scope_key,
            lambda: {"pn": pn, "pi": pi, "pe": pe, "pk": pk, "ek": ek,
                     **shards, **self._scope_consts}, pack=self._scope_pack)

    def dispatch(self) -> tuple:
        """The base tick (shared feature delta + rules score), then the GNN
        tick on the UPDATED features. The edge-journal drain and the GNN
        delta pack run BEFORE the base dispatch, so the packed GNN ints
        ride the base scorer's staged slab (one host→device copy); under a
        quant tier the aux rows' quantized features are staged beside
        them. Returns the base device outputs; the GNN outputs land in
        ``_last_gnn``.

        On a sharded mirror the base tick (the sharded rules tick, which
        updates the feature node blocks in place) runs first, then the
        per-shard GNN delta is packed, uploaded once per device, and
        ``sharded_gnn_tick`` runs each position on its own stream, joined
        into the scorer's before the tick's ``done`` event."""
        aux_rows = self._pending_feat.keys()
        self._drain_edges()
        if self._mirror_sharded:
            return self._dispatch_sharded(list(aux_rows))
        ints, pk, ek, f_live, e_live = self._packed_gnn_delta(aux_rows)
        if self._feat_quant:
            self._dma_stage_fq = self._quant_rows(aux_rows, pk)
        self._gnn_stage = ints
        try:
            out = super().dispatch()
        finally:
            self._gnn_stage = None
        span = self._last_tick_span   # opened by the base dispatch
        ints_dev, self._staged_gnn_dev = self._staged_gnn_dev, None
        features = self._features_dev
        with self._on_stream():
            if ints_dev is None:
                # a base tick on a mesh stages no extra payload: the GNN
                # delta pays its own copy
                ints_dev = self._upload(ints)
            if not isinstance(features, torch.Tensor):
                # the base features replicated over a mesh the mirror does
                # not shard over: every block is the whole table
                features = features.blocks[0, 0]
        args = (self._params, features, self._kind_dev,
                self._nmask_dev, self._esrc_dev, self._edst_dev,
                self._erel_dev, self._emask_dev, ints_dev)
        self._scope_gnn(span, pk, ek)
        with self._on_stream():
            logits, probs = self._call_gnn_tick(
                args, pk, ek, self.snapshot.padded_incidents, f_live, e_live)
        self._last_gnn = (self.params_generation, logits, probs)
        if span is not None:
            span.mark("gnn_dispatch")
        return out

    def _dispatch_sharded(self, aux_rows: list[int]) -> tuple:
        """:meth:`dispatch` on a sharded mirror (see there)."""
        self._gnn_stage = None
        out = super().dispatch()
        span = self._last_tick_span   # opened by the base dispatch
        ints, pk, ek, f_live, e_live = self._packed_gnn_delta_sharded(
            aux_rows)
        tick = self._sharded_tick_fn(pk, ek)
        self._scope_gnn(span, pk, ek)
        from ..parallel import compat
        with self._on_stream():
            # one copy per card, on the stream of the card's first position
            ints_dev, _ = compat.upload(
                self.mesh, torch.from_numpy(np.ascontiguousarray(ints)),
                copy=True)
            logits, probs = tick(
                self._params, self._features_dev, self._kind_dev,
                self._nmask_dev, self._esrc_dev, self._edst_dev,
                self._erel_dev, self._emask_dev, ints_dev, f_live, e_live)
        self._last_gnn = (self.params_generation, logits, probs)
        if span is not None:
            span.mark("gnn_dispatch")
        return out

    def _apply_sharding(self) -> None:
        """The base placement, then a sharded mirror's six arrays as node
        or slot blocks over ``graph`` (a tensor already placed stays
        where it is)."""
        super()._apply_sharding()
        if not getattr(self, "_mirror_sharded", False):
            return
        from ..parallel.compat import place
        from ..parallel.mesh import graph_sharded
        gsh = graph_sharded(self.mesh)
        with self._on_stream():
            for name in ("_kind_dev", "_nmask_dev", "_esrc_dev", "_edst_dev",
                         "_erel_dev", "_emask_dev"):
                t = getattr(self, name, None)
                if isinstance(t, torch.Tensor):
                    setattr(self, name, place(t, gsh))

    def adopt_mesh(self, mesh) -> None:
        """Live resharding for the learned scorer. The base reshard
        re-derives the features and evidence tables from host truth at
        the new placement; the edge mirror additionally RE-BUCKETS (the
        per-(shard, relation) regions, shard-local dst rows and shared
        offsets are all functions of D), so :meth:`_mirror_init` re-places
        every edge on its dst-owner shard under the new mesh and resets
        kind/nmask from the host snapshot: the dst-sorted layout a fresh
        D' build lays out, which is why the healed scorer serves the
        verdicts of a fresh D' build. A mesh with no real ``graph`` axis
        serves the single-device mirror (``None``)."""
        if mesh is not None and ("graph" not in mesh.axis_names
                                 or mesh.shape["graph"] <= 1):
            mesh = None
        # the OLD layout's mirror cannot be placed on the new mesh (its
        # stacked slot space is sized for the old D): drop it so the base
        # reshard's placement skips it, then rebuild at the new layout
        self._mirror_sharded = False
        for name in ("_kind_dev", "_nmask_dev", "_esrc_dev", "_edst_dev",
                     "_erel_dev", "_emask_dev"):
            setattr(self, name, None)
        super().adopt_mesh(mesh)
        self._mirror_init()

    def _tick_handles(self, out: tuple) -> _Tick:
        """In GNN mode the queue tracks the GNN tick's outputs
        ``(params generation, logits, probs)``: the generation the tick
        dispatched against travels with it, so a deferred fetch after a
        hot swap reports the generation that produced the verdict."""
        return _Tick(self._last_gnn, self._record())

    def _fetch_verdicts(self, handles: _Tick, span, stats: dict,
                        queue_wait_s: float, dispatch_s: float) -> dict:
        """GnnRcaBackend.score_snapshot-shaped raw dict for live incidents:
        one wait and one readback of the probs (the base class's scope
        stamps around them)."""
        t2 = time.perf_counter()
        self._fault_point("fetch")
        self._wait(handles)
        if span is not None:
            span.mark("execute")
        tick_gen, _logits, probs = handles.out
        with self._on_stream():
            probs = probs.cpu().numpy()
        fetch_s = time.perf_counter() - t2
        if span is not None:
            self._scope_fetched(span)
        self.fetches += 1
        obs_metrics.SERVE_FETCHED_BYTES.inc(float(probs.nbytes),
                                            path="gnn_rescore")
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
        obs_metrics.LEARN_GENERATION.set(float(self.params_generation))
        obs_scope.FLIGHT_RECORDER.note_event(
            "params_swap", generation=self.params_generation,
            source=source, backend="gnn")
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
        obs_metrics.LEARN_SWAPS.inc()
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
        obs_metrics.LEARN_ROLLBACKS.inc()
        return gen

    # -- crash-shield seams (snapshot/restore) -----------------------------

    _HOST_STATE_ATTRS = StreamingScorer._HOST_STATE_ATTRS + (
        "_gnn_seq", "_rel_offsets",
        "_edge_slot", "_node_edges", "_free_edge_slots", "_pending_edges",
        "_mirror_sharded", "_pe_shard",
        # the generation/source stamp travels with the snapshot so a
        # restore serves the generation it captured (the params VALUES
        # ride in the packed device tensors below), and so does the
        # quantized table's frozen scale
        "params_generation", "_params_source", "_feat_scale_host",
    )

    _MIRROR_ARRAYS = 6   # kind/nmask + the four edge arrays

    def _quant_arrays(self) -> list:
        """The streamed tier's quantized table and its scale (none at
        float32, the table alone for bf16, both for int8)."""
        if not self._feat_quant:
            return []
        return [t for t in (self._features_q_dev, self._feat_scale_dev)
                if t is not None]

    def _resident_arrays(self) -> list:
        # the serving params are part of the resident state: packing
        # their leaves makes recovery restore the EXACT swapped checkpoint
        # bit for bit, with no reload from a checkpoint file that may have
        # moved on; the quantized table rides along so its frozen scale
        # and in-place rows come back as they were
        return super()._resident_arrays() + [
            self._kind_dev, self._nmask_dev, self._esrc_dev,
            self._edst_dev, self._erel_dev, self._emask_dev,
            *self._quant_arrays(),
            *gnn.flat_params(self._params).values()]

    def _adopt_resident(self, parts: list) -> None:
        # the mirrors first: the base's placement then lays them out too
        m = 4 + self._MIRROR_ARRAYS
        (self._kind_dev, self._nmask_dev, self._esrc_dev, self._edst_dev,
         self._erel_dev, self._emask_dev) = parts[4:m]
        super()._adopt_resident(parts)
        keys = list(gnn.flat_params(self._params))
        nq = len(parts) - m - len(keys)
        want = {"": 0, "bfloat16": 1}.get(self._feat_quant, 2)
        if nq != want:
            raise RuntimeError(
                f"snapshot carries {nq} quantized-table tensors; this "
                f"scorer's gnn_feature_quant={self._feat_quant!r} needs "
                f"{want}")
        if nq:
            self._features_q_dev = parts[m]
            self._feat_scale_dev = parts[m + 1] if nq > 1 else None
        # leaves packed after the mirrors: the CURRENT tree's keys (same
        # model config by construction: the shield matches the class)
        self._params = gnn.unflat_params(dict(zip(keys, parts[m + nq:])))
        self._params_prev = None
        self._last_gnn = None
        self._dma_h = None   # scratch: shapes may differ after a restore

    def _attest_arrays(self) -> list:
        # the aux mirrors are node-addressed with exact host truth; the
        # edge regions are not attested (their slot layout is allocation
        # history, not mirrored row by row on the host)
        return super()._attest_arrays() + [
            ("_kind_dev", self.snapshot.node_kind),
            ("_nmask_dev", self.snapshot.node_mask)]

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
