"""Multi-tenant packing: many cluster stores, ONE resident serving state,
cross-tenant verdicts in one device pass.

One resident :class:`~.streaming.StreamingScorer` per cluster store means
N tenants cost N feature tables, N evidence tables and N rules-fold
launches a verdict round. This module packs every tenant onto one scorer:

* **Slot-space namespacing.** The node and incident slot spaces are carved
  into contiguous per-tenant REGIONS, each sized by the tenant's own bucket
  ladder rungs. Host bookkeeping keys node ids as ``tenant::local_id``;
  evidence slots carry GLOBAL node rows, so the base scorer's tick (delta
  copies into the resident tensors, then one ``kernels/rules_fold``
  launch) runs unchanged over the pack and scores every tenant's live
  incidents at once.

* **Per-tenant journal cursors.** ``sync()`` drains EVERY tenant store's
  change journal into the shared pending deltas: many webhook writers, one
  coalesced tick stream. Each tenant's incident region carries one rung of
  arrival headroom; a region that still overflows triggers the
  INCREMENTAL repack (``_repack``): only the overflowing tenant
  re-tensorizes, the kept regions' host mirrors move by a row shift.

* **Per-tenant quarantine.** A poisoned delta (non-finite staged rows) or
  a truncated journal quarantines ONLY the offending tenant: its rows drop
  out of the staged delta, its journal stops draining, and the next sync
  HEALS it from its store (a region re-mirror staged as in-place deltas
  through the shared tick). The other tenants keep ticking.

:class:`SurgeServer` is the process-wide front-end the workflow workers
attach to: a FLEET of packs on one device, tenants bin-packed onto them by
load, with live migration between packs journaled in a small fleet WAL.

Not ported on purpose (ROADMAP §A): the warm-growth shapes and warm
threads (a hand kernel compiles once). The graph-sharded resident state
is ROADMAP item 9: on one card a pack is never graph-sharded.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import threading
import time
from contextlib import ExitStack
from dataclasses import dataclass
from typing import Iterable, Mapping

import numpy as np
import torch

from ..config import Settings, get_settings
from ..device import resolve_device
from ..graph.schema import EntityKind, RelationKind
from ..graph.snapshot import GraphSnapshot, build_snapshot
from ..graph.store import EvidenceGraphStore
from ..ladders import DELTA_BUCKETS as _DELTA_BUCKETS
from ..observability import get_logger
from ..observability import metrics as obs_metrics
from ..observability import scope as obs_scope
from ..utils.padding import bucket_for
from .streaming import FeatureStage, StreamingScorer

log = get_logger("surge")

NS_SEP = "::"


def tenant_node_id(tenant: str, node_id: str) -> str:
    """The pack's slot-space id for a tenant-local store node id."""
    return f"{tenant}{NS_SEP}{node_id}"


def split_tenant_id(nsid: str) -> tuple[str, str]:
    """(tenant, local_id) of a namespaced slot-space id."""
    tenant, sep, local = nsid.partition(NS_SEP)
    if not sep:
        return "default", nsid
    return tenant, local


@dataclass
class TenantRegion:
    """One tenant's contiguous slice of the packed slot spaces."""
    name: str
    store: EvidenceGraphStore
    node_base: int = 0
    pn: int = 0
    inc_base: int = 0
    pi: int = 0
    synced_seq: int = 0
    quarantined: bool = False
    heal_pending: bool = False
    quarantines: int = 0
    rebuilds: int = 0


class MultiTenantScorer(StreamingScorer):
    """StreamingScorer over a PACK of tenant stores (see module doc).

    The base class's mutation API, delta staging and pipelined executor
    (tick_async/absorb/rescore_newest) operate on the packed state
    unchanged; this subclass re-derives initialisation per tenant region,
    routes allocation and store lookups through the id's tenant, drains
    every tenant's journal in ``sync()``, and adds the quarantine/heal
    ladder. It has no single ``store``."""

    def __init__(self, stores: "Mapping[str, EvidenceGraphStore] | Iterable[tuple[str, EvidenceGraphStore]]",
                 settings: Settings | None = None,
                 now_s: float | None = None,
                 device: "str | torch.device | None" = None) -> None:
        items = dict(stores)
        if not items:
            raise ValueError("MultiTenantScorer needs at least one tenant")
        self._tenant_stores: dict[str, EvidenceGraphStore] = items
        self.tenant_rebuilds = 0
        self.partial_repacks = 0
        self.quarantines = 0
        super().__init__(store=None, settings=settings, now_s=now_s,
                         device=device)

    # -- identity / region seams ------------------------------------------

    def _tenant_count(self) -> int:
        return len(self._tenant_stores)

    def serving_node_id(self, node_id: str, tenant: str = "default") -> str:
        return tenant_node_id(tenant, node_id)

    def _canon_incident_id(self, incident_node_id: str) -> str:
        # journal-driven ids arrive canonical and namespaced already
        return incident_node_id

    def _region_of_node_row(self, row: int) -> TenantRegion:
        i = bisect.bisect_right(self._node_bases, row) - 1
        return self._regions_order[i]

    def _region_of_inc_row(self, r: int) -> TenantRegion:
        i = bisect.bisect_right(self._inc_bases, r) - 1
        return self._regions_order[i]

    def _node_row_available(self, node_id: str) -> bool:
        return bool(self._free_node_rows.get(split_tenant_id(node_id)[0]))

    def _take_node_row(self, node_id: str) -> int:
        return self._free_node_rows[split_tenant_id(node_id)[0]].pop()

    def _put_node_row(self, row: int) -> None:
        self._free_node_rows[self._region_of_node_row(row).name].append(row)

    def _inc_row_available(self, node_id: str) -> bool:
        return bool(self._free_inc_rows.get(split_tenant_id(node_id)[0]))

    def _take_inc_row(self, node_id: str) -> int:
        return self._free_inc_rows[split_tenant_id(node_id)[0]].pop()

    def _put_inc_row(self, row: int) -> None:
        self._free_inc_rows[self._region_of_inc_row(row).name].append(row)

    def _store_node(self, node_id: str):
        tenant, local = split_tenant_id(node_id)
        store = self._tenant_stores.get(tenant)
        return None if store is None else store._nodes.get(local)

    # -- (re)initialisation: the pack -------------------------------------

    def _alloc_pack(self, pn: int, pi: int, dim: int,
                    node_kind_dtype, inc_dtype) -> None:
        """Fresh packed snapshot mirror + empty global host structures at
        total shape (pn, pi). Edge arrays stay empty: they feed only the
        base single-store init path; the pack mirrors per region."""
        self.snapshot = GraphSnapshot(
            node_ids=(), incident_ids=(),
            num_nodes=0, num_edges=0, num_incidents=0,
            node_kind=np.zeros(pn, node_kind_dtype),
            features=np.zeros((pn, dim), np.float32),
            node_mask=np.zeros(pn, np.float32),
            edge_src=np.zeros(0, np.int32), edge_dst=np.zeros(0, np.int32),
            edge_rel=np.zeros(0, np.int32),
            edge_mask=np.zeros(0, np.float32),
            incident_nodes=np.zeros(pi, inc_dtype),
            incident_mask=np.zeros(pi, np.float32),
        )
        self._node_ids = [None] * pn
        self._id_to_idx = {}
        self._free_node_rows: dict[str, list[int]] = {}
        self._inc_row_of = {}
        self._row_inc = [None] * pi
        self._free_inc_rows: dict[str, list[int]] = {}
        self._pod_node = {}
        self._sched_pods = {}
        self._row_nodes = [[] for _ in range(pi)]
        self._row_pairs = [[] for _ in range(pi)]
        self._pair_map = [{} for _ in range(pi)]
        self._ev_rows_of_node = {}

    def _finalize_pack(self) -> None:
        """Derive widths + rebuild the resident device state from the
        freshly packed host mirror (shared tail of the full init and the
        incremental repack)."""
        pi = self.snapshot.padded_incidents
        self._node_bases = [r.node_base for r in self._regions_order]
        self._inc_bases = [r.inc_base for r in self._regions_order]
        self.width, self.pair_width = self._rebuild_widths()
        with self._on_stream():
            self._features_dev = self._upload(self.snapshot.features)
            self._upload_tables()
            self._chain0 = torch.zeros(pi, dtype=torch.float32,
                                       device=self.device)
        self._pending_feat = FeatureStage(self.snapshot.features.shape[1])
        self._dirty_rows = set()
        self._synced_seq = 0   # unused by the pack (per-region cursors)

    def _init_from_store(self) -> None:
        """Tensorize EVERY tenant store and pack the per-tenant snapshots
        into one resident state with contiguous regions. Per-tenant
        journal cursors are captured BEFORE tensorizing (the base
        scorer's replay-idempotence argument, per store)."""
        self._drop_stale_inflight()
        packs: list[tuple[TenantRegion, GraphSnapshot]] = []
        self.regions: dict[str, TenantRegion] = {}
        self._regions_order: list[TenantRegion] = []
        node_base = inc_base = 0
        for name, store in self._tenant_stores.items():
            seq = store.journal_seq
            snap = build_snapshot(store, self.settings, slack=1 / 3,
                                  now_s=self.now_s)
            reg = TenantRegion(name=name, store=store,
                               node_base=node_base, pn=snap.padded_nodes,
                               inc_base=inc_base,
                               pi=self._region_pi(snap.padded_incidents),
                               synced_seq=seq)
            self.regions[name] = reg
            self._regions_order.append(reg)
            node_base += reg.pn
            inc_base += reg.pi
            packs.append((reg, snap))
        first = packs[0][1]
        self._alloc_pack(node_base, inc_base, first.features.shape[1],
                         first.node_kind.dtype, first.incident_nodes.dtype)
        for reg, snap in packs:
            self._mirror_region(reg, snap)
        self._finalize_pack()

    def _rebuild(self) -> None:
        """Pack rebuild on bucket overflow. Unlike the base scorer's
        whole-store re-tensorize, the pack repacks INCREMENTALLY: only
        tenants whose stores outgrew their regions (or whose free rows ran
        dry) pay the per-tenant tensorize; every other region's host
        mirror MOVES (row-shifted numpy/dict copies)."""
        self.rebuilds += 1
        if getattr(self, "_regions_order", None):
            self._repack()
        else:
            self._init_from_store()

    def _repack(self) -> None:
        self._drop_stale_inflight()
        old_snapshot = self.snapshot
        old = {
            "node_ids": self._node_ids, "row_inc": self._row_inc,
            "free_nodes": self._free_node_rows,
            "free_incs": self._free_inc_rows,
            "pod_node": self._pod_node, "sched_pods": self._sched_pods,
            "row_nodes": self._row_nodes, "row_pairs": self._row_pairs,
            "pair_map": self._pair_map, "ev_rows": self._ev_rows_of_node,
        }
        old_bases = {r.name: (r.node_base, r.inc_base)
                     for r in self._regions_order}
        incident_kind = int(EntityKind.INCIDENT)
        plans: list[tuple[TenantRegion, GraphSnapshot | None]] = []
        node_base = inc_base = 0
        retensorized = []
        for reg in self._regions_order:
            store = reg.store
            live_inc = sum(1 for n in store._nodes.values()
                           if int(n.kind) == incident_kind)
            need_pn = bucket_for(
                max(int(np.ceil(len(store._nodes) * 4 / 3)), 1),
                self.settings.node_bucket_sizes)
            need_pi = bucket_for(max(int(np.ceil(live_inc * 4 / 3)), 1),
                                 self.settings.incident_bucket_sizes)
            keep = (need_pn <= reg.pn and need_pi <= reg.pi
                    and bool(old["free_nodes"].get(reg.name))
                    and bool(old["free_incs"].get(reg.name))
                    and not reg.quarantined and not reg.heal_pending)
            if keep:
                snap = None               # mirror moves; sizes unchanged
            else:
                reg.synced_seq = store.journal_seq
                snap = build_snapshot(store, self.settings, slack=1 / 3,
                                      now_s=self.now_s)
                reg.pn = max(snap.padded_nodes, need_pn)
                reg.pi = self._region_pi(
                    max(snap.padded_incidents, need_pi))
                reg.quarantined = False
                reg.heal_pending = False
                retensorized.append(reg.name)
            reg.node_base, reg.inc_base = node_base, inc_base
            node_base += reg.pn
            inc_base += reg.pi
            plans.append((reg, snap))
        self._alloc_pack(node_base, inc_base,
                         old_snapshot.features.shape[1],
                         old_snapshot.node_kind.dtype,
                         old_snapshot.incident_nodes.dtype)
        for reg, snap in plans:
            if snap is None:
                onb, oib = old_bases[reg.name]
                self._shift_region(old, old_snapshot, reg, onb, oib)
            else:
                self._mirror_region(reg, snap)
        self._finalize_pack()
        self.partial_repacks += 1
        log.warning("pack_repacked", retensorized=retensorized,
                    kept=[r.name for r in self._regions_order
                          if r.name not in retensorized])

    def _shift_region(self, old: dict, osnap: GraphSnapshot,
                      reg: TenantRegion, onb: int, oib: int) -> None:
        """Move one kept region's host mirror from its old bases to its
        new ones: numpy slice copies for the packed arrays, constant row
        shifts for every bookkeeping structure. Evidence and scheduling
        references never cross tenants, so the shift is closed over the
        region by construction. Pending feature values already live in
        the snapshot mirror (update_nodes writes both), so the post-pack
        device re-upload subsumes them."""
        nb, ib = reg.node_base, reg.inc_base
        dn, di = nb - onb, ib - oib
        self.snapshot.features[nb:nb + reg.pn] = \
            osnap.features[onb:onb + reg.pn]
        self.snapshot.node_kind[nb:nb + reg.pn] = \
            osnap.node_kind[onb:onb + reg.pn]
        self.snapshot.node_mask[nb:nb + reg.pn] = \
            osnap.node_mask[onb:onb + reg.pn]
        self.snapshot.incident_nodes[ib:ib + reg.pi] = \
            osnap.incident_nodes[oib:oib + reg.pi] + dn
        self.snapshot.incident_mask[ib:ib + reg.pi] = \
            osnap.incident_mask[oib:oib + reg.pi]
        for i in range(reg.pn):
            nid = old["node_ids"][onb + i]
            self._node_ids[nb + i] = nid
            if nid is not None:
                self._id_to_idx[nid] = nb + i
        self._free_node_rows[reg.name] = [
            r + dn for r in old["free_nodes"][reg.name]]
        for r in range(reg.pi):
            iid = old["row_inc"][oib + r]
            self._row_inc[ib + r] = iid
            if iid is not None:
                self._inc_row_of[iid] = ib + r
            self._row_nodes[ib + r] = [n + dn
                                       for n in old["row_nodes"][oib + r]]
            self._row_pairs[ib + r] = list(old["row_pairs"][oib + r])
            self._pair_map[ib + r] = dict(old["pair_map"][oib + r])
        self._free_inc_rows[reg.name] = [
            r + di for r in old["free_incs"][reg.name]]
        for pod, node in old["pod_node"].items():
            if onb <= pod < onb + reg.pn:
                self._pod_node[pod + dn] = node + dn
        for node, pods in old["sched_pods"].items():
            if onb <= node < onb + reg.pn:
                self._sched_pods[node + dn] = {p + dn for p in pods}
        for node, rows in old["ev_rows"].items():
            if onb <= node < onb + reg.pn:
                self._ev_rows_of_node[node + dn] = {r + di for r in rows}

    def _region_pi(self, padded: int) -> int:
        """A tenant's incident region = its store-derived bucket PLUS one
        rung of arrival headroom: incident rows are the cheap axis of the
        resident state (int slot tables, no [Pn, DIM] features), and one
        spare rung absorbs a burst of concurrent incidents in place
        instead of paying a repack that pauses every tenant for a round."""
        return bucket_for(padded + 1, self.settings.incident_bucket_sizes)

    def _mirror_region(self, reg: TenantRegion, snap: GraphSnapshot) -> None:
        """Install one tenant's snapshot into its region: packed array
        slices, namespaced id maps, region free lists, and the evidence /
        scheduled-on host bookkeeping at GLOBAL rows. Used by the initial
        pack (snap shapes == region shapes) and by a heal (snap may have
        shrunk: the region's tail rows become free)."""
        t, nb, ib = reg.name, reg.node_base, reg.inc_base
        spn, spi = snap.padded_nodes, snap.padded_incidents
        self.snapshot.features[nb:nb + spn] = snap.features
        self.snapshot.features[nb + spn:nb + reg.pn] = 0.0
        self.snapshot.node_kind[nb:nb + spn] = snap.node_kind
        self.snapshot.node_kind[nb + spn:nb + reg.pn] = 0
        self.snapshot.node_mask[nb:nb + spn] = snap.node_mask
        self.snapshot.node_mask[nb + spn:nb + reg.pn] = 0.0
        self.snapshot.incident_nodes[ib:ib + spi] = snap.incident_nodes + nb
        self.snapshot.incident_nodes[ib + spi:ib + reg.pi] = 0
        self.snapshot.incident_mask[ib:ib + spi] = snap.incident_mask
        self.snapshot.incident_mask[ib + spi:ib + reg.pi] = 0.0

        for i, nid in enumerate(snap.node_ids):
            gid = tenant_node_id(t, nid)
            self._node_ids[nb + i] = gid
            self._id_to_idx[gid] = nb + i
        self._free_node_rows[t] = list(
            range(nb + reg.pn - 1, nb + snap.num_nodes - 1, -1))
        for r, iid in enumerate(snap.incident_ids):
            gid = tenant_node_id(t, iid)
            self._inc_row_of[gid] = ib + r
            self._row_inc[ib + r] = gid
        self._free_inc_rows[t] = list(
            range(ib + reg.pi - 1, ib + snap.num_incidents - 1, -1))

        live = snap.edge_mask > 0
        sched = live & (snap.edge_rel == int(RelationKind.SCHEDULED_ON))
        for pos in np.nonzero(sched)[0]:
            s, d = int(snap.edge_src[pos]), int(snap.edge_dst[pos])
            pod, node = ((s, d) if snap.node_kind[s] == int(EntityKind.POD)
                         else (d, s))
            self._set_pod_node(nb + pod, nb + node)
        is_ev = live & ((snap.edge_rel == int(RelationKind.AFFECTS))
                        | (snap.edge_rel == int(RelationKind.CORRELATES_WITH)))
        inc_row = np.full(spn, -1, dtype=np.int64)
        real = snap.incident_mask > 0
        inc_row[snap.incident_nodes[real]] = np.arange(int(real.sum()))
        for pos in np.nonzero(is_ev)[0]:
            r = int(inc_row[snap.edge_src[pos]])
            if r < 0:
                continue   # undirected duplicate (dst is the incident)
            self._append_evidence_host(ib + r, nb + int(snap.edge_dst[pos]))

    # -- multi-journal sync + quarantine/heal ------------------------------

    def _ns_record(self, tenant: str, rec: tuple) -> tuple:
        op = rec[1]
        if op in ("edge+", "edge-"):
            return (rec[0], op, tenant_node_id(tenant, rec[2]),
                    tenant_node_id(tenant, rec[3]), *rec[4:])
        return (rec[0], op, tenant_node_id(tenant, rec[2]), *rec[3:])

    def sync(self) -> dict:
        """Drain EVERY tenant's store journal into the packed resident
        state: one coalesced delta stream for N webhook writers.
        Quarantined tenants heal first (region re-mirror) and skip the
        drain; a truncated journal quarantines + heals only its tenant; a
        region overflow mid-batch escalates to a repack, which re-captures
        every re-tensorized cursor (remaining records are reflected)."""
        self.syncs += 1
        totals = {"applied": 0, "structural": 0, "feature": 0,
                  "rebuilt": False, "healed": 0}
        for reg in self._regions_order:
            if reg.heal_pending:
                rb0 = self.rebuilds
                self._heal(reg)
                totals["healed"] += 1
                if self.rebuilds != rb0:   # heal escalated to a repack
                    totals["rebuilt"] = True
                    return totals
        for reg in self._regions_order:
            if reg.quarantined:
                continue
            recs, seq, truncated = reg.store.journal_since(reg.synced_seq)
            if truncated:
                self.quarantine(reg.name, "journal_truncated")
                rb0 = self.rebuilds
                self._heal(reg)
                totals["healed"] += 1
                if self.rebuilds != rb0:
                    totals["rebuilt"] = True
                    return totals
                continue
            if recs:
                rb0 = self.rebuilds
                res = self._apply_records(
                    [self._ns_record(reg.name, r) for r in recs])
                totals["applied"] += res["applied"]
                totals["structural"] += res.get("structural", 0)
                totals["feature"] += res.get("feature", 0)
                if self.rebuilds != rb0:
                    totals["rebuilt"] = True
                    return totals
            reg.synced_seq = max(seq, reg.synced_seq)
        self._note_queue_depths()
        return totals

    def _journal_backlog(self) -> int:
        """The pack's undrained backlog is the SUM over tenant journals
        (quarantined regions excluded: their journal deliberately stops
        draining until the heal)."""
        return sum(
            max(int(reg.store.journal_seq) - int(reg.synced_seq), 0)
            for reg in self._regions_order if not reg.quarantined)

    def _note_queue_depths(self) -> None:
        counts = {reg.name: 0 for reg in self._regions_order}
        for row in self._pending_feat.keys():
            counts[self._region_of_node_row(row).name] += 1
        for r in self._dirty_rows:
            counts[self._region_of_inc_row(r).name] += 1
        for name, c in counts.items():
            obs_metrics.SERVE_TENANT_QUEUE_DEPTH.set(float(c), tenant=name)

    def _scrub_region(self, reg: TenantRegion) -> None:
        """Drop the region's staged feature rows and dirty incident rows
        (a quarantined or released tenant's deltas must not reach the
        resident state)."""
        self._pending_feat.discard_range(reg.node_base,
                                         reg.node_base + reg.pn)
        ib, ie = reg.inc_base, reg.inc_base + reg.pi
        self._dirty_rows = {r for r in self._dirty_rows if not ib <= r < ie}

    def quarantine(self, tenant: str, reason: str) -> None:
        """Take one tenant off the shared tick: its staged deltas drop,
        its journal stops draining, and the next sync() heals its region
        from store truth. Every OTHER tenant keeps ticking: the
        failure-isolation contract of the pack."""
        reg = self.regions[tenant]
        if not reg.quarantined:
            reg.quarantined = True
            reg.heal_pending = True
            reg.quarantines += 1
            self.quarantines += 1
            obs_metrics.SERVE_TENANT_QUARANTINES.inc(tenant=tenant)
            obs_scope.FLIGHT_RECORDER.note_event(
                "tenant_quarantined", tenant=tenant, reason=reason)
            log.warning("tenant_quarantined", tenant=tenant, reason=reason)
        self._scrub_region(reg)

    def _heal(self, reg: TenantRegion) -> None:
        """Region-scoped store-derived re-mirror: the per-tenant rebuild.
        Re-tensorizes ONLY this tenant's store and stages its whole region
        as in-place deltas through the shared tick: the other tenants'
        resident rows and in-flight results are untouched. Escalates to a
        repack when the fresh store outgrew the region, or when the region
        itself exceeds the delta ladder a staged re-mirror must ride."""
        seq = reg.store.journal_seq
        snap = build_snapshot(reg.store, self.settings, slack=1 / 3,
                              now_s=self.now_s)
        if (snap.padded_nodes > reg.pn or snap.padded_incidents > reg.pi
                or reg.pn > _DELTA_BUCKETS[-1]):
            log.warning("tenant_region_outgrown", tenant=reg.name,
                        region_pn=reg.pn, need_pn=snap.padded_nodes,
                        region_pi=reg.pi, need_pi=snap.padded_incidents)
            self._rebuild()
            return
        self._clear_region(reg)
        self._mirror_region(reg, snap)
        # stage the WHOLE region: every node row ships as a feature delta
        # (zeros for dead rows: stale resident rows must fold 0) and every
        # incident row re-ships its slot tables
        for row in range(reg.node_base, reg.node_base + reg.pn):
            self._pending_feat[row] = self.snapshot.features[row]
        self._dirty_rows.update(range(reg.inc_base, reg.inc_base + reg.pi))
        rb0 = self.rebuilds
        w, pw = self._rebuild_widths()
        if w > self.width:
            self._grow(self._grow_width)
        if self.rebuilds == rb0 and pw > self.pair_width:
            self._grow(self._grow_pair_width)
        if self.rebuilds != rb0:
            return   # growth ladder exhausted: the repack superseded us
        reg.synced_seq = seq
        reg.quarantined = False
        reg.heal_pending = False
        reg.rebuilds += 1
        self.tenant_rebuilds += 1
        obs_metrics.SERVE_TENANT_REBUILDS.inc(tenant=reg.name)
        obs_scope.FLIGHT_RECORDER.note_event("tenant_healed",
                                             tenant=reg.name)
        log.info("tenant_healed", tenant=reg.name,
                 staged_rows=reg.pn, dirty_rows=reg.pi)

    def _clear_region(self, reg: TenantRegion) -> None:
        """Forget one region's host bookkeeping (its packed array slices
        are overwritten by the following _mirror_region). Evidence and
        scheduled-on references never cross tenants, so the sweep is
        region-local by construction."""
        nb, ne = reg.node_base, reg.node_base + reg.pn
        ib, ie = reg.inc_base, reg.inc_base + reg.pi
        for row in range(nb, ne):
            nid = self._node_ids[row]
            if nid is not None:
                self._id_to_idx.pop(nid, None)
                self._node_ids[row] = None
            self._pod_node.pop(row, None)
            self._sched_pods.pop(row, None)
            self._ev_rows_of_node.pop(row, None)
        for r in range(ib, ie):
            iid = self._row_inc[r]
            if iid is not None:
                self._inc_row_of.pop(iid, None)
                self._row_inc[r] = None
            self._row_nodes[r] = []
            self._row_pairs[r] = []
            self._pair_map[r] = {}
        self._free_node_rows[reg.name] = []
        self._free_inc_rows[reg.name] = []

    # -- per-tenant poison screening ---------------------------------------

    def _screen_delta(self, f_idx: np.ndarray, f_rows: np.ndarray,
                      span) -> tuple[np.ndarray, np.ndarray]:
        """Finite guard, tenant-scoped: non-finite staged rows are dropped
        from THIS delta (index -> out-of-range sentinel) and their tenants
        quarantined for a store-derived heal at the next sync: the tick
        proceeds for every other tenant instead of raising NonFiniteDelta
        across the whole pack."""
        if not self.finite_delta_guard:
            return f_idx, f_rows
        finite = np.isfinite(f_rows).all(axis=-1)
        if finite.all():
            return f_idx, f_rows
        if f_idx.ndim != 1:
            raise NotImplementedError(
                "a graph-sharded pack delta is ROADMAP item 9")
        f_idx = np.array(f_idx, copy=True)
        f_rows = np.array(f_rows, copy=True)
        pn = self.snapshot.padded_nodes
        poisoned: set[str] = set()
        for (j,) in np.argwhere(~finite):
            row = int(f_idx[j])
            if row < pn:
                poisoned.add(self._region_of_node_row(row).name)
            f_idx[j] = pn
            f_rows[j] = 0.0
        for t in sorted(poisoned):
            self.quarantine(t, "nonfinite_delta")
        if span is not None and poisoned:
            span.flag("nonfinite_delta_quarantined")
        return f_idx, f_rows

    # -- per-tenant unpacking at the fetch boundary -------------------------

    def tenant_rows(self, raw: dict) -> dict[str, dict]:
        """Unpack one batched raw verdict dict into per-tenant dicts with
        LOCAL (namespace-stripped) incident ids: the shape the per-tenant
        backends' ``results(raw=...)`` expect. The device pass was one;
        the slicing is host numpy."""
        ids = raw["incident_ids"]
        n = len(ids)
        per: dict[str, tuple[list[str], list[int]]] = {}
        for i, nsid in enumerate(ids):
            t, local = split_tenant_id(nsid)
            per.setdefault(t, ([], []))
            per[t][0].append(local)
            per[t][1].append(i)
        out: dict[str, dict] = {}
        for t, (locals_, idxs) in per.items():
            d = {"incident_ids": tuple(locals_)}
            for k, v in raw.items():
                if isinstance(v, np.ndarray) and v.shape[:1] == (n,):
                    d[k] = v[idxs]
            out[t] = d
        return out

    # -- live tenant membership (migration seams) ---------------------------

    def add_tenant(self, name: str, store: EvidenceGraphStore) -> None:
        """Adopt one NEW tenant into the running pack: a fresh zero-sized
        region is appended and the incremental ``_repack`` tensorizes ONLY
        the newcomer (a pn=0 region never satisfies the keep condition),
        while every kept region's host mirror moves by a row shift. The
        destination half of a tenant migration; the journal-cursor
        handoff above it (SurgeServer.migrate) owns exactly-once."""
        with self.serve_lock:
            if name in self._tenant_stores:
                raise ValueError(f"tenant {name!r} already in the pack")
            self._tenant_stores[name] = store
            reg = TenantRegion(name=name, store=store)
            self.regions[name] = reg
            self._regions_order.append(reg)
            self._repack()
        obs_scope.FLIGHT_RECORDER.note_event("tenant_adopted", tenant=name)
        log.info("tenant_adopted", tenant=name,
                 tenants=len(self._tenant_stores))

    def remove_tenant(self, name: str) -> EvidenceGraphStore:
        """Release one tenant from the running pack (the source half of a
        migration): its region drops out of the packed slot spaces and the
        incremental ``_repack`` row-shifts the survivors. The pack must
        keep at least one tenant (the owning SurgeServer retires the whole
        pack instead). Returns the released tenant's store."""
        with self.serve_lock:
            if name not in self._tenant_stores:
                raise KeyError(f"tenant {name!r} not in the pack")
            if len(self._tenant_stores) == 1:
                raise ValueError(
                    "a pack cannot drop its last tenant: the owner "
                    "retires the whole pack instead")
            store = self._tenant_stores.pop(name)
            reg = self.regions.pop(name)
            self._regions_order.remove(reg)
            # the departing region's staged deltas must not survive into
            # the repacked slot spaces (quarantine's delta-scrub rule)
            self._scrub_region(reg)
            self._repack()
        obs_scope.FLIGHT_RECORDER.note_event("tenant_released", tenant=name)
        log.info("tenant_released", tenant=name,
                 tenants=len(self._tenant_stores))
        return store


def swap_tenants_atomically(targets, params, source: str = "") -> int:
    """Flip EVERY tenant's resident GNN scorer to one new params generation
    atomically: acquire every target's ``serve_lock`` FIRST (in the
    caller's stable registration order — every swapper must use this
    helper, which is what makes the ordered acquisition deadlock-free),
    then install the same generation through each scorer's locked seam.
    No tick on any tenant can observe a mix: in-flight ticks complete on
    the old generation, and every dispatch that starts after this returns
    serves the new one. A target that carries a ``journal`` (a shielded
    scorer) gets a ``params_swap`` record with the exact leaves before the
    swap applies. Returns the shared new generation (1 + the max across
    tenants)."""
    targets = list(targets)
    if not targets:
        raise ValueError("swap_tenants_atomically needs >= 1 scorer")
    with ExitStack() as stack:
        for t in targets:
            stack.enter_context(t.serve_lock)
        gen = 1 + max(int(getattr(t, "params_generation", 0))
                      for t in targets)
        leaves = None
        for t in targets:
            journal = getattr(t, "journal", None)   # shielded-scorer seam
            scorer = getattr(t, "scorer", t)
            if journal is not None:
                if leaves is None:
                    from .gnn import flat_params
                    leaves = [np.asarray(v.detach().cpu() if isinstance(
                        v, torch.Tensor) else v)
                        for v in flat_params(params).values()]
                seq = int(scorer._synced_seq)
                journal.append((), seq, seq, kind="params_swap",
                               force_sync=True, generation=gen,
                               leaves=leaves, source=source)
            scorer._swap_params_locked(params, gen, source=source)
    obs_metrics.LEARN_SWAPS.inc()
    obs_scope.FLIGHT_RECORDER.note_event(
        "params_swap_atomic", generation=gen, tenants=len(targets),
        source=source)
    return gen


class _FleetJournal:
    """Append-only WAL for fleet PLACEMENT mutations.

    The shield's record journal cannot own tenant migration (the shield
    wraps a single-store scorer; a MultiTenantScorer has no store), so the
    fleet keeps its own tiny WAL with the same discipline:
    journal-before-mutate, fsync on append, roll-FORWARD replay. Records
    are plain dicts; with ``path=None`` the journal is in memory only
    (one process, where placement is trivially re-derivable)."""

    def __init__(self, path: "str | None" = None) -> None:
        self.path = path or None
        self._lock = threading.Lock()
        self._records: list[dict] = []
        if self.path and os.path.exists(self.path):
            with open(self.path) as f:
                self._records = [json.loads(line)
                                 for line in f if line.strip()]

    def append(self, rec: dict) -> None:
        line = json.dumps(rec, sort_keys=True)
        with self._lock:
            self._records.append(dict(rec))
            if self.path:
                with open(self.path, "a") as f:
                    f.write(line + "\n")
                    f.flush()
                    os.fsync(f.fileno())

    def replay(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._records]


class SurgeServer:
    """Process-wide multi-tenant serving front-end: a FLEET of packs.

    Per-tenant workflow workers register their builder's store at
    construction; each tenant is bin-packed onto one
    :class:`MultiTenantScorer` pack on the server's device, placed by
    per-tenant load estimate (admitted-rows/s EWMA over store-journal
    cursor deltas). Packs build lazily on the first ``scorer(tenant)``
    call; registering a NEW tenant after a build marks only its pack
    stale, and workers detect staleness cheaply via ``fresh()``.

    With ``settings.swell_max_packs == 1`` (the default) every tenant lands
    on pack 0. With N packs, ``migrate()`` moves a tenant between packs
    live: journal-cursor handoff through the fleet WAL
    (journal-before-mutate, exactly-once: a crash mid-migration recovers
    to exactly one owner), incremental repack on the source
    (``remove_tenant``) and destination (``add_tenant``).

    Lock order: ``SurgeServer._lock``, then a pack's ``serve_lock``."""

    HISTORY_CAP = 64

    def __init__(self, settings: Settings | None = None,
                 journal_path: "str | None" = None,
                 device: "str | torch.device | None" = None,
                 now_s: float | None = None) -> None:
        self.settings = settings or get_settings()
        s = self.settings
        self.device = resolve_device(device)
        # the packs' replay clock (None: the wall clock), as a scorer's
        self.now_s = now_s
        self.max_packs = max(int(s.swell_max_packs), 1)
        self.pack_tenants = max(int(s.swell_pack_tenants), 1)
        self._load_alpha = float(s.swell_load_alpha)
        self._stores: dict[str, EvidenceGraphStore] = {}
        self._lock = threading.Lock()
        self.generation = 0
        self.migrations = 0
        # tenant -> pack id (the single source of ownership truth: every
        # tenant appears exactly once, by construction)
        self._placement: dict[str, int] = {}
        self._packs: dict[int, MultiTenantScorer] = {}
        self._pack_built: dict[int, frozenset] = {}
        # per-tenant admitted-rows/s EWMA + the journal cursor sample it
        # was last advanced from
        self._loads: dict[str, float] = {}
        self._load_cursor: dict[str, tuple[int, float]] = {}
        self._history: collections.deque = collections.deque(
            maxlen=self.HISTORY_CAP)
        # fault seam: tests install a FaultInjector; migrate() visits the
        # "migrate" stage at each handoff boundary
        self.fault_injector = None
        self._fleet_journal = _FleetJournal(
            journal_path or s.swell_journal_path or None)
        self._recover_placement()

    # -- registration / placement ------------------------------------------

    def register(self, tenant: str, store: EvidenceGraphStore) -> None:
        with self._lock:
            old = self._stores.get(tenant)
            if old is not None and old is not store:
                raise ValueError(
                    f"tenant {tenant!r} already registered with a "
                    "different store")
            self._stores[tenant] = store
            if tenant not in self._placement:
                self._placement[tenant] = self._place_locked(tenant)

    def _place_locked(self, tenant: str) -> int:
        """Greedy bin-pack for a new tenant: the least-loaded pack with
        tenant capacity; a fresh pack when every open pack is full and the
        fleet has room; otherwise the least-loaded pack regardless
        (capacity is a target, not a hard wall: admission control owns
        hard limits)."""
        counts: dict[int, int] = {p: 0 for p in range(
            len(set(self._placement.values())))}
        loads: dict[int, float] = {}
        for t, p in self._placement.items():
            counts[p] = counts.get(p, 0) + 1
            loads[p] = loads.get(p, 0.0) + self._loads.get(t, 0.0)
        open_packs = sorted(counts)
        with_room = [p for p in open_packs
                     if counts[p] < self.pack_tenants]
        if with_room:
            return min(with_room,
                       key=lambda p: (loads.get(p, 0.0), counts[p], p))
        if len(open_packs) < self.max_packs:
            return (max(open_packs) + 1) if open_packs else 0
        if not open_packs:
            return 0
        return min(open_packs,
                   key=lambda p: (loads.get(p, 0.0), counts[p], p))

    def _recover_placement(self) -> None:
        """Roll the fleet WAL FORWARD: an intent record already moves
        ownership to the destination (the cursor handoff is in the record;
        the packs rebuild from stores, so a crash between the intent and
        any mutate boundary loses no data). After replay every migrated
        tenant has exactly one owner: the later of its records wins, and
        registration honours the recovered placement."""
        for rec in self._fleet_journal.replay():
            if rec.get("kind") in ("migrate_intent", "migrate_commit"):
                self._placement[str(rec["tenant"])] = int(rec["dst"])

    # -- pack building ------------------------------------------------------

    def _tenants_of_locked(self, pack_id: int) -> frozenset:
        return frozenset(t for t, p in self._placement.items()
                         if p == pack_id and t in self._stores)

    def fresh(self) -> bool:
        """True when every pack with placed tenants is built over exactly
        its current tenant set: the worker fast path's cheap staleness
        probe."""
        with self._lock:
            for pack_id in set(self._placement.values()):
                names = self._tenants_of_locked(pack_id)
                if not names:
                    continue
                if (self._packs.get(pack_id) is None
                        or self._pack_built.get(pack_id) != names):
                    return False
            return bool(self._stores)

    def scorer(self, tenant: "str | None" = None) -> MultiTenantScorer:
        """The pack serving ``tenant``, (re)built if its tenant set
        changed since the last build. ``tenant=None`` (single-pack
        callers) returns the lowest-numbered pack."""
        with self._lock:
            if tenant is None:
                pack_id = min(set(self._placement.values()), default=0)
            else:
                if tenant not in self._placement:
                    raise KeyError(f"tenant {tenant!r} not registered")
                pack_id = self._placement[tenant]
            return self._build_pack_locked(pack_id)

    def _build_pack_locked(self, pack_id: int) -> MultiTenantScorer:
        names = self._tenants_of_locked(pack_id)
        if not names:
            raise ValueError(f"no tenants placed on pack {pack_id}")
        cur = self._packs.get(pack_id)
        if cur is None or names != self._pack_built.get(pack_id):
            if cur is not None:
                log.info("surge_repack", pack=pack_id,
                         tenants=sorted(names))
            pack = MultiTenantScorer(
                {t: self._stores[t] for t in sorted(names)},
                self.settings, now_s=self.now_s, device=self.device)
            # the pack's identity in its telemetry, so N packs never alias
            # one gauge series
            pack._scope_pack = str(pack_id)
            pack.scope.pack = str(pack_id)
            self._packs[pack_id] = pack
            self._pack_built[pack_id] = names
            self.generation += 1
            obs_metrics.FLEET_PACKS.set(float(len(self._packs)))
        return self._packs[pack_id]

    # -- per-tenant load estimation ----------------------------------------

    def sample_loads(self, now_s: "float | None" = None) -> dict:
        """Advance every tenant's admitted-rows/s EWMA from its store
        journal cursor (admitted rows land in the journal; the cursor
        delta over wall time is the admission rate the bin-packer and the
        fleet API report). Injectable clock for tests."""
        now = time.monotonic() if now_s is None else float(now_s)
        with self._lock:
            for tenant, store in self._stores.items():
                seq = int(store.journal_seq)
                prev = self._load_cursor.get(tenant)
                self._load_cursor[tenant] = (seq, now)
                if prev is None:
                    continue
                seq0, t0 = prev
                dt = now - t0
                if dt <= 0:
                    continue
                rate = max(seq - seq0, 0) / dt
                old = self._loads.get(tenant)
                a = self._load_alpha
                ewma = rate if old is None else (1 - a) * old + a * rate
                self._loads[tenant] = ewma
                obs_metrics.FLEET_TENANT_LOAD.set(ewma, tenant=tenant)
            return dict(self._loads)

    # -- live tenant migration ---------------------------------------------

    def _fault(self, stage: str) -> None:
        fi = self.fault_injector
        if fi is not None:
            fi.at(stage)

    def migrate(self, tenant: str, dst: int) -> dict:
        """Move one tenant between packs LIVE, exactly-once.

        Order (journal-before-mutate, on the fleet WAL): (1) append the
        intent record (tenant, src, dst, and the store-journal CURSOR at
        handoff) and fsync; (2) incremental repack on the source
        (``remove_tenant``; the whole pack retires instead when the tenant
        was its last); (3) flip placement and adopt on the destination
        (``add_tenant`` when the pack is live, else the next ``scorer()``
        builds it); (4) append the commit record. A crash at ANY boundary
        recovers to exactly one owner: replay rolls the intent forward,
        packs rebuild from stores, and the destination's first sync
        drains the tenant's journal from its captured cursor."""
        with self._lock:
            if tenant not in self._stores:
                raise KeyError(f"tenant {tenant!r} not registered")
            dst = int(dst)
            if dst < 0 or dst >= self.max_packs:
                raise ValueError(
                    f"destination pack {dst} outside the fleet "
                    f"(max_packs={self.max_packs})")
            src = self._placement[tenant]
            if src == dst:
                return {"tenant": tenant, "src": src, "dst": dst,
                        "moved": False}
            store = self._stores[tenant]
            cursor = int(store.journal_seq)
            self._fleet_journal.append(
                {"kind": "migrate_intent", "tenant": tenant, "src": src,
                 "dst": dst, "cursor": cursor, "gen": self.generation})
            self._fault("migrate")          # crash at the journal boundary
            src_pack = self._packs.get(src)
            if src_pack is not None:
                if len(self._pack_built.get(src, ())) <= 1:
                    # last tenant: retire the whole pack, no repack
                    self._packs.pop(src, None)
                    self._pack_built.pop(src, None)
                else:
                    src_pack.remove_tenant(tenant)
                    self._pack_built[src] = \
                        self._pack_built[src] - {tenant}
            self._fault("migrate")          # crash at the repack boundary
            self._placement[tenant] = dst
            dst_pack = self._packs.get(dst)
            if dst_pack is not None:
                dst_pack.add_tenant(tenant, store)
                self._pack_built[dst] = \
                    self._pack_built.get(dst, frozenset()) | {tenant}
            self._fault("migrate")          # crash at the adopt boundary
            self._fleet_journal.append(
                {"kind": "migrate_commit", "tenant": tenant, "src": src,
                 "dst": dst, "cursor": cursor, "gen": self.generation})
            self.generation += 1
            self.migrations += 1
            self._history.append(
                {"event": "migrate", "tenant": tenant, "src": src,
                 "dst": dst, "cursor": cursor, "gen": self.generation})
            obs_metrics.FLEET_TENANT_MIGRATIONS.inc()
            obs_metrics.FLEET_PACKS.set(float(len(self._packs)))
        obs_scope.FLIGHT_RECORDER.note_event(
            "tenant_migrate", tenant=tenant, src=src, dst=dst,
            cursor=cursor)
        log.warning("tenant_migrated", tenant=tenant, src=src, dst=dst,
                    cursor=cursor)
        return {"tenant": tenant, "src": src, "dst": dst, "moved": True,
                "cursor": cursor}

    def note_scale(self, pack_id: int, decision: dict) -> None:
        """Record one ElasticController scale decision into the fleet
        history ring (the /api/v1/fleet forensic surface)."""
        if decision.get("action", "hold") == "hold":
            return
        with self._lock:
            self._history.append(
                {"event": decision["action"], "pack": int(pack_id),
                 "plan": decision.get("plan"), "gen": self.generation})

    # -- the fleet API surface ---------------------------------------------

    def fleet(self) -> dict:
        """Placement, per-tenant load estimates, and the scale/migration
        history ring: the GET /api/v1/fleet payload."""
        with self._lock:
            packs: dict[str, dict] = {}
            for pack_id in sorted(set(self._placement.values())):
                names = sorted(self._tenants_of_locked(pack_id))
                built = self._packs.get(pack_id) is not None
                packs[str(pack_id)] = {
                    "tenants": names,
                    "built": built,
                    "shards": (int(self._packs[pack_id]._graph_size())
                               if built else 0),
                }
            return {
                "packs": packs,
                "placement": dict(self._placement),
                "loads": {t: round(v, 3)
                          for t, v in self._loads.items()},
                "history": list(self._history),
                "generation": self.generation,
                "migrations": self.migrations,
                "max_packs": self.max_packs,
                "pack_tenants": self.pack_tenants,
            }
