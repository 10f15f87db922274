"""GraphSnapshot — the tensorized view of the evidence graph.

This is the data structure the device path consumes: dense node-feature
matrix + COO edge lists, padded to bucket ladders (utils/padding.py) with
the same rungs as the JAX package, so both score identical arrays. It
replaces the reference's per-incident Cypher traversals
(neo4j.py:169-201) with one whole-graph array view that scores *all*
incidents in a single batched pass. The arrays stay numpy on the host;
rca/cuda_backend.py moves what a scoring pass reads onto the device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np

from ..config import Settings, get_settings
from ..utils.padding import bucket_for, pad_to
from ..utils.timeutils import parse_iso, to_epoch_s, utcnow
from .schema import (
    DIM,
    EntityKind,
    F,
    LOG_PATTERN_FEATURES,
    NODE_CONDITION_FEATURES,
    RelationKind,
    TERMINATED_REASON_FEATURES,
    WAITING_REASON_FEATURES,
)
from .store import EvidenceGraphStore, _Node

# Per-relation edge-slice capacity ladder (relation-bucketed layout): each
# RelationKind's contiguous slice is padded to a ladder value so the static
# offset tuple — a jit cache key for the bucketed GNN kernel — is drawn
# from a small discrete set instead of minting a recompile per edge-count
# drift. Powers of two up to 8192, then multiples of 8192: the bucketed
# kernel's device time scales with PADDED edge rows (gather + scatter both
# walk them), so big slices cap the inflation at ~6% instead of the ~2x a
# pure power-of-two ladder costs (measured 459520 padded for 273238 live
# at the 50k-node bench config; the stepped ladder lands at 287488).
# 8192-multiples keep slice bases tile-aligned. Shared by build_snapshot,
# parallel/partition.py and the streaming edge mirror
# (rca/gnn_streaming.py).
# graft-tide stretched the ladder with named 8192-multiple rungs
# (16384/24576/32768) for 500k-pod edge profiles. The rungs are exactly
# the capacities the old beyond-top rule produced, and the step stays
# anchored at _REL_SLICE_STEP above the ladder, so EVERY count rounds to
# the same capacity as before the stretch — no static offset tuple, jit
# cache key or cost baseline shifts.
# The rungs and step live in the declared ladder registry (ladders.py).
from ..ladders import REL_SLICE_BUCKETS, REL_SLICE_STEP as _REL_SLICE_STEP


def rel_slice_offsets(counts, slack: float = 0.0,
                      min_cap: int = 0,
                      buckets: tuple[int, ...] = REL_SLICE_BUCKETS,
                      ) -> tuple[int, ...]:
    """[R+1] static offsets for a relation-bucketed edge layout: slice r
    spans ``[off[r], off[r+1])`` with capacity ``count_r`` rounded up the
    ladder — power-of-two below its top rung, next multiple of
    ``_REL_SLICE_STEP`` above — plus ``slack`` growth headroom. A
    relation with no edges gets a zero-width slice unless ``min_cap``
    reserves room (the streaming mirror does, so first-edge churn of a
    new relation doesn't force an immediate re-mirror)."""
    offs = [0]
    # anchored at _REL_SLICE_STEP (NOT buckets[-1]): the graft-tide rung
    # stretch must not coarsen beyond-ladder rounding
    step = max(int(buckets[-1]), _REL_SLICE_STEP) \
        if buckets is not REL_SLICE_BUCKETS else _REL_SLICE_STEP
    for c in counts:
        need = max(int(np.ceil(int(c) * (1.0 + slack))), min_cap)
        if need <= 0:
            cap = 0
        elif need <= buckets[-1]:
            cap = bucket_for(need, buckets)
        else:
            cap = -(-need // step) * step
        offs.append(offs[-1] + cap)
    return tuple(offs)


def extract_node_features(node: _Node, now_s: float | None = None) -> np.ndarray:
    """Fold a node's property bag into the fixed feature vector.

    Tensor analog of the reference's per-evidence signal fold
    (rules_engine.py:292-357): the same keys are read, but from graph-node
    properties (set by collectors/builder) instead of evidence dicts.
    """
    f = np.zeros(DIM, dtype=np.float32)
    p = node.properties

    wr = p.get("waiting_reason")
    if wr in WAITING_REASON_FEATURES:
        f[WAITING_REASON_FEATURES[wr]] = 1.0
    tr = p.get("terminated_reason")
    if tr in TERMINATED_REASON_FEATURES:
        f[TERMINATED_REASON_FEATURES[tr]] = 1.0

    f[F.RESTART_COUNT] = float(p.get("restart_count", 0) or 0)
    if p.get("ready") is False:
        not_ready_s = float(p.get("not_ready_seconds", 0) or 0)
        if not_ready_s >= 300:  # rule readiness_probe_failing duration_seconds: 300
            f[F.POD_NOT_READY] = 1.0
    if p.get("readiness_probe_failing"):
        f[F.READINESS_PROBE_FAILING] = 1.0

    f[F.ERROR_COUNT] = float(p.get("error_count", 0) or 0)
    for pat in p.get("patterns_found", ()) or ():
        idx = LOG_PATTERN_FEATURES.get(pat)
        if idx is not None:
            f[idx] = 1.0

    if p.get("is_recent_change"):
        f[F.HAS_RECENT_DEPLOY] = 1.0
    if p.get("image_changed"):
        f[F.HAS_IMAGE_CHANGE] = 1.0
    if p.get("config_changed"):
        f[F.HAS_CONFIG_CHANGE] = 1.0
    ts = p.get("changed_at")
    if ts is not None:
        when = parse_iso(ts) if isinstance(ts, str) else ts
        age_min = max(0.0, ((now_s or to_epoch_s(utcnow())) - to_epoch_s(when)) / 60.0)
        f[F.CHANGE_RECENCY] = max(0.0, 1.0 - age_min / 30.0)  # 30min window, deploy_diff_collector.py:93-215

    if p.get("memory_usage_high"):
        f[F.MEMORY_USAGE_HIGH] = 1.0
    if p.get("cpu_throttling"):
        f[F.CPU_THROTTLING] = 1.0
    if p.get("hpa_at_max") or p.get("at_max"):
        f[F.HPA_AT_MAX] = 1.0
    if p.get("latency_high"):
        f[F.LATENCY_HIGH] = 1.0

    conds = p.get("conditions") or {}
    if node.kind == EntityKind.NODE:
        ready = conds.get("Ready")
        status = ready.get("status") if isinstance(ready, dict) else ready
        if status is not None and status != "True":
            f[F.NODE_NOT_READY] = 1.0
        for cname, idx in NODE_CONDITION_FEATURES.items():
            if cname == "NotReady":
                continue
            c = conds.get(cname)
            cstatus = c.get("status") if isinstance(c, dict) else c
            if cstatus == "True":
                f[idx] = 1.0

    if node.kind == EntityKind.POD and (
        p.get("waiting_reason")
        or p.get("terminated_reason")
        or float(p.get("restart_count", 0) or 0) > 3  # PROBLEM_POD_RESTARTS
        or p.get("ready") is False
    ):
        f[F.POD_PROBLEM] = 1.0

    f[F.NETWORK_ERROR_COUNT] = float(p.get("network_error_count", 0) or 0)
    f[F.SIGNAL_STRENGTH] = float(p.get("signal_strength", 0.0) or 0.0)
    if p.get("is_anomaly"):
        f[F.IS_ANOMALY] = 1.0
    if float(p.get("unavailable_replicas", 0) or 0) > 0:
        f[F.DEPLOY_UNAVAILABLE] = 1.0

    return f


@dataclass(frozen=True)
class GraphSnapshot:
    """Immutable padded tensor view of the evidence graph.

    Shapes (P* = padded to bucket):
      node_kind  int32  [Pn]      features  float32 [Pn, DIM]
      node_mask  f32    [Pn]      (1.0 real / 0.0 pad)
      edge_src   int32  [Pe]      edge_dst  int32 [Pe]   edge_rel int32 [Pe]
      edge_mask  f32    [Pe]      (padded edges self-loop on pad node 0 weight)
      incident_nodes int32 [Pi]   incident_mask f32 [Pi]

    Edge layout contract (relation-bucketed): edges are sorted by
    ``(rel, dst)`` and grouped into per-relation contiguous slices —
    relation r owns ``[rel_offsets[r], rel_offsets[r+1])``, live prefix
    dst-sorted, slice tail padded (mask 0, rel -1, dst pinned to the last
    node row so each slice stays non-decreasing in dst). The static
    ``rel_offsets`` tuple is what lets the GNN's bucketed kernel slice per
    relation with one [H, H] matmul each (rca/gnn.py); COO consumers that
    filter by mask/rel stay order-insensitive.
    """
    node_ids: tuple[str, ...]
    incident_ids: tuple[str, ...]
    num_nodes: int
    num_edges: int
    num_incidents: int
    node_kind: np.ndarray
    features: np.ndarray
    node_mask: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_rel: np.ndarray
    edge_mask: np.ndarray
    incident_nodes: np.ndarray
    incident_mask: np.ndarray
    version: int = 0
    rel_offsets: tuple[int, ...] = ()   # [R+1] per-relation edge slices

    @property
    def padded_nodes(self) -> int:
        return int(self.node_kind.shape[0])

    @property
    def padded_edges(self) -> int:
        return int(self.edge_src.shape[0])

    @property
    def padded_incidents(self) -> int:
        return int(self.incident_nodes.shape[0])

    def typed_edges(self, kind: RelationKind) -> tuple[np.ndarray, np.ndarray]:
        """(src, dst) for one relation kind, unpadded."""
        sel = (self.edge_rel == int(kind)) & (self.edge_mask > 0)
        return self.edge_src[sel], self.edge_dst[sel]

    def index_of(self, node_id: str) -> int:
        return self.node_ids.index(node_id)


def build_snapshot(
    store: EvidenceGraphStore,
    settings: Settings | None = None,
    now_s: float | None = None,
    undirected: bool = True,
    slack: float = 0.0,
) -> GraphSnapshot:
    """Tensorize the store. With ``undirected=True`` every edge is emitted in
    both directions — matching apoc.path.subgraphAll's undirected expansion
    (neo4j.py:174) so propagation reaches owners and dependents alike.

    ``slack`` reserves growth headroom when picking buckets (the streaming
    scorer passes 1/3 so node creations and incident arrivals land in free
    padded rows instead of forcing a rebuild — and a rebuild's recompile
    storm — mid-stream)."""
    cfg = settings or get_settings()
    nodes, edges = store._raw()

    def _pad(k: int) -> int:
        return max(int(np.ceil(k * (1.0 + slack))), 1)

    n = len(nodes)
    pn = bucket_for(_pad(max(n, 1)), cfg.node_bucket_sizes)

    node_kind = np.zeros(pn, dtype=np.int32)
    features = np.zeros((pn, DIM), dtype=np.float32)
    node_mask = np.zeros(pn, dtype=np.float32)
    incident_rows: list[int] = []
    incident_ids: list[str] = []

    for i, node in enumerate(nodes):
        node_kind[i] = int(node.kind)
        features[i] = extract_node_features(node, now_s=now_s)
        node_mask[i] = 1.0
        if node.kind == EntityKind.INCIDENT:
            incident_rows.append(i)
            incident_ids.append(node.id)

    raw_edges: list[tuple[int, int, int]] = []
    id_to_idx = {node.id: i for i, node in enumerate(nodes)}
    for e in edges:
        s, d = id_to_idx[e.src], id_to_idx[e.dst]
        raw_edges.append((s, d, int(e.kind)))
        if undirected:
            raw_edges.append((d, s, int(e.kind)))

    m = len(raw_edges)
    num_rels = len(RelationKind)
    counts = np.zeros(num_rels, dtype=np.int64)
    arr = np.asarray(raw_edges, dtype=np.int32) if m else None
    if m:
        counts = np.bincount(arr[:, 2], minlength=num_rels)
    # relation-bucketed layout: live edges sorted by (rel, dst) into one
    # contiguous padded slice per relation (static offsets). Each slice's
    # live prefix is dst-sorted, so the GNN's per-slice segment-sums keep
    # the indices_are_sorted fast path (measured 1.9x on the v5e scatter);
    # COO consumers filter by mask/rel and stay order-insensitive.
    rel_offsets = rel_slice_offsets(counts)
    pe = max(int(rel_offsets[-1]), 1)
    edge_src = np.zeros(pe, dtype=np.int32)
    # padding dst = LAST node row, not 0: keeps every slice monotone in
    # dst through its padded tail (the mask-zeroed messages add 0.0 to
    # that row either way)
    edge_dst = np.full(pe, pn - 1, dtype=np.int32)
    edge_rel = np.full(pe, -1, dtype=np.int32)
    edge_mask = np.zeros(pe, dtype=np.float32)
    if m:
        order = np.lexsort((arr[:, 1], arr[:, 2]))   # rel major, dst minor
        arr = arr[order]
        pos = 0
        for r in range(num_rels):
            c = int(counts[r])
            lo = rel_offsets[r]
            edge_src[lo:lo + c] = arr[pos:pos + c, 0]
            edge_dst[lo:lo + c] = arr[pos:pos + c, 1]
            edge_rel[lo:lo + c] = arr[pos:pos + c, 2]
            edge_mask[lo:lo + c] = 1.0
            pos += c

    ni = len(incident_rows)
    pi = bucket_for(_pad(max(ni, 1)), cfg.incident_bucket_sizes)
    incident_nodes = np.zeros(pi, dtype=np.int32)
    incident_mask = np.zeros(pi, dtype=np.float32)
    if ni:
        incident_nodes[:ni] = np.asarray(incident_rows, dtype=np.int32)
        incident_mask[:ni] = 1.0

    return GraphSnapshot(
        node_ids=tuple(node.id for node in nodes),
        incident_ids=tuple(incident_ids),
        num_nodes=n,
        num_edges=m,
        num_incidents=ni,
        node_kind=node_kind,
        features=features,
        node_mask=node_mask,
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_rel=edge_rel,
        edge_mask=edge_mask,
        incident_nodes=incident_nodes,
        incident_mask=incident_mask,
        version=store.version,
        rel_offsets=rel_offsets,
    )


_ARRAY_DTYPES = {"node_kind": np.int32, "features": np.float32,
                 "node_mask": np.float32, "edge_src": np.int32,
                 "edge_dst": np.int32, "edge_rel": np.int32,
                 "edge_mask": np.float32, "incident_nodes": np.int32,
                 "incident_mask": np.float32}


def snapshot_from_numpy(fields: dict[str, Any]) -> GraphSnapshot:
    """A GraphSnapshot from a dict of every snapshot field (numpy arrays,
    id tuples and counts), e.g. ``dataclasses.asdict`` of the JAX
    package's snapshot — so the port can score a world it did not build.
    The arrays are copied into fresh arrays of the snapshot's dtypes."""
    kw = {f.name: fields[f.name] for f in dataclasses.fields(GraphSnapshot)}
    for name, dtype in _ARRAY_DTYPES.items():
        kw[name] = np.array(kw[name], dtype=dtype, copy=True)
    for name in ("node_ids", "incident_ids", "rel_offsets"):
        kw[name] = tuple(kw[name])
    return GraphSnapshot(**kw)
