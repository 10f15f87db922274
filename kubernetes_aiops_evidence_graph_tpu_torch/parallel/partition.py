"""Host-side graph partitioning for the (dp × graph) mesh.

Nodes are split into contiguous ranges, one per ``graph`` shard; edges are
assigned to the shard that owns their *destination* (so the sum of
incoming messages is shard-local and only source embeddings cross shards,
the halo exchange of ``parallel/sharded_gnn.py``). Incidents are
round-robined over ``dp`` shards. All per-shard arrays are padded to a
common size, stacked along a leading shard axis.

Per-shard edges carry the same relation-bucketed layout as the snapshot
(``graph/snapshot.py``): each shard's edges are sorted by (rel, dst_local)
into per-relation slices whose capacities are shared across shards (max
over shards, padded to the ``REL_SLICE_BUCKETS`` ladder), so one
``rel_offsets`` tuple describes EVERY shard and every shard runs the
message-pass kernel on the same layout.

numpy only; the JAX package's ``parallel/partition.py`` as written, so
both packages partition a snapshot into equal arrays.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..graph.schema import RelationKind
from ..graph.snapshot import GraphSnapshot, rel_slice_offsets
from ..ladders import INCIDENT_BUCKET_SIZES
from ..utils.padding import bucket_for


@dataclass(frozen=True)
class PartitionedGraph:
    """Stacked per-shard arrays; leading axes are mesh axes."""
    # graph axis: nodes split into G contiguous ranges of size Pn/G
    features: np.ndarray        # [G, Pn/G, DIM]
    node_kind: np.ndarray       # [G, Pn/G]
    node_mask: np.ndarray       # [G, Pn/G]
    # graph axis: edges grouped by dst shard, dst made shard-local,
    # relation-bucketed per shard (shared rel_offsets)
    edge_src: np.ndarray        # [G, Pe_shard] global src index
    edge_dst_local: np.ndarray  # [G, Pe_shard] dst - shard*Pn/G
    edge_rel: np.ndarray        # [G, Pe_shard] RelationKind (-1 = padding)
    edge_mask: np.ndarray       # [G, Pe_shard]
    # dp axis: incidents round-robined
    incident_nodes: np.ndarray  # [D, Pi/D] global node index
    incident_mask: np.ndarray   # [D, Pi/D]
    labels: np.ndarray          # [D, Pi/D]
    nodes_per_shard: int
    rel_offsets: tuple[int, ...] = ()   # [R+1] shared per-shard slices


def partition_snapshot(
    snapshot: GraphSnapshot,
    dp: int,
    graph: int,
    labels: np.ndarray | None = None,
) -> PartitionedGraph:
    pn = snapshot.padded_nodes
    if pn % graph:
        raise ValueError(f"padded nodes {pn} not divisible by graph={graph}")
    nps = pn // graph

    features = snapshot.features.reshape(graph, nps, -1)
    node_kind = snapshot.node_kind.reshape(graph, nps)
    node_mask = snapshot.node_mask.reshape(graph, nps)

    live = snapshot.edge_mask > 0
    src = snapshot.edge_src[live]
    dst = snapshot.edge_dst[live]
    rel = snapshot.edge_rel[live]
    owner = dst // nps
    num_rels = len(RelationKind)
    # shared per-relation capacities: the max count over shards, bucketed
    counts = np.zeros((graph, num_rels), np.int64)
    for g in range(graph):
        sel = owner == g
        if sel.any():
            counts[g] = np.bincount(rel[sel], minlength=num_rels)
    rel_offsets = rel_slice_offsets(counts.max(axis=0) if len(src) else
                                    np.zeros(num_rels, np.int64))
    pe_shard = max(int(rel_offsets[-1]), 1)

    e_src = np.zeros((graph, pe_shard), np.int32)
    # padding dst_local = LAST local row: keeps each slice non-decreasing
    # in dst through its padded tail (mask-zeroed adds either way)
    e_dst = np.full((graph, pe_shard), nps - 1, np.int32)
    e_rel = np.full((graph, pe_shard), -1, np.int32)
    e_mask = np.zeros((graph, pe_shard), np.float32)
    for g in range(graph):
        sel = owner == g
        gs, gd, gr = src[sel], dst[sel] - g * nps, rel[sel]
        order = np.lexsort((gd, gr))       # rel major, dst_local minor
        gs, gd, gr = gs[order], gd[order], gr[order]
        pos = 0
        for r in range(num_rels):
            c = int(counts[g, r])
            lo = rel_offsets[r]
            e_src[g, lo:lo + c] = gs[pos:pos + c]
            e_dst[g, lo:lo + c] = gd[pos:pos + c]
            e_rel[g, lo:lo + c] = gr[pos:pos + c]
            e_mask[g, lo:lo + c] = 1.0
            pos += c

    pi = snapshot.padded_incidents
    per_dp = -(-pi // dp)
    per_dp = bucket_for(per_dp, INCIDENT_BUCKET_SIZES)
    inc_nodes = np.zeros((dp, per_dp), np.int32)
    inc_mask = np.zeros((dp, per_dp), np.float32)
    lab = np.zeros((dp, per_dp), np.int32)
    full_labels = (np.asarray(labels, dtype=np.int32) if labels is not None
                   else np.zeros(pi, np.int32))
    for i in range(snapshot.num_incidents):
        d, slot = i % dp, i // dp
        inc_nodes[d, slot] = snapshot.incident_nodes[i]
        inc_mask[d, slot] = snapshot.incident_mask[i]
        if i < len(full_labels):
            lab[d, slot] = full_labels[i]

    return PartitionedGraph(
        features=features, node_kind=node_kind, node_mask=node_mask,
        edge_src=e_src, edge_dst_local=e_dst, edge_rel=e_rel,
        edge_mask=e_mask,
        incident_nodes=inc_nodes, incident_mask=inc_mask, labels=lab,
        nodes_per_shard=nps,
        rel_offsets=rel_offsets,
    )
