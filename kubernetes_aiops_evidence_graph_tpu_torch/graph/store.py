"""In-memory evidence-graph store — the Neo4j/GraphService replacement.

Capability parity with the reference GraphService (src/database/neo4j.py:67-320):
MERGE-semantics upserts, depth-limited incident subgraphs
(apoc.path.subgraphAll, neo4j.py:169-201), time-windowed related changes
(:204-228), affected-by-node traversal (:231-251), service dependency
up/downstream (:254-278), and per-incident cleanup (:281-296).

Unlike the reference — which issues one Bolt round-trip per node/edge
(neo4j.py:95-166) — upserts here are O(1) dict operations and batch calls
are true batches, and the whole graph tensorizes into a
:class:`~.snapshot.GraphSnapshot` for device scoring.
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Iterable, Optional

from ..models import GraphEntity, GraphRelation
from ..utils.timeutils import parse_iso
from .schema import EntityKind, RelationKind


@dataclass
class _Node:
    id: str
    kind: EntityKind
    label: str
    index: int                      # monotone insertion order (sort key ONLY —
    #   removals leave holes; dense row numbers are assigned at COO build)
    properties: dict[str, Any] = field(default_factory=dict)


@dataclass
class _Edge:
    src: str
    dst: str
    kind: RelationKind
    properties: dict[str, Any] = field(default_factory=dict)


class EvidenceGraphStore:
    """Mutable, thread-safe, in-memory property graph."""

    # below this many nodes the Python BFS beats the cost of materializing
    # the COO index for the native kernel
    _NATIVE_BFS_MIN_NODES = 2048

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._nodes: dict[str, _Node] = {}
        self._edges: dict[tuple[str, str, RelationKind], _Edge] = {}
        self._out: dict[str, set[tuple[str, RelationKind]]] = {}
        self._in: dict[str, set[tuple[str, RelationKind]]] = {}
        self._version = 0  # bumps on every mutation; snapshot cache key
        # the native BFS's undirected COO index, keyed by _version
        self._coo_cache: tuple[int, list[str], dict[str, int], Any, Any] | None = None
        self._next_index = 0  # monotone: removal never reassigns indices
        # change journal: every structural mutation appends one record so a
        # resident StreamingScorer can mirror the graph without rebuilding
        # (the serving-path seam; see rca/streaming.py sync()). Bounded: a
        # consumer that falls further behind than the buffer must rebuild.
        self._journal: deque[tuple] = deque(maxlen=200_000)
        self._seq = 0

    def _jrec(self, *rec: Any) -> None:
        """Append one journal record. Caller must hold the lock."""
        self._seq += 1
        self._journal.append((self._seq, *rec))

    @property
    def journal_seq(self) -> int:
        with self._lock:
            return self._seq

    def journal_since(self, seq: int) -> tuple[list[tuple], int, bool]:
        """(records with seq > `seq`, current seq, truncated). `truncated`
        means records after `seq` were evicted from the bounded buffer —
        the consumer must fall back to a full rebuild."""
        with self._lock:
            if not self._journal:
                return [], self._seq, seq < self._seq
            oldest = self._journal[0][0]
            if seq + 1 < oldest:
                return [], self._seq, True
            # seqs are contiguous: slice by offset instead of scanning
            start = seq + 1 - oldest
            return list(itertools.islice(self._journal, start, None)), \
                self._seq, False

    # -- mutation ---------------------------------------------------------

    def upsert_entity(self, entity: GraphEntity) -> None:
        self.upsert_entities([entity])

    def upsert_entities(self, entities: Iterable[GraphEntity]) -> int:
        """Batch MERGE of nodes (reference neo4j.py:95-112, but one lock +
        dict ops instead of one session.run per entity)."""
        n = 0
        with self._lock:
            for e in entities:
                node = self._nodes.get(e.id)
                if node is None:
                    kind = EntityKind.from_label(e.type)
                    self._nodes[e.id] = _Node(
                        id=e.id,
                        kind=kind,
                        label=e.type,
                        index=self._alloc_index(),
                        properties=dict(e.properties),
                    )
                    self._out.setdefault(e.id, set())
                    self._in.setdefault(e.id, set())
                    self._jrec("node+", e.id, int(kind))
                else:
                    node.properties.update(e.properties)
                    self._jrec("node~", e.id)
                n += 1
            self._version += 1
        return n

    def touch_nodes(self, node_ids: Iterable[str]) -> int:
        """Journal a ``node~`` record for nodes whose property bags were
        mutated in place (the kube-state delta path,
        simulator/stream.sync_touched_to_store, updates dicts directly for
        speed and bypasses upsert): journal consumers — streaming sync()
        and the graft-shield write-ahead log — re-extract features for
        touched nodes, so in-place mutations stay recoverable too."""
        n = 0
        with self._lock:
            for nid in node_ids:
                if nid in self._nodes:
                    self._jrec("node~", nid)
                    n += 1
            if n:
                self._version += 1
        return n

    def upsert_relations(self, relations: Iterable[GraphRelation]) -> int:
        """Batch MERGE of edges (reference neo4j.py:145-166). Edges whose
        endpoints don't exist yet get placeholder nodes (MERGE semantics)."""
        n = 0
        with self._lock:
            for r in relations:
                kind = RelationKind.from_label(r.relation_type)
                for nid in (r.source_id, r.target_id):
                    if nid not in self._nodes:
                        label = nid.split(":", 1)[0].capitalize() if ":" in nid else "Container"
                        nkind = EntityKind.from_label(label)
                        self._nodes[nid] = _Node(
                            id=nid, kind=nkind, label=label,
                            index=self._alloc_index(),
                        )
                        self._out.setdefault(nid, set())
                        self._in.setdefault(nid, set())
                        self._jrec("node+", nid, int(nkind))
                key = (r.source_id, r.target_id, kind)
                edge = self._edges.get(key)
                if edge is None:
                    self._edges[key] = _Edge(r.source_id, r.target_id, kind, dict(r.properties))
                    self._out[r.source_id].add((r.target_id, kind))
                    self._in[r.target_id].add((r.source_id, kind))
                    self._jrec("edge+", r.source_id, r.target_id, int(kind))
                else:
                    edge.properties.update(r.properties)
                n += 1
            self._version += 1
        return n

    def _alloc_index(self) -> int:
        """Monotone insertion index. Never reused after removal — the index
        is a sort key only, so holes are free and removal stays O(degree)."""
        i = self._next_index
        self._next_index += 1
        return i

    def _remove_one(self, node_id: str) -> bool:
        """O(degree) unlink. Caller holds the lock and bumps the version."""
        node = self._nodes.get(node_id)
        if node is None:
            return False
        self._jrec("node-", node_id, int(node.kind))
        for dst, kind in list(self._out.get(node_id, ())):
            self._edges.pop((node_id, dst, kind), None)
            self._in[dst].discard((node_id, kind))
        for src, kind in list(self._in.get(node_id, ())):
            self._edges.pop((src, node_id, kind), None)
            self._out[src].discard((node_id, kind))
        self._out.pop(node_id, None)
        self._in.pop(node_id, None)
        del self._nodes[node_id]
        return True

    def remove_node(self, node_id: str) -> bool:
        """Remove a node and its edges in O(degree) — indices are never
        reassigned (the round-1 dense rewrite made each removal O(N):
        ~30M index writes to clean 500 incidents off a 50k-node store)."""
        with self._lock:
            ok = self._remove_one(node_id)
            if ok:
                self._version += 1
            return ok

    def remove_nodes(self, node_ids: Iterable[str]) -> int:
        """Batch removal with ONE version bump, so a sweep of unrelated
        removals invalidates the COO/snapshot caches once, not per node."""
        n = 0
        with self._lock:
            for nid in node_ids:
                if self._remove_one(nid):
                    n += 1
            if n:
                self._version += 1
        return n

    def remove_relation(self, source_id: str, target_id: str,
                        relation_type: str) -> bool:
        """Remove one edge (Cypher DELETE-relationship analog). O(1)."""
        kind = RelationKind.from_label(relation_type)
        with self._lock:
            if self._edges.pop((source_id, target_id, kind), None) is None:
                return False
            self._out[source_id].discard((target_id, kind))
            self._in[target_id].discard((source_id, kind))
            self._jrec("edge-", source_id, target_id, int(kind))
            self._version += 1
            return True

    def relations_from(self, source_id: str,
                       relation_type: str) -> list[str]:
        """Target ids of this node's outgoing edges of one type."""
        kind = RelationKind.from_label(relation_type)
        with self._lock:
            return sorted(d for d, k in self._out.get(source_id, ())
                          if k == kind)

    def cleanup_incident(self, incident_id: str) -> int:
        """Remove an incident node and its relations (reference neo4j.py:281-296)."""
        nid = incident_id if incident_id.startswith("incident:") else f"incident:{incident_id}"
        return 1 if self.remove_node(nid) else 0

    def cleanup_incidents(self, incident_ids: Iterable[str]) -> int:
        """Batch incident cleanup — one lock acquisition, one version bump."""
        nids = [i if i.startswith("incident:") else f"incident:{i}"
                for i in incident_ids]
        return self.remove_nodes(nids)

    # -- queries ----------------------------------------------------------

    @property
    def version(self) -> int:
        return self._version

    def node_count(self) -> int:
        return len(self._nodes)

    def edge_count(self) -> int:
        return len(self._edges)

    def get_node(self, node_id: str) -> Optional[dict[str, Any]]:
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                return None
            return {"id": node.id, "type": node.label, "properties": dict(node.properties)}

    def neighbors(self, node_id: str, direction: str = "both") -> list[tuple[str, str]]:
        """[(neighbor_id, relation_label)] — direction in {out,in,both}."""
        with self._lock:
            out: list[tuple[str, str]] = []
            if direction in ("out", "both"):
                out += [(d, RelationKind(k).name) for d, k in self._out.get(node_id, ())]
            if direction in ("in", "both"):
                out += [(s, RelationKind(k).name) for s, k in self._in.get(node_id, ())]
            return out

    def _undirected_coo(self) -> tuple[list[str], dict[str, int], Any, Any]:
        """Version-cached undirected COO edge index for the native BFS
        kernel, with the id→dense-row map (node .index has holes after
        removals, so rows are assigned here). Caller must hold the lock."""
        import numpy as np

        if self._coo_cache is not None and self._coo_cache[0] == self._version:
            return (self._coo_cache[1], self._coo_cache[2],
                    self._coo_cache[3], self._coo_cache[4])
        nodes = sorted(self._nodes.values(), key=lambda n: n.index)
        ids = [n.id for n in nodes]
        row = {n.id: i for i, n in enumerate(nodes)}
        m = len(self._edges)
        src = np.empty(2 * m, dtype=np.int32)
        dst = np.empty(2 * m, dtype=np.int32)
        for i, e in enumerate(self._edges.values()):
            s, d = row[e.src], row[e.dst]
            src[i], dst[i] = s, d
            src[m + i], dst[m + i] = d, s     # reverse edge: BFS is undirected
        self._coo_cache = (self._version, ids, row, src, dst)
        return ids, row, src, dst

    def get_incident_subgraph(self, incident_id: str, depth: int = 3) -> dict[str, Any]:
        """Depth-limited undirected subgraph around an incident — the
        reference's apoc.path.subgraphAll(maxLevel=depth) (neo4j.py:169-201).
        Graphs of ``_NATIVE_BFS_MIN_NODES`` nodes or more use the native C++
        BFS kernel (kernels/kaeg_native.cpp ``khop_reach``) over a
        version-cached COO index; smaller graphs use the Python BFS."""
        nid = incident_id if incident_id.startswith("incident:") else f"incident:{incident_id}"
        with self._lock:
            if nid not in self._nodes:
                return {"nodes": [], "relationships": []}
            seen = self._bfs_reach(nid, depth)
            nodes = [
                {"id": n.id, "type": n.label, "properties": dict(n.properties)}
                for n in (self._nodes[i] for i in seen)
            ]
            nodes.sort(key=lambda n: n["id"])
            rels = [
                {"source": e.src, "target": e.dst, "type": RelationKind(e.kind).name,
                 "properties": dict(e.properties)}
                for e in self._edges.values()
                if e.src in seen and e.dst in seen
            ]
            return {"nodes": nodes, "relationships": rels}

    def _bfs_reach(self, nid: str, depth: int) -> set[str]:
        """Node ids within `depth` undirected hops of `nid` (inclusive).
        Caller must hold the lock. At ``_NATIVE_BFS_MIN_NODES`` nodes or
        more, the native kernel (a library that cannot be built raises
        ``kernels._build.KernelError``); below, the Python BFS."""
        if len(self._nodes) >= self._NATIVE_BFS_MIN_NODES:
            from .. import native as _native
            ids, row, src, dst = self._undirected_coo()
            seed = row[nid]     # dense COO row, NOT .index (holes)
            reach = _native.khop_reach_native(src, dst, len(ids), seed, depth)
            return {ids[i] for i in reach.nonzero()[0]}
        seen = {nid}
        frontier = [nid]
        for _ in range(depth):
            nxt = []
            for cur in frontier:
                for d, _k in self._out.get(cur, ()):
                    if d not in seen:
                        seen.add(d)
                        nxt.append(d)
                for s, _k in self._in.get(cur, ()):
                    if s not in seen:
                        seen.add(s)
                        nxt.append(s)
            frontier = nxt
            if not frontier:
                break
        return seen

    def find_related_changes(
        self,
        namespace: str,
        window_start: datetime,
        window_end: datetime,
    ) -> list[dict[str, Any]]:
        """ChangeEvents in a namespace within a time window (neo4j.py:204-228)."""
        out = []
        with self._lock:
            for node in self._nodes.values():
                if node.kind != EntityKind.CHANGE_EVENT:
                    continue
                props = node.properties
                if props.get("namespace") != namespace:
                    continue
                ts = props.get("changed_at") or props.get("timestamp")
                if ts is None:
                    continue
                when = parse_iso(ts) if isinstance(ts, str) else ts
                if window_start <= when <= window_end:
                    out.append({"id": node.id, "properties": dict(props)})
        out.sort(key=lambda c: str(c["properties"].get("changed_at", "")), reverse=True)
        return out

    def find_affected_by_node(self, node_name: str) -> list[dict[str, Any]]:
        """Pods scheduled on a node plus their owning deployments/services
        (reference Pod→Deployment→Service traversal, neo4j.py:231-251)."""
        target = f"node:{node_name}" if not node_name.startswith("node:") else node_name
        results = []
        with self._lock:
            for src, kind in self._in.get(target, ()):
                if kind != RelationKind.SCHEDULED_ON:
                    continue
                pod = self._nodes.get(src)
                if pod is None:
                    continue
                owners = [
                    self._nodes[s].id for s, k in self._in.get(src, ())
                    if k == RelationKind.OWNS and s in self._nodes
                ]
                selectors = [
                    self._nodes[s].id for s, k in self._in.get(src, ())
                    if k == RelationKind.SELECTS and s in self._nodes
                ]
                results.append({
                    "pod": pod.id,
                    "owners": sorted(owners),
                    "services": sorted(selectors),
                })
        return sorted(results, key=lambda r: r["pod"])

    def get_service_dependencies(self, service_name: str) -> dict[str, list[str]]:
        """CALLS upstream/downstream of a service (neo4j.py:254-278)."""
        sid = service_name if service_name.startswith("service:") else f"service:{service_name}"
        with self._lock:
            downstream = sorted(
                d for d, k in self._out.get(sid, ()) if k == RelationKind.CALLS
            )
            upstream = sorted(
                s for s, k in self._in.get(sid, ()) if k == RelationKind.CALLS
            )
        return {"upstream": upstream, "downstream": downstream}

    def incident_ids(self) -> list[str]:
        with self._lock:
            return sorted(
                n.id for n in self._nodes.values() if n.kind == EntityKind.INCIDENT
            )

    # -- tensorization hooks (used by snapshot.py) ------------------------

    def _raw(self) -> tuple[list[_Node], list[_Edge]]:
        with self._lock:
            nodes = sorted(self._nodes.values(), key=lambda n: n.index)
            edges = list(self._edges.values())
        return nodes, edges

    # -- persistence (the Neo4j-durability analog; settings.graph_persist_path)

    def save(self, path: str) -> int:
        """Dump the graph as JSON lines (one node/edge per line) via an
        atomic rename. Returns the number of records written."""
        import json
        import os
        import tempfile

        nodes, edges = self._raw()
        d = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        n = 0
        try:
            with os.fdopen(fd, "w") as f:
                for node in nodes:
                    f.write(json.dumps({
                        "t": "n", "id": node.id, "label": node.label,
                        "properties": node.properties,
                    }, default=str) + "\n")
                    n += 1
                for edge in edges:
                    f.write(json.dumps({
                        "t": "e", "src": edge.src, "dst": edge.dst,
                        "kind": edge.kind.name, "properties": edge.properties,
                    }, default=str) + "\n")
                    n += 1
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return n

    @classmethod
    def load(cls, path: str) -> "EvidenceGraphStore":
        """Rebuild a store from a save() dump (insertion order preserved,
        so node indices — and therefore snapshots — are reproducible)."""
        import json

        store = cls()
        entities: list[GraphEntity] = []
        relations: list[GraphRelation] = []
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if rec["t"] == "n":
                    entities.append(GraphEntity(
                        id=rec["id"], type=rec["label"],
                        properties=rec["properties"]))
                else:
                    relations.append(GraphRelation(
                        source_id=rec["src"], target_id=rec["dst"],
                        relation_type=rec["kind"],
                        properties=rec["properties"]))
        store.upsert_entities(entities)
        store.upsert_relations(relations)
        return store
