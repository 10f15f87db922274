"""Device-computed blast propagation — "which parts of the mesh feel this
incident".

Product surface for ops/propagate.py's two primitives. Seeds the incident
node, bounds the blast set with :func:`~..ops.propagate.k_hop_reach` (the
apoc.path.subgraphAll maxLevel analog, neo4j.py:169-201), and ranks nodes
inside that set by iterated label propagation — entities topologically
closer to the incident through denser paths score higher than the flat
membership the reference's Cypher traversal returns. Complements the
arithmetic blast-radius formula (remediation/orchestrator.py): that scores
the proposed ACTION, this maps the topological SPREAD.

The port's copy of the JAX package's ``rca/blast.py``: the same map, on
an explicit ``device`` (default: the CUDA device, which raises without
one; the tests pass ``"cpu"``).
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from ..config import Settings
from ..device import resolve_device
from ..graph.snapshot import GraphSnapshot, build_snapshot
from ..graph.store import EvidenceGraphStore
from ..ops.propagate import k_hop_reach, propagate_labels
from .cuda_backend import fetch

# snapshot cache keyed by (live) store + version: repeated API calls against
# an unchanged graph skip the O(N) tensorize. Weak keys mean entries die
# with their store — no unbounded growth across tests, and no id()-reuse
# aliasing serving a dead store's snapshot to a new one.
_CACHE: "weakref.WeakKeyDictionary[EvidenceGraphStore, tuple[int, Settings | None, GraphSnapshot]]" = \
    weakref.WeakKeyDictionary()


def _snapshot(store: EvidenceGraphStore, settings: Settings | None) -> GraphSnapshot:
    hit = _CACHE.get(store)
    if hit is not None and hit[0] == store.version and hit[1] is settings:
        return hit[2]
    snap = build_snapshot(store, settings)
    _CACHE[store] = (store.version, settings, snap)
    return snap


def blast_propagation(
    store: EvidenceGraphStore,
    incident_id: str,
    settings: Settings | None = None,
    hops: int = 3,
    iterations: int = 3,
    alpha: float = 0.5,
    top_k: int = 25,
    device: "str | torch.device | None" = None,
) -> dict | None:
    """Propagated blast map for one incident; None if it isn't in the graph."""
    dev = resolve_device(device)
    nid = incident_id if incident_id.startswith("incident:") \
        else f"incident:{incident_id}"
    snap = _snapshot(store, settings)
    if nid not in snap.node_ids:
        return None
    seed = snap.node_ids.index(nid)
    pn = snap.padded_nodes
    src, dst, emask, nmask = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                              for a in (snap.edge_src, snap.edge_dst,
                                        snap.edge_mask, snap.node_mask))

    reach = k_hop_reach(
        torch.tensor([seed], dtype=torch.int32, device=dev),
        torch.ones(1, dtype=torch.float32, device=dev),
        src, dst, emask, num_nodes=pn, hops=hops)[0]
    x = torch.zeros(pn, dtype=torch.float32, device=dev)
    x[seed] = 1.0
    scores = propagate_labels(x, src, dst, emask, num_nodes=pn,
                              iterations=iterations, alpha=alpha)

    # rank only nodes inside the k-hop blast set; drop pads and the seed.
    # ONE fetch for both outputs (a single wait for the device)
    reach_masked = reach * nmask.float()
    ranked, reach_host = fetch((scores * reach_masked, reach_masked))
    ranked = np.array(ranked)
    ranked[seed] = 0.0
    order = np.argsort(-ranked, kind="stable")
    blast = []
    for i in order[:top_k]:
        if ranked[i] <= 0.0:
            break
        node = store.get_node(snap.node_ids[i])
        blast.append({
            "id": snap.node_ids[i],
            "type": node["type"] if node else "?",
            "score": round(float(ranked[i]), 6),
        })
    n_reached = int(reach_host.sum()) - 1
    return {
        "incident": nid,
        "hops": hops,
        "iterations": iterations,
        "reached_nodes": max(n_reached, 0),
        "blast": blast,
    }
