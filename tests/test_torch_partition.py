"""The port's graph partitioner (``parallel/partition.py``), its shared
per-shard slice offsets (``parallel/sharded_streaming.
shared_shard_offsets``) and the learned path's halo collectives
(``parallel/compat.ring_shift`` / ``all_gather``), against the JAX
package: the same seeded snapshot partitions into equal arrays, field by
field, at (dp, graph) ∈ {(1, 2), (2, 2), (1, 4)}."""
import numpy as np
import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu.parallel.partition import (
    partition_snapshot as jpartition)
from kubernetes_aiops_evidence_graph_tpu.parallel.sharded_streaming import (
    shared_shard_offsets as jshared)
from kubernetes_aiops_evidence_graph_tpu.rca import train as jtrain
from kubernetes_aiops_evidence_graph_tpu_torch.graph.schema import (
    RelationKind)
from kubernetes_aiops_evidence_graph_tpu_torch.ladders import (
    REL_SLICE_BUCKETS)
from kubernetes_aiops_evidence_graph_tpu_torch.parallel import compat
from kubernetes_aiops_evidence_graph_tpu_torch.parallel.mesh import make_mesh
from kubernetes_aiops_evidence_graph_tpu_torch.parallel.partition import (
    partition_snapshot)
from kubernetes_aiops_evidence_graph_tpu_torch.parallel.sharded_streaming \
    import shared_shard_offsets
from kubernetes_aiops_evidence_graph_tpu_torch.rca import train as ttrain

torch.set_num_threads(1)

FIELDS = ("features", "node_kind", "node_mask", "edge_src", "edge_dst_local",
          "edge_rel", "edge_mask", "incident_nodes", "incident_mask",
          "labels")


@pytest.fixture(scope="module")
def episodes():
    """One seeded labeled episode with its snapshot, from each package
    (their arrays are equal: tests/test_torch_train.py)."""
    kw = dict(num_incidents=8, seed=3, return_snapshot=True)
    return (ttrain.make_dataset(1, 200, **kw)[0],
            jtrain.make_dataset(1, 200, **kw)[0])


@pytest.mark.parametrize("dp,graph", [(1, 2), (2, 2), (1, 4)])
def test_partition_equals_jax_field_by_field(episodes, dp, graph):
    """Every array, the nodes per shard and the shared offsets equal the
    JAX partition; each shard's slices are dst-sorted with one offset
    table, and every live edge lands on exactly one shard."""
    mine, ref = episodes
    part = partition_snapshot(mine["snapshot"], dp, graph,
                              labels=mine["labels"])
    jpart = jpartition(ref["snapshot"], dp, graph, labels=ref["labels"])
    for f in FIELDS:
        a, b = getattr(part, f), np.asarray(getattr(jpart, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert part.nodes_per_shard == jpart.nodes_per_shard
    assert part.rel_offsets == tuple(jpart.rel_offsets)
    offs = part.rel_offsets
    assert len(offs) == len(RelationKind) + 1
    assert offs[-1] == part.edge_src.shape[1]
    live_total = 0
    for s in range(graph):
        for r in range(len(RelationKind)):
            sl = slice(offs[r], offs[r + 1])
            d = part.edge_dst_local[s][sl]
            assert (d[1:] >= d[:-1]).all(), (s, r)
            live = part.edge_mask[s][sl] > 0
            assert (part.edge_rel[s][sl][live] == r).all()
            live_total += int(live.sum())
    assert live_total == int((mine["snapshot"].edge_mask > 0).sum())


def test_partition_rejects_a_node_count_that_does_not_divide(episodes):
    snap = episodes[0]["snapshot"]
    with pytest.raises(ValueError, match="not divisible"):
        partition_snapshot(snap, 1, 3)


@pytest.mark.parametrize("seed", [0, 5])
def test_shared_shard_offsets_equal_jax(seed):
    """The serving mirror's shared region capacities: the max count over
    shards, with growth slack and a minimum slice, up the ladder."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 3000, size=(4, len(RelationKind)))
    counts[:, 2] = 0                      # an unseen relation: min_cap
    for slack, cap in ((1 / 3, REL_SLICE_BUCKETS[0]), (0.0, 0)):
        assert shared_shard_offsets(counts, slack, cap) == tuple(
            jshared(counts, slack, cap))


def test_ring_shift_and_all_gather_move_blocks_and_count():
    """One ring hop moves position g's block to g+1 (mod D) in each dp
    row; the all-gather concatenates a row's blocks in position order at
    every position; both keep autograd and count themselves."""
    mesh = make_mesh(2, 3, ["cpu"] * 6)
    base = torch.arange(6 * 4, dtype=torch.float32).view(6, 4)
    leaf = base.clone().requires_grad_(True)
    blocks = np.empty((2, 3), dtype=object)
    for i in range(2):
        for g in range(3):
            blocks[i, g] = leaf[(i * 3 + g):(i * 3 + g) + 1] * 1.0
    hops, gathers = compat.ring_hops, compat.all_gathers
    shifted = compat.ring_shift(blocks, mesh)
    for i in range(2):
        for g in range(3):
            assert torch.equal(shifted[i, (g + 1) % 3], blocks[i, g])
    full = compat.all_gather(shifted, mesh)
    for i in range(2):
        want = torch.cat([base[i * 3 + (g - 1) % 3][None] for g in range(3)])
        for g in range(3):
            assert torch.equal(full[i, g], want)
    assert (compat.ring_hops - hops, compat.all_gathers - gathers) == (1, 1)
    sum(t.sum() * (k + 1) for k, t in enumerate(full.ravel())).backward()
    # row 0's positions weigh 1 + 2 + 3, row 1's 4 + 5 + 6
    want = torch.tensor([6.0] * 3 + [15.0] * 3)[:, None].expand(6, 4)
    assert torch.equal(leaf.grad, want)
