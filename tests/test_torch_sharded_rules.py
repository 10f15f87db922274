"""Multi-device rules scoring (``parallel/sharded_rules.py``) on the CPU:
meshes of repeated ``cpu`` positions, each running the kernels' plain
versions. The dp pass and the graph-sharded ring pass equal the JAX
package's ``make_sharded_score``/``make_graph_sharded_score`` on its
8-device virtual mesh and the port's single pass, exactly; B1's split
(``rules_fold_partial`` summed over the blocks in block order, then
``rules_tail``) equals ``rules_fold_reference`` bit for bit."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

from kubernetes_aiops_evidence_graph_tpu_torch.graph.schema import DIM
from kubernetes_aiops_evidence_graph_tpu_torch.kernels import rules_fold as rf
from kubernetes_aiops_evidence_graph_tpu_torch.parallel import (
    device_put_graph_sharded, device_put_sharded_batch,
    make_graph_sharded_score, make_mesh, make_sharded_score, shard_batch)
from kubernetes_aiops_evidence_graph_tpu_torch.rca.cuda_backend import (
    CudaRcaBackend, prepare_batch)

# one intra-op thread: these tensors are small, and the suite runs
# several pytest workers side by side on the host's cores
torch.set_num_threads(1)

NAMES = ("conds", "matched", "scores", "top_idx", "any_match", "top_conf",
         "top_score")


def _world(pkg: str, num_pods=64, num_incidents=6, seed=0):
    """tests/test_sharded_rules.py's world, built by ``pkg``."""
    import importlib
    mod = lambda n: importlib.import_module(f"{pkg}.{n}")   # noqa: E731
    settings = mod("config").load_settings(
        node_bucket_sizes=(256, 512), incident_bucket_sizes=(8, 16))
    sim = mod("simulator")
    cluster = sim.generate_cluster(num_pods=num_pods, seed=seed)
    rng = np.random.default_rng(seed)
    keys = sorted(cluster.deployments)
    names = sorted(sim.SCENARIOS)
    builder = mod("graph").GraphBuilder()
    mod("graph.topology_sync").sync_topology(cluster, builder.store)
    col = mod("collectors")
    for i in range(num_incidents):
        inc = sim.inject(cluster, names[i % len(names)],
                         keys[(i * 3) % len(keys)], rng)
        builder.ingest(inc, col.collect_all(
            inc, col.default_collectors(cluster, settings), parallel=False))
    return mod("graph").build_snapshot(builder.store, settings,
                                       now_s=cluster.now.timestamp())


@pytest.fixture(scope="module")
def worlds():
    port = _world("kubernetes_aiops_evidence_graph_tpu_torch")
    jsnap = _world("kubernetes_aiops_evidence_graph_tpu")
    return port, jsnap, CudaRcaBackend("cpu").score_snapshot(port)


def _assert_equal_to(outs, raw, n, jax_outs=None):
    conds, matched, scores, top_idx, any_match, top_conf, top_score = (
        o.numpy() for o in outs)
    np.testing.assert_array_equal(any_match[:n], raw["any_match"])
    np.testing.assert_array_equal(top_idx[:n], raw["top_rule_index"])
    np.testing.assert_array_equal(top_score[:n], raw["top_score"])
    np.testing.assert_array_equal(top_conf[:n], raw["top_confidence"])
    np.testing.assert_array_equal(conds[:n], raw["conditions"])
    np.testing.assert_array_equal(matched[:n], raw["matched"])
    np.testing.assert_array_equal(scores[:n], raw["scores"])
    if jax_outs is not None:
        for name, a, b in zip(NAMES, (conds, matched, scores, top_idx,
                                      any_match, top_conf, top_score),
                              jax_outs):
            np.testing.assert_array_equal(
                a.astype(np.float64), np.asarray(b).astype(np.float64),
                err_msg=name)


@pytest.mark.parametrize("dp", [2, 8])
def test_sharded_scoring_matches_jax_and_the_single_pass(worlds, dp):
    from kubernetes_aiops_evidence_graph_tpu.parallel import make_mesh as jm
    from kubernetes_aiops_evidence_graph_tpu.parallel.sharded_rules import (
        device_put_sharded_batch as jput, make_sharded_score as jscore,
        shard_batch as jshard)
    from kubernetes_aiops_evidence_graph_tpu.rca.tpu_backend import (
        prepare_batch as jprep)
    snap, jsnap, raw = worlds
    batch = prepare_batch(snap)
    assert batch.padded_incidents % dp == 0

    mesh = make_mesh(dp=dp, graph=1, devices=["cpu"] * dp)
    sb = shard_batch(batch, dp)
    assert sb.ev_idx.shape[0] == dp and sb.rows_per_shard * dp == \
        batch.padded_incidents
    score = make_sharded_score(mesh, sb.rows_per_shard, sb.pair_width)
    outs = score(*device_put_sharded_batch(sb, mesh))

    jmesh = jm(dp=dp, graph=1, devices=jax.devices()[:dp])
    jsb = jshard(jprep(jsnap), dp)
    jouts = jax.device_get(jscore(jmesh, jsb.rows_per_shard, jsb.pair_width)(
        *jput(jsb, jmesh)))
    _assert_equal_to(outs, raw, snap.num_incidents, jouts)


def test_shard_batch_rejects_indivisible(worlds):
    batch = prepare_batch(_world("kubernetes_aiops_evidence_graph_tpu_torch",
                                 num_incidents=4))
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(batch, 3)
    snap, _jsnap, _raw = worlds
    sb = shard_batch(prepare_batch(snap), 2)
    with pytest.raises(ValueError, match="not divisible"):
        device_put_graph_sharded(sb, make_mesh(2, 3, ["cpu"] * 6), 3)


@pytest.mark.parametrize("dp,graph", [(2, 4), (1, 8)])
def test_graph_sharded_scoring_matches_jax_and_the_single_pass(worlds, dp,
                                                               graph):
    """The ring fold over node blocks == the single-device pass == JAX's
    ring fold at the same mesh shape; every position folds every block
    once (G partial launches a position on the card)."""
    from kubernetes_aiops_evidence_graph_tpu.parallel import make_mesh as jm
    from kubernetes_aiops_evidence_graph_tpu.parallel.sharded_rules import (
        device_put_graph_sharded as jput,
        make_graph_sharded_score as jscore, shard_batch as jshard)
    from kubernetes_aiops_evidence_graph_tpu.rca.tpu_backend import (
        prepare_batch as jprep)
    snap, jsnap, raw = worlds
    batch = prepare_batch(snap)
    assert snap.padded_nodes % graph == 0

    mesh = make_mesh(dp=dp, graph=graph, devices=["cpu"] * (dp * graph))
    sb = shard_batch(batch, dp)
    args = device_put_graph_sharded(sb, mesh, graph)
    assert args[0].placement.axis == "graph"
    assert args[0].blocks[0, graph - 1].shape == (snap.padded_nodes // graph,
                                                  DIM)
    score = make_graph_sharded_score(
        mesh, sb.rows_per_shard, nodes_per_shard=snap.padded_nodes // graph,
        pair_width=sb.pair_width)
    outs = score(*args)

    jmesh = jm(dp=dp, graph=graph, devices=jax.devices()[:dp * graph])
    jsb = jshard(jprep(jsnap), dp)
    jouts = jax.device_get(jscore(
        jmesh, jsb.rows_per_shard, nodes_per_shard=jsnap.padded_nodes // graph,
        pair_width=jsb.pair_width)(*jput(jsb, jmesh, graph)))
    _assert_equal_to(outs, raw, snap.num_incidents, jouts)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (NaN included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(
            torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_partials_summed_in_block_order_then_tail_equal_rules_fold(shards):
    """The plain rules_fold_partial over each node block, summed in block
    order, then the plain rules_tail: bit-equal to rules_fold_reference
    on the fold's edge rows (``chip_smoke.fold_edge_rows``: ev_cnt 0, W,
    past W and negative, invalid ids between live slots, pair ids outside
    the width, NaN features, a negative and a NaN chain), at a wide slot
    width (fold chunks) and a wide pair width (pair chunks); a block's
    partial has no out-of-block slot in it."""
    import chip_smoke
    for pn, pi, width, pw in ((512, 40, 300, 128), (256, 24, 16, 4)):
        k_args, p_args = chip_smoke.fold_edge_rows(shards, pn, pi, width,
                                                   pw, "cpu")
        features, ev_idx, ev_cnt, ev_pair, chain = k_args
        want = rf.rules_fold_reference(*p_args, pw)
        nps = pn // shards
        total = None
        for g in range(shards):
            blk = features[g * nps:(g + 1) * nps].contiguous()
            counts, pairs = rf.rules_fold_partial(
                blk, g * nps, nps, ev_idx, ev_cnt, ev_pair, pw)
            packed = rf.rules_fold_partial_packed(
                blk, g * nps, nps, ev_idx, ev_cnt, ev_pair, pw)
            assert _same_bits(packed, torch.cat([counts, pairs], dim=1))
            total = packed if total is None else total + packed
        got = rf.rules_tail(total[:, :DIM], total[:, DIM:], chain)
        for name, a, b in zip(NAMES, got, want):
            assert _same_bits(a, b), (name, pn)
    # a block with none of a row's ids folds exact zeros for it
    (features, ev_idx, ev_cnt, ev_pair, _), _ = chip_smoke.fold_edge_rows(
        0, 64, 8, 8, 4, "cpu")
    ev_idx[:] = 0
    counts, pairs = rf.rules_fold_partial(features[32:].contiguous(), 32, 32,
                                          ev_idx, ev_cnt, ev_pair, 4)
    assert not counts.any() and not pairs.any()


def test_partial_bound_reads_pair_ids_of_in_block_slots_only():
    """``partial_bound_bytes`` counts the distinct in-block feature rows,
    the node id of every live slot, the pair id of the in-block slots
    alone, ev_cnt and the ``[Pi, DIM + pair_width]`` partial."""
    ev_idx = np.array([[0, 5, 9, 1], [6, 6, 2, 0]], np.int32)
    ev_cnt = np.array([3, 4], np.int32)           # live: 0 5 9 | 6 6 2 0
    pw = 4
    # block [4, 8): in-block live slots 5, 6, 6 (distinct rows 5 and 6)
    want = (2 * DIM * 4 + 7 * 4 + 3 * 4 + 2 * 4 + 2 * (DIM + pw) * 4)
    assert rf.partial_bound_bytes(ev_idx, ev_cnt, 4, 4, pw) == want
    # a block no live slot falls in reads only the node ids
    assert rf.partial_bound_bytes(ev_idx, ev_cnt, 12, 4, pw) == (
        7 * 4 + 2 * 4 + 2 * (DIM + pw) * 4)
