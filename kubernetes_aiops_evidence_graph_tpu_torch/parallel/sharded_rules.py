"""Multi-device rules scoring — the batched RCA pass sharded over ``dp``,
and over ``graph`` when the feature table is split into node blocks.

Incident scoring is embarrassingly parallel across incidents (each row of
the dense evidence table folds independently — rca/cuda_backend.py), so
the scale-out story is data parallelism: the host splits the batch's
incident rows into D contiguous blocks, node features stay replicated
(every position gathers arbitrary global node indices), and every dp
position launches the whole ``rules_fold`` (B1) on its row block with no
collective at all. The dp outputs are concatenated in row order.

All batch arrays are row-aligned ([Pi, ...]), including the per-slot pair
ids for multiple_pods_same_node, so sharding is a pure reshape.

The graph-sharded variant splits the feature table into G contiguous node
blocks over the ``graph`` axis. Each position folds only the slots whose
global node id lies in its own block
(``kernels/rules_fold.rules_fold_partial``), ONE sum over ``graph``
(``compat.psum``, in position order) completes the counts, and
``rules_tail`` runs the tail once a dp row, at graph position 0, whose
outputs ``compat.concat_dp`` reads: G partial launches a dp row, the same
owner fold as the graph-sharded streaming tick. A position's memory is
O(Pn/G · DIM); the axis exists for capacity, not FLOPs.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.rules_fold import rules_fold, rules_fold_partial, rules_tail
from ..rca.cuda_backend import DeviceBatch
from . import compat
from .mesh import Mesh, dp_sharded, graph_sharded, replicated


@dataclass(frozen=True)
class ShardedBatch:
    """DeviceBatch split into D stacked incident-row blocks."""
    num_shards: int
    rows_per_shard: int          # Pi/D
    num_incidents: int
    pair_width: int
    ev_idx: np.ndarray           # [D, Pi/D, W]
    ev_cnt: np.ndarray           # [D, Pi/D]
    ev_pair_slot: np.ndarray     # [D, Pi/D, W]
    features: np.ndarray         # [Pn, DIM] replicated


def shard_batch(batch: DeviceBatch, dp: int) -> ShardedBatch:
    """Split a prepared DeviceBatch into ``dp`` contiguous row blocks."""
    pi = batch.padded_incidents
    if pi % dp:
        raise ValueError(f"padded incidents {pi} not divisible by dp={dp}")
    rows = pi // dp
    return ShardedBatch(
        num_shards=dp, rows_per_shard=rows, num_incidents=batch.num_incidents,
        pair_width=batch.pair_width,
        ev_idx=batch.ev_idx.reshape(dp, rows, -1).astype(np.int32),
        ev_cnt=batch.ev_cnt.reshape(dp, rows).astype(np.int32),
        ev_pair_slot=batch.ev_pair_slot.reshape(dp, rows, -1).astype(np.int32),
        features=batch.features,
    )


def make_sharded_score(mesh: Mesh, rows_per_shard: int, pair_width: int):
    """Scoring pass over the mesh's ``dp`` axis.

    Returns fn(features, ev_idx, ev_cnt, ev_pair_slot) over the placed
    arrays of :func:`device_put_sharded_batch`. Each dp position launches
    ``rules_fold`` on its [Pi/D, ...] block and the blocks are
    concatenated back to global [Pi, ...] outputs (conds, matched,
    scores, top_idx, any_match, top_conf, top_score) in row order."""

    def local_score(pos, features, ev_idx, ev_cnt, ev_pair_slot):
        zero = torch.zeros(rows_per_shard, dtype=torch.float32,
                           device=pos.device)
        return rules_fold(features, ev_idx[0], ev_cnt[0], ev_pair_slot[0],
                          zero, pair_width)

    def score(features, ev_idx, ev_cnt, ev_pair_slot):
        with compat.session(mesh):
            outs = compat.run(mesh, local_score, features, ev_idx, ev_cnt,
                              ev_pair_slot, where=lambda p: p.graph == 0)
            return compat.concat_dp(outs, mesh)

    return score


def device_put_sharded_batch(sb: ShardedBatch, mesh: Mesh) -> tuple:
    """Place arrays: features replicated, everything else dp-sharded."""
    rep, dp = replicated(mesh), dp_sharded(mesh)
    return (compat.place(sb.features, rep),
            compat.place(sb.ev_idx, dp), compat.place(sb.ev_cnt, dp),
            compat.place(sb.ev_pair_slot, dp))


# -- graph-sharded variant: node features split over the 'graph' axis ------

def evidence_fold_block(h_blk, ev_idx, ev_cnt, ev_pair_slot, lo: int, *,
                        nodes_per_shard: int, pair_width: int):
    """The fold of the evidence slots whose GLOBAL node id lives in
    ``[lo, lo + nodes_per_shard)`` of node block ``h_blk``:
    (counts [rows, DIM], pair_counts [rows, pair_width]), by
    ``rules_fold_partial``. Out-of-block slots contribute nothing, so
    folding every block once reproduces the single-device fold's sums.
    Shared by the graph-sharded snapshot pass below and the owner fold of
    the graph-sharded streaming tick (parallel/sharded_streaming.py)."""
    return rules_fold_partial(h_blk, lo, nodes_per_shard, ev_idx, ev_cnt,
                              ev_pair_slot, pair_width)


def make_graph_sharded_score(mesh: Mesh, rows_per_shard: int,
                             nodes_per_shard: int, pair_width: int):
    """Scoring over a (dp × graph) mesh with sharded features.

    fn(features_blocks, ev_idx, ev_cnt, ev_pair_slot) over the placed
    arrays of :func:`device_put_graph_sharded` -> global [Pi, ...]
    outputs."""
    from ..graph.schema import DIM

    def score(features, ev_idx, ev_cnt, ev_pair_slot):
        def fold(pos, blk, ev_i, ev_c, ev_p):
            c, pc = evidence_fold_block(
                blk, ev_i[0], ev_c[0], ev_p[0],
                pos.graph * nodes_per_shard,
                nodes_per_shard=nodes_per_shard, pair_width=pair_width)
            return torch.cat([c, pc], dim=1)

        def tail(pos, total):
            chain = torch.zeros(rows_per_shard, dtype=torch.float32,
                                device=pos.device)
            return rules_tail(total[:, :DIM], total[:, DIM:], chain)

        with compat.session(mesh):
            sums = compat.psum(compat.run(mesh, fold, features, ev_idx,
                                          ev_cnt, ev_pair_slot), mesh)
            outs = compat.run(mesh, tail, sums,
                              where=lambda p: p.graph == 0)
            return compat.concat_dp(outs, mesh)

    return score


def device_put_graph_sharded(sb: ShardedBatch, mesh: Mesh,
                             graph: int) -> tuple:
    """Place arrays for the graph-sharded pass: features split into
    ``graph`` contiguous node blocks, everything else dp-sharded."""
    pn = sb.features.shape[0]
    if pn % graph:
        raise ValueError(f"padded nodes {pn} not divisible by graph={graph}")
    dp = dp_sharded(mesh)
    return (compat.place(sb.features, graph_sharded(mesh)),
            compat.place(sb.ev_idx, dp), compat.place(sb.ev_cnt, dp),
            compat.place(sb.ev_pair_slot, dp))
