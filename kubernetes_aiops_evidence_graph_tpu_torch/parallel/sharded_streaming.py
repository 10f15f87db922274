"""The RESIDENT rules serving state sharded over a mesh (the rules half of
the JAX package's ``parallel/sharded_streaming.py``).

One ``StreamingScorer`` holds one resident state. With a mesh
(``settings.serve_graph_shards`` or ``mesh_dp``), the state is laid out
over the mesh's positions (``parallel/compat.py``):

* **State layout.** The feature table splits into D contiguous node
  blocks over ``graph`` (owner = row // (Pn/D)), or stays whole at every
  position on a dp-only mesh. Evidence tables and the chain split into
  contiguous row blocks over ``dp`` (replicated over ``graph``).

* **Delta routing.** The host routes each feature delta to its owner
  shard with PER-SHARD ``DELTA_BUCKETS`` sub-buckets
  (:func:`route_node_delta`): the delta width is the max over shards, and
  within each shard deltas keep store-journal order (the staging order of
  the pending rows) — replay determinism is a routing invariant.

* **Ticks.** :func:`sharded_rules_tick`: each position copies its own
  shard's feature rows and the evidence-row delta of its dp block in
  place, folds ONLY the slots whose node lives in its own block
  (``kernels/rules_fold.rules_fold_partial``), ONE sum over the graph axis
  of the concatenated ``[rows, DIM + pair_width]`` partials
  (``compat.psum``, in position order) completes the fold, and
  ``rules_tail`` gives the verdicts. Out-of-block slots add nothing, so
  for the integer-valued features the rules read the verdicts equal the
  single-device tick's bit for bit. :func:`dp_rules_tick` (a dp-only mesh,
  or a node bucket that does not divide over ``graph``): every position
  keeps a whole feature table, and each dp position launches the whole
  ``rules_fold`` on its row block.

* **In place.** Both ticks update the resident blocks in place, like the
  single-device tick; nothing is reallocated.

Waiting for the GNN slice: ``sharded_gnn_tick`` and
``shared_shard_offsets`` (the learned scorer's mesh, ROADMAP item 9b).
"""
from __future__ import annotations

import numpy as np
import torch

from ..graph.schema import DIM
from ..kernels.rules_fold import (rules_fold, rules_fold_partial_packed,
                                  rules_tail)
from ..observability import scope as obs_scope
from . import compat
from .mesh import Mesh


def owner_of(rows, nodes_per_shard: int):
    """Owner shard of each global node row — the contiguous-block
    assignment of the graph placement."""
    return np.asarray(rows, np.int64) // int(nodes_per_shard)


def route_node_delta(entries, nodes_per_shard: int, shards: int,
                     buckets: tuple[int, ...]):
    """Route host-side node deltas to their owner shards with per-shard
    sub-buckets.

    ``entries`` is an iterable of ``(global_row, payload...)`` tuples in
    STORE-JOURNAL order. Returns ``(idx, payload_lists, pk)`` where
    ``idx`` is [D, pk] of SHARD-LOCAL rows (padding = the out-of-range
    sentinel ``nodes_per_shard``), ``payload_lists`` is a list of
    per-shard entry lists aligned with the live prefix of each shard's
    row, and ``pk`` is the shared sub-bucket width — ``bucket_for`` of the
    MAX per-shard count, so one hot shard sets the width for all. Within
    each shard the journal order is preserved verbatim (replay
    determinism depends on it)."""
    from ..utils.padding import bucket_for
    per_shard: list[list] = [[] for _ in range(shards)]
    for e in entries:
        g = int(e[0]) // nodes_per_shard
        per_shard[g].append(e)
    k = max((len(s) for s in per_shard), default=0)
    # per-shard routing counts: the imbalance gauge (one hot shard sets
    # the delta width for every shard) and the shard_rows field of the
    # next tick's flight record
    obs_scope.note_route(len(s) for s in per_shard)
    pk = bucket_for(max(k, 1), buckets)
    idx = np.full((shards, pk), nodes_per_shard, np.int32)
    for g, ents in enumerate(per_shard):
        for j, e in enumerate(ents):
            idx[g, j] = int(e[0]) - g * nodes_per_shard
    return idx, per_shard, pk


def _delta_views(slab: torch.Tensor, shard: int, shards: int, li: int,
                 pk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Shard ``shard``'s packed ints [li] and feature rows [pk, DIM] of a
    staged mesh slab laid out ``[ints: shards x li | rows: shards x pk x
    DIM, as int32 bits]``."""
    ints = slab[shard * li:(shard + 1) * li]
    base = shards * li + shard * pk * DIM
    rows = slab[base:base + pk * DIM].view(torch.float32).view(pk, DIM)
    return ints, rows


def _scatter(feats, ints, rows, f_live: int, ev_idx, ev_cnt, ev_pair,
             r_span: tuple[int, int], row_lo: int, pk: int, rk: int,
             width: int) -> None:
    """Copy one position's share of a tick's delta into its resident
    blocks IN PLACE: the first ``f_live`` routed feature rows (already
    block-local), and the evidence rows ``r_idx[a:b]`` of its dp block
    (``r_span``: the host found them, the row delta being sorted)."""
    if f_live:
        feats.index_copy_(0, ints[:f_live].long(), rows[:f_live])
    a, b = r_span
    if b > a:
        r_idx = ints[pk:pk + rk]
        r_cnt = ints[pk + rk:pk + 2 * rk]
        off = pk + 2 * rk
        r_ev = ints[off:off + rk * width].view(rk, width)
        r_pair = ints[off + rk * width:off + 2 * rk * width].view(rk, width)
        local = r_idx[a:b].long() - row_lo
        ev_idx.index_copy_(0, local, r_ev[a:b])
        ev_cnt.index_copy_(0, local, r_cnt[a:b])
        ev_pair.index_copy_(0, local, r_pair[a:b])


def sharded_rules_tick(mesh: Mesh, nodes_per_shard: int, rows_per_shard: int,
                       pair_width: int, pk: int, rk: int, width: int):
    """Graph-sharded rules tick: per-position scatter, the owner fold,
    one sum over ``graph``, the tail.

    Returns ``tick(features, slabs, ev_idx, ev_cnt, ev_pair, chain,
    f_live, r_spans)``: the resident :class:`compat.Sharded` blocks, the
    staged slab uploaded once per device (``{device: slab}``, see
    :func:`_delta_views`; ``pk`` is the per-shard sub-bucket), the live
    feature rows per shard and each dp block's span of the sorted row
    delta. Returns the seven outputs of ``rules_fold``, [Pi, ...], on the
    mesh's first device."""
    g_size = mesh.shape["graph"]
    li = pk + 2 * rk + 2 * rk * width

    def tick(features, slabs, ev_idx, ev_cnt, ev_pair, chain, f_live,
             r_spans):
        def owner_fold(pos, feats, ev_i, ev_c, ev_p):
            ints, rows = _delta_views(slabs[pos.device], pos.graph, g_size,
                                      li, pk)
            _scatter(feats, ints, rows, f_live[pos.graph], ev_i, ev_c, ev_p,
                     r_spans[pos.dp], pos.dp * rows_per_shard, pk, rk,
                     width)
            return rules_fold_partial_packed(
                feats, pos.graph * nodes_per_shard, nodes_per_shard, ev_i,
                ev_c, ev_p, pair_width)

        parts = compat.run(mesh, owner_fold, features, ev_idx, ev_cnt,
                           ev_pair)
        # ONE collective completes the fold: the [rows, DIM + PW] partials
        # summed over the graph axis in position order
        folded = compat.psum(parts, mesh)

        def tail(pos, total, ch):
            return rules_tail(total[:, :DIM], total[:, DIM:], ch)

        outs = compat.run(mesh, tail, folded, chain,
                          where=lambda p: p.graph == 0)
        return compat.concat_dp(outs, mesh)

    return tick


def dp_rules_tick(mesh: Mesh, rows_per_shard: int, pair_width: int, pk: int,
                  rk: int, width: int):
    """Rules tick with the feature table whole at every position: each
    position applies the whole feature delta and its dp block's row
    delta, and graph position 0 of each dp row launches ``rules_fold`` on
    its row block (further graph positions keep their replicas in step).
    Same signature as :func:`sharded_rules_tick` (one routed shard)."""
    li = pk + 2 * rk + 2 * rk * width

    def tick(features, slabs, ev_idx, ev_cnt, ev_pair, chain, f_live,
             r_spans):
        def local(pos, feats, ev_i, ev_c, ev_p, ch):
            ints, rows = _delta_views(slabs[pos.device], 0, 1, li, pk)
            _scatter(feats, ints, rows, f_live[0], ev_i, ev_c, ev_p,
                     r_spans[pos.dp], pos.dp * rows_per_shard, pk, rk,
                     width)
            if pos.graph:
                return None
            return rules_fold(feats, ev_i, ev_c, ev_p, ch, pair_width)

        outs = compat.run(mesh, local, features, ev_idx, ev_cnt, ev_pair,
                          chain)
        return compat.concat_dp(outs, mesh)

    return tick
