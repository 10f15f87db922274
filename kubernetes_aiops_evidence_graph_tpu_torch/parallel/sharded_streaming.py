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

  :func:`sharded_gnn_tick` (the learned scorer): each position copies
  its routed mirror delta in place, then the ring-halo message pass — per
  layer the ``[Pe_shard, H]`` source rows of the position's edges are
  ASSEMBLED over D ring hops of the ``[Pn/D, H]`` embedding blocks (each
  slot's row arrives from exactly one block; the masked adds are exact),
  and ``kernels/gms`` runs shard-local on them. The readout streams the
  incident embeddings out of the ring: ``(LAYERS+1)·D`` ring hops a tick
  and no all-gather (``compat.ring_hops``).

* **In place.** The ticks update the resident blocks in place, like the
  single-device ticks; nothing is reallocated.

* **Parity.** The learned tick is bit-identical across pipeline depths at
  a fixed D, and bit-identical to D = 1 on a freshly mirrored state: each
  per-shard region keeps its destinations' edges in store order,
  relation-major, as the single-device layout does, so ``kernels/gms``
  sums every destination's messages in the same order. Slot reuse under
  churn reorders those sums: verdicts stay equal to D = 1, probs to float
  tolerance.
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
from .sharded_gnn import _in_block


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
        with compat.session(mesh):
            return _tick(features, slabs, ev_idx, ev_cnt, ev_pair, chain,
                         f_live, r_spans)

    def _tick(features, slabs, ev_idx, ev_cnt, ev_pair, chain, f_live,
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

        with compat.session(mesh):
            outs = compat.run(mesh, local, features, ev_idx, ev_cnt,
                              ev_pair, chain)
            return compat.concat_dp(outs, mesh)

    return tick


def sharded_gnn_tick(mesh: Mesh, nodes_per_shard: int, pe_shard: int, pi: int,
                     pk: int, ek: int, rel_offsets=None,
                     slices_sorted: bool = False, compute_dtype=None,
                     use_pallas: bool = False):
    """Graph-sharded learned tick: the mesh-resident counterpart of
    ``rca/gnn_streaming._gnn_tick``.

    Resident per-position state (``compat.Sharded`` over ``graph``): the
    feature node blocks (the base scorer's, already updated by its tick),
    ``kind``/``nmask`` node blocks, and the edge mirror's D per-shard
    relation-bucketed regions (``[Pe_shard]`` each, GLOBAL src ids and
    LOCAL dst rows: every edge lives on its destination's owner, so the
    segment sum is shard-local).

    Returns ``tick(params, features, kind, nmask, esrc, edst, erel, emask,
    ints, f_live, e_live) -> (logits, probs)``: ``ints`` is the per-shard
    packed delta uploaded once per device (``{device: [D, L] int32}``),
    row g laid out as ``gnn_streaming.copy_mirror_delta`` reads it (local
    rows and slots, global sources) followed by ``[inc_nodes pi (global)
    | inc_mask pi]``; ``f_live``/``e_live`` are each shard's live
    prefixes. Every position applies its shard's delta (dp rows keep
    their replicas in step); dp row 0 runs the forward. Outputs are on the
    mesh's first device, probs zeroed on dead incident rows.

    ``rel_offsets`` is the shared per-shard slice table ``kernels/gms``
    runs on. ``slices_sorted`` and ``use_pallas``
    (``settings.gnn_fused_tick``) are the JAX signature's: the port's pass
    takes any slice order, and on a CUDA tensor the shard-local pass is
    always the ``gms`` kernel."""
    from ..kernels import gms
    from ..rca import gnn
    from ..rca.gnn_streaming import copy_mirror_delta
    from .sharded_gnn import _field, _on, _ring_readout

    del slices_sorted, use_pallas
    if rel_offsets is None:
        raise ValueError("the sharded learned tick runs the relation-"
                         "bucketed pass: pass rel_offsets")
    nps = int(nodes_per_shard)
    offs = tuple(int(o) for o in rel_offsets)
    g_size = mesh.shape["graph"]
    # dp row 0 runs the forward; its positions keep the mesh's pool
    # indices, so they run on the same streams as the mesh's
    row = Mesh(mesh.grid[:1].copy(), ("dp", "graph"),
               pool_index=mesh.pool_index.reshape(mesh.grid.shape)[:1],
               ranks=(None if mesh.ranks is None else
                      mesh.ranks.reshape(mesh.grid.shape)[:1]))
    o_i = 3 * pk + 5 * ek

    def tick(params, features, kind, nmask, esrc, edst, erel, emask, ints,
             f_live, e_live):
        with compat.session(mesh):
            return _tick(params, features, kind, nmask, esrc, edst, erel,
                         emask, ints, f_live, e_live)

    def _tick(params, features, kind, nmask, esrc, edst, erel, emask, ints,
              f_live, e_live):
        compat.run(mesh, lambda pos, *mirror: copy_mirror_delta(
            ints[pos.device][pos.graph], pk, ek, f_live[pos.graph],
            e_live[pos.graph], *mirror), kind, nmask, esrc, edst, erel, emask)

        def setup(p, feats, kd, nm, es, ed, em):
            g = p.graph
            # each ring step's block mask and local rows: the slots'
            # sources are fixed through the tick, so every layer reuses them
            steps = [_in_block(es, ((g - r) % g_size) * nps, nps)
                     for r in range(g_size)]
            plan = (gms.make_plan(ed, em, offs, nps)
                    if ed.device.type == "cuda" else None)
            iota = torch.arange(pe_shard, dtype=torch.int32, device=p.device)
            prm = _on(params, p.device)
            return ((gnn.inv_degree(ed, em, nps), steps, plan, iota, prm),
                    gnn.embed(prm, feats, kd, nm),
                    ints[p.device][g][o_i:o_i + pi])

        st = compat.run(row, setup, features, kind, nmask, esrc, edst, emask)
        state, h, inc_nodes = (_field(st, k) for k in range(3))
        for li in range(len(params["layers"])):
            rows = _assemble_ring(row, h, state)
            h = compat.run(row, lambda p, hh, sp, tbl, ed, em:
                           gnn._message_pass_bucketed(
                               hh, sp[4]["layers"][li], sp[3], ed, em, offs,
                               sp[0], compute_dtype, sp[2], table=tbl),
                           h, state, rows, edst, emask)
        emb = _ring_readout(row, h, inc_nodes, nps)

        def head(p, e, sp):
            inc_mask = ints[p.device][0][o_i + pi:o_i + 2 * pi]
            logits = e @ sp[4]["head_w"] + sp[4]["head_b"]
            # mask dead incident rows so a stale row can never surface a
            # score
            probs = torch.softmax(logits, dim=-1) * inc_mask.to(
                torch.float32)[:, None]
            return logits, probs

        return compat.run(row, head, emb, state,
                          where=lambda p: p.graph == 0)[0, 0]

    return tick


def _assemble_ring(row: Mesh, h: np.ndarray, state: np.ndarray
                   ) -> np.ndarray:
    """Each position's ``[Pe_shard, H]`` source rows, assembled over one
    rotation of the embedding blocks: at step r a position holds block
    ``(g - r) mod D`` and adds the rows of its slots whose source lives
    there (padded slots, src 0 and mask 0, take block 0's row and the
    kernel's mask zeroes them)."""
    rows = np.empty(row.grid.shape, dtype=object)
    blocks = h
    for r in range(row.shape["graph"]):
        def step(p, blk, sp, acc, r=r):
            inside, local = sp[1][r]
            part = blk[local.long()] * inside[:, None]
            return part if acc is None else acc + part

        rows = compat.run(row, step, blocks, state, rows)
        blocks = compat.ring_shift(blocks, row)
    return rows


def shared_shard_offsets(counts_by_shard: np.ndarray, slack: float,
                         min_cap: int) -> tuple[int, ...]:
    """Shared per-shard relation-slice offsets: capacity per relation is
    the MAX live count over shards, bucketed — one offsets tuple describes
    EVERY shard's region (the ``partition.py`` contract)."""
    from ..graph.snapshot import rel_slice_offsets
    counts = np.asarray(counts_by_shard, np.int64)
    return rel_slice_offsets(counts.max(axis=0), slack=slack,
                             min_cap=min_cap)
