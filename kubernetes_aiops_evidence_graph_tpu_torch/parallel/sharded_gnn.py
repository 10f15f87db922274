"""The GNN train step over a (dp × graph) mesh, driven position by position.

The distributed design of the JAX package's ``parallel/sharded_gnn.py``:

* node embeddings are computed shard-locally on the ``graph`` axis; each
  layer then performs a **halo exchange** so every shard can read the
  source side of its incoming edges. Two interchangeable strategies:

  - ``halo="allgather"``: one all-gather of the full [N, H] embedding
    matrix per layer (``compat.all_gather``).
  - ``halo="ring"``: D steps stream the shards' [N/D, H] blocks around the
    ring (``compat.ring_shift``); each step accumulates the messages of the
    edges whose source lives in the block in flight, and never more than
    one remote block is held (O(N/D) memory against O(N)).

* each graph shard sums messages only into its own node range (edges were
  partitioned by destination, ``partition.py``);
* incidents are read out on the ``dp`` axis (ring mode streams the readout
  too); the loss is a masked mean summed over ``dp`` in position order;
* autograd differentiates through the per-position work and the ``.to()``
  copies between positions; the parameters are one replicated tree, so
  each leaf's gradient is the sum of every position's contribution;
* every position's work runs on its own stream (``compat.run``), and
  each backward op on its forward op's stream.

Both halo strategies take both relation mappings (``rca/gnn.py``): pass
``rel_offsets`` (the PartitionedGraph's shared per-shard slice table) to
run the relation-bucketed pass, ``kernels/gms`` (on the card its backward
is ``gms`` on the transposed layout for ``dh`` and ``kernels/grad_w`` for
``dw``); omit it for the transform-then-gather reference, whose
``index_add_`` runs on CPU tensors only (on the card it raises, as
``gnn.forward``'s reference mapping does). The bucketed mapping
accumulates per relation slice, whose per-shard edge order differs from
the single-device layout, so its loss matches the single-device step to
float tolerance rather than bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import gms
from ..rca import gnn
from . import compat
from .mesh import Mesh, dp_sharded, graph_sharded


def _on(params, device: torch.device):
    """The replicated params at a position (``.to()``: a copy, with its
    gradient flowing back, on another device; the tensors themselves on
    their own)."""
    return gnn.unflat_params({k: v.to(device) for k, v in
                              gnn.flat_params(params).items()})


def _reference_agg(h_table, w_rel, src, erel, mask, dst, num_rows):
    """The reference mapping's aggregate (``gnn.rel_messages`` + one
    segment sum), CPU tensors only."""
    if h_table.device.type != "cpu":
        raise ValueError("the reference mapping runs on the CPU only; pass "
                         "rel_offsets (relation-bucketed layout)")
    msg = gnn.rel_messages(h_table, w_rel, src, erel, mask)
    return torch.zeros((num_rows, msg.shape[1]), dtype=msg.dtype,
                       device=msg.device).index_add_(0, dst.long(), msg)


def _in_block(idx, lo: int, nps: int):
    """(0/1 float mask of the indices inside ``[lo, lo + nps)``, the
    indices made block-local and clipped into range)."""
    inside = ((idx >= lo) & (idx < lo + nps)).to(torch.float32)
    return inside, torch.clamp(idx - lo, 0, nps - 1)


def _field(grid: np.ndarray, k: int) -> np.ndarray:
    """The ``k``-th entry of each tuple of a :func:`compat.run` grid."""
    out = np.empty(grid.shape, dtype=object)
    for idx, v in np.ndenumerate(grid):
        if v is not None:
            out[idx] = v[k]
    return out


def _ring_messages(mesh: Mesh, h, w_rel, esrc, erel, emask, edst, nps: int,
                   rel_offsets=None) -> np.ndarray:
    """The ring halo exchange for one layer. Step ``r`` holds, at graph
    position ``g``, shard ``(g - r) mod D``'s block; the edges whose global
    source falls in that block consume it (mask ``emask * in_block``),
    then every block moves one hop. ``h`` and the edge operands are
    ``(dp, graph)`` grids of position tensors; returns the grid of
    ``[nps, H]`` aggregates, each the sum of its D steps in step order,
    every position's on its own stream."""
    g_size = mesh.shape["graph"]
    agg = np.empty(mesh.grid.shape, dtype=object)
    blocks = h
    for r in range(g_size):
        def step(p, blk, w, es, er, em, ed, acc, r=r):
            inside, local = _in_block(es, ((p.graph - r) % g_size) * nps, nps)
            m = em * inside
            if rel_offsets is not None:
                part = gms.gather_matmul_segment(
                    blk, w, local.to(torch.int32), ed, m, rel_offsets, nps)
            else:
                part = _reference_agg(blk, w, local, er, m, ed, nps)
            return part if acc is None else acc + part

        agg = compat.run(mesh, step, blocks, w_rel, esrc, erel, emask, edst,
                         agg)
        blocks = compat.ring_shift(blocks, mesh)
    return agg


def _ring_readout(mesh: Mesh, h, inc_nodes, nps: int) -> np.ndarray:
    """Stream the incident-node embeddings out of the ring (no
    all-gather): D steps, each taking the rows of the block in flight;
    complete at every position after the rotation."""
    g_size = mesh.shape["graph"]
    emb = np.empty(mesh.grid.shape, dtype=object)
    blocks = h
    for r in range(g_size):
        def step(p, blk, inc, acc, r=r):
            inside, local = _in_block(inc, ((p.graph - r) % g_size) * nps,
                                      nps)
            part = blk[local.long()] * inside[:, None]
            return part if acc is None else acc + part

        emb = compat.run(mesh, step, blocks, inc_nodes, emb)
        blocks = compat.ring_shift(blocks, mesh)
    return emb


def _sharded_loss(mesh: Mesh, halo: str = "allgather", rel_offsets=None):
    """``loss(params, *arrays) -> scalar`` over the mesh, ``arrays`` the
    :func:`device_put_partitioned` operands. ``rel_offsets`` (the
    PartitionedGraph's shared slice table) selects the relation-bucketed
    pass for both halo strategies. Every graph position computes the same
    readout; the loss reads graph position 0 of each dp row. Each
    position's work runs on its own stream (``compat.run``)."""
    if halo not in ("allgather", "ring"):
        raise ValueError(f"halo must be allgather|ring, got {halo!r}")
    if rel_offsets is not None:
        rel_offsets = tuple(int(o) for o in rel_offsets)

    def loss(params, *arrays):
        with compat.session(mesh):
            return _loss(params, *arrays)

    def _loss(params, *arrays):
        def setup(p, *blocks):
            # each position's blocks, the leading shard axis of size 1
            # stripped; its replica of the params; its degrees and embedding
            blk = [b[0] for b in blocks]
            prm = _on(params, p.device)
            feats, kind, nmask, _es, edst, _er, emask = blk[:7]
            nps = int(feats.shape[0])
            return (*blk, prm, gnn.inv_degree(edst, emask, nps),
                    gnn.embed(prm, feats, kind, nmask))

        st = compat.run(mesh, setup, *arrays)
        (feats, kind, nmask, esrc, edst, erel, emask, inc_nodes, inc_mask,
         labels, prm, inv_deg, h) = (_field(st, k) for k in range(13))
        nps = int(feats[0, 0].shape[0])
        for li in range(len(params["layers"])):
            w_rel = compat.run(
                mesh, lambda p, pr: pr["layers"][li]["w_rel"], prm)
            if halo == "ring":
                agg = _ring_messages(mesh, h, w_rel, esrc, erel, emask, edst,
                                     nps, rel_offsets)
            else:
                full = compat.all_gather(h, mesh)

                def gather(p, f, w, es, er, em, ed):
                    if rel_offsets is not None:
                        return gms.gather_matmul_segment(
                            f, w, es, ed, em, rel_offsets, nps)
                    return _reference_agg(f, w, es, er, em, ed, nps)

                agg = compat.run(mesh, gather, full, w_rel, esrc, erel,
                                 emask, edst)
            h = compat.run(mesh, lambda p, hh, pr, a, inv: gnn.layer_update(
                hh, pr["layers"][li], a * inv[:, None]), h, prm, agg,
                inv_deg)
        if halo == "ring":
            emb = _ring_readout(mesh, h, inc_nodes, nps)
        else:
            full = compat.all_gather(h, mesh)
            emb = compat.run(mesh, lambda p, f, inc: f[inc.long()], full,
                             inc_nodes)

        # incidents are dp-sharded; the graph positions of a row all hold
        # the same readout: each dp row's graph position 0 contributes its
        # (masked nll sum, count), summed over dp in position order on the
        # first position's device
        def term(p, e, pr, lab, im):
            logits = e @ pr["head_w"] + pr["head_b"]
            logp = torch.log_softmax(logits, dim=-1)
            nll = -logp.gather(1, lab.long()[:, None])[:, 0]
            return torch.stack([(nll * im).sum(), im.sum()])[None]

        terms = compat.run(mesh, term, emb, prm, labels, inc_mask,
                           where=lambda p: p.graph == 0)
        rows = compat.whole(compat.Sharded(dp_sharded(mesh), terms))
        loss_sum, count = rows[0, 0], rows[0, 1]
        for i in range(1, rows.shape[0]):
            loss_sum = loss_sum + rows[i, 0]
            count = count + rows[i, 1]
        return loss_sum / torch.clamp(count, min=1.0)

    return loss


def make_sharded_train_step(mesh: Mesh, optimizer_factory,
                            halo: str = "allgather", rel_offsets=None):
    """The sharded counterpart of ``gnn.make_train_step``: ``step(params,
    opt_state, *arrays) -> (params, opt_state, loss)`` with ``arrays``
    the :func:`device_put_partitioned` operands. ``optimizer_factory``
    maps a list of leaves to a ``torch.optim`` optimizer (``gnn.adam``);
    ``opt_state`` is that optimizer, ``None`` on the first step (the step
    then makes it over ``gnn.trainable`` leaves of ``params``, on the
    mesh's first device). Pass ``rel_offsets=part.rel_offsets`` to train
    on the relation-bucketed pass. The returned loss is detached."""
    sharded_loss = _sharded_loss(mesh, halo=halo, rel_offsets=rel_offsets)

    def step(params, opt_state, *arrays):
        if opt_state is None:
            params = gnn.trainable(params)
            opt_state = optimizer_factory(gnn.leaves(params))
        opt_state.zero_grad(set_to_none=True)
        loss = sharded_loss(params, *arrays)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return step


def device_put_partitioned(part, mesh: Mesh) -> tuple:
    """Place the PartitionedGraph arrays on the mesh: the node and edge
    arrays split over ``graph``, the incident arrays over ``dp`` (each
    block keeps its leading shard axis of size 1)."""
    g, d = graph_sharded(mesh), dp_sharded(mesh)
    put = compat.place
    return (
        put(part.features, g), put(part.node_kind, g), put(part.node_mask, g),
        put(part.edge_src, g), put(part.edge_dst_local, g),
        put(part.edge_rel, g), put(part.edge_mask, g),
        put(part.incident_nodes, d), put(part.incident_mask, d),
        put(part.labels, d),
    )
