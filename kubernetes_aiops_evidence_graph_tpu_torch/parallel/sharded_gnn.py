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
  each leaf's gradient is the sum of every position's contribution.

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


def _ring_messages(mesh: Mesh, h, w_rel, esrc, erel, emask, edst, nps: int,
                   rel_offsets=None) -> np.ndarray:
    """The ring halo exchange for one layer. Step ``r`` holds, at graph
    position ``g``, shard ``(g - r) mod D``'s block; the edges whose global
    source falls in that block consume it (mask ``emask * in_block``),
    then every block moves one hop. ``h`` and the edge operands are
    ``(dp, graph)`` grids of position tensors; returns the grid of
    ``[nps, H]`` aggregates, each the sum of its D steps in step order."""
    g_size = mesh.shape["graph"]
    pos = compat.positions(mesh)
    agg = np.empty(mesh.grid.shape, dtype=object)
    blocks = h
    for r in range(g_size):
        for p in pos:
            i, g = p.dp, p.graph
            lo = ((g - r) % g_size) * nps
            inside, local = _in_block(esrc[i, g], lo, nps)
            m = emask[i, g] * inside
            w = w_rel[i, g]
            if rel_offsets is not None:
                part = gms.gather_matmul_segment(
                    blocks[i, g], w, local.to(torch.int32), edst[i, g], m,
                    rel_offsets, nps)
            else:
                part = _reference_agg(blocks[i, g], w, local, erel[i, g], m,
                                      edst[i, g], nps)
            agg[i, g] = part if r == 0 else agg[i, g] + part
        blocks = compat.ring_shift(blocks, mesh)
    return agg


def _ring_readout(mesh: Mesh, h, inc_nodes, nps: int) -> np.ndarray:
    """Stream the incident-node embeddings out of the ring (no
    all-gather): D steps, each taking the rows of the block in flight;
    complete at every position after the rotation."""
    g_size = mesh.shape["graph"]
    pos = compat.positions(mesh)
    emb = np.empty(mesh.grid.shape, dtype=object)
    blocks = h
    for r in range(g_size):
        for p in pos:
            i, g = p.dp, p.graph
            lo = ((g - r) % g_size) * nps
            inside, local = _in_block(inc_nodes[i, g], lo, nps)
            part = blocks[i, g][local.long()] * inside[:, None]
            emb[i, g] = part if r == 0 else emb[i, g] + part
        blocks = compat.ring_shift(blocks, mesh)
    return emb


def _sharded_loss(mesh: Mesh, halo: str = "allgather", rel_offsets=None):
    """``loss(params, *arrays) -> scalar`` over the mesh, ``arrays`` the
    :func:`device_put_partitioned` operands. ``rel_offsets`` (the
    PartitionedGraph's shared slice table) selects the relation-bucketed
    pass for both halo strategies. Every graph position computes the same
    readout; the loss reads graph position 0 of each dp row."""
    if halo not in ("allgather", "ring"):
        raise ValueError(f"halo must be allgather|ring, got {halo!r}")
    if rel_offsets is not None:
        rel_offsets = tuple(int(o) for o in rel_offsets)
    pos = compat.positions(mesh)
    shape = mesh.grid.shape

    def loss(params, *arrays):
        # each position's blocks, the leading shard axis of size 1 stripped
        blk = [np.empty(shape, dtype=object) for _ in arrays]
        prm = np.empty(shape, dtype=object)
        for p in pos:
            for k, a in enumerate(arrays):
                blk[k][p.dp, p.graph] = a.block(p)[0]
            prm[p.dp, p.graph] = _on(params, p.device)
        (feats, kind, nmask, esrc, edst, erel, emask, inc_nodes, inc_mask,
         labels) = blk
        nps = int(feats[0, 0].shape[0])
        h = np.empty(shape, dtype=object)
        inv_deg = np.empty(shape, dtype=object)
        for p in pos:
            i, g = p.dp, p.graph
            inv_deg[i, g] = gnn.inv_degree(edst[i, g], emask[i, g], nps)
            h[i, g] = gnn.embed(prm[i, g], feats[i, g], kind[i, g],
                                nmask[i, g])
        for li in range(len(params["layers"])):
            w_rel = np.empty(shape, dtype=object)
            for p in pos:
                w_rel[p.dp, p.graph] = prm[p.dp, p.graph]["layers"][li]["w_rel"]
            if halo == "ring":
                agg = _ring_messages(mesh, h, w_rel, esrc, erel, emask, edst,
                                     nps, rel_offsets)
            else:
                full = compat.all_gather(h, mesh)
                agg = np.empty(shape, dtype=object)
                for p in pos:
                    i, g = p.dp, p.graph
                    if rel_offsets is not None:
                        agg[i, g] = gms.gather_matmul_segment(
                            full[i, g], w_rel[i, g], esrc[i, g], edst[i, g],
                            emask[i, g], rel_offsets, nps)
                    else:
                        agg[i, g] = _reference_agg(
                            full[i, g], w_rel[i, g], esrc[i, g], erel[i, g],
                            emask[i, g], edst[i, g], nps)
            for p in pos:
                i, g = p.dp, p.graph
                h[i, g] = gnn.layer_update(
                    h[i, g], prm[i, g]["layers"][li],
                    agg[i, g] * inv_deg[i, g][:, None])
        if halo == "ring":
            emb = _ring_readout(mesh, h, inc_nodes, nps)
        else:
            full = compat.all_gather(h, mesh)
            emb = np.empty(shape, dtype=object)
            for p in pos:
                emb[p.dp, p.graph] = full[p.dp, p.graph][
                    inc_nodes[p.dp, p.graph].long()]
        # incidents are dp-sharded; the graph positions of a row all hold
        # the same readout: each dp row's graph position 0 contributes,
        # summed over dp in position order on the first position's device
        first = mesh.grid[0, 0]
        loss_sum = count = None
        for i in range(shape[0]):
            pr = prm[i, 0]
            logits = emb[i, 0] @ pr["head_w"] + pr["head_b"]
            logp = torch.log_softmax(logits, dim=-1)
            nll = -logp.gather(1, labels[i, 0].long()[:, None])[:, 0]
            s = (nll * inc_mask[i, 0]).sum().to(first)
            c = inc_mask[i, 0].sum().to(first)
            loss_sum = s if loss_sum is None else loss_sum + s
            count = c if count is None else count + c
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
