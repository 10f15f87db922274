"""K-hop propagation over the sparse evidence graph, in plain PyTorch.

The port's copy of the JAX package's ``ops/propagate.py``, the answer to
the reference's depth-3 Cypher traversals (apoc.path.subgraphAll
maxLevel=3, neo4j.py:169-201). Two primitives over padded COO edge lists
(src, dst, mask), on the tensors' device:

* :func:`k_hop_reach` — batched frontier expansion (boolean BFS) from seed
  rows, one gather and one scatter-max per hop;
* :func:`propagate_labels` — iterated normalized SpMM x ← Â·x, the batched
  anomaly label propagation.

In JAX both are XLA only (no Pallas kernel), so they stay torch ops here.
Neither uses floating-point atomics that depend on order: the max of
``scatter_reduce_`` does not depend on the order of its updates, and the
per-destination sums run over a stable dst-sorted order with
``torch.segment_reduce`` on two-dimensional values (on CUDA its kernel
for those adds each output's segment in order, one thread per output;
one-dimensional values would take a block-wide tree), so a call gives
the same bits every time, on the CPU and on the card. Every index must
lie in ``[0, num_nodes)``.
"""
from __future__ import annotations

import torch


def k_hop_reach(
    seed_rows: torch.Tensor,      # [B] node index per batch row
    seed_mask: torch.Tensor,      # [B] 1.0 real / 0.0 pad
    edge_src: torch.Tensor,       # [E]
    edge_dst: torch.Tensor,       # [E]
    edge_mask: torch.Tensor,      # [E]
    num_nodes: int,
    hops: int,
) -> torch.Tensor:
    """Reachability within ``hops`` edges: float32 ``[B, num_nodes]``."""
    dev = seed_rows.device
    nodes = torch.arange(num_nodes, device=dev)
    reach = ((seed_rows.long()[:, None] == nodes[None, :]).float()
             * seed_mask.float()[:, None])
    src = edge_src.long()
    dst = edge_dst.long()[None, :].expand(reach.shape[0], -1)
    emask = edge_mask.float()[None, :]
    for _ in range(hops):
        # expand: for every edge u->v, v becomes reachable if u is
        msg = reach[:, src] * emask                                # [B, E]
        expanded = torch.zeros_like(reach).scatter_reduce_(
            1, dst, msg, "amax", include_self=True)
        reach = torch.maximum(reach, expanded)
    return reach


def propagate_labels(
    x: torch.Tensor,              # [N] or [N, D] initial scores
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_mask: torch.Tensor,
    num_nodes: int,
    iterations: int = 3,
    alpha: float = 0.5,
) -> torch.Tensor:
    """x ← (1-α)x + α·D⁻¹Aᵀx for ``iterations`` rounds (label propagation).

    Each destination's messages are summed in edge order (a stable sort by
    ``edge_dst``, built once per call), as the JAX package's scatter-add
    sums them on the CPU."""
    order = torch.argsort(edge_dst.long(), stable=True)
    src = edge_src.long()[order]
    mask = edge_mask.float()[order]
    lengths = torch.bincount(edge_dst.long(), minlength=num_nodes)

    def segment_sum(values: torch.Tensor) -> torch.Tensor:
        flat = values.reshape(values.shape[0], -1)
        return torch.segment_reduce(flat, "sum", lengths=lengths, axis=0
                                    ).reshape((num_nodes,) + values.shape[1:])

    deg = segment_sum(mask)
    inv_deg = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1.0),
                          torch.zeros_like(deg))
    if x.dim() > 1:
        mask, inv_deg = mask[:, None], inv_deg[:, None]
    cur = x
    for _ in range(iterations):
        agg = segment_sum(cur[src] * mask) * inv_deg
        cur = (1.0 - alpha) * cur + alpha * agg
    return cur
