"""The relation-bucketed message pass, in plain PyTorch.

``gather_matmul_segment`` is the plain version of ``kernels/gms`` (the
hand-written CUDA kernel that the learned RCA path launches on the card).
The tests hold it against the JAX package's ``ops.segment`` and Pallas
kernel; ``chip_smoke.py`` holds the kernel against it on the card. On the
main path only CPU tensors reach it.
"""
from __future__ import annotations

import torch


def gather_matmul_segment(
    h: torch.Tensor,              # [N, H] node table
    w_rel: torch.Tensor,          # [R, H, K] per-relation transforms
    src: torch.Tensor,            # [E] source index, relation-bucketed layout
    dst: torch.Tensor,            # [E] destination/segment index
    mask: torch.Tensor,           # [E] 1.0 live / 0.0 padding
    rel_offsets: tuple[int, ...],  # [R+1] slice bounds into E
    num_segments: int,
    *,
    compute_dtype: "torch.dtype | str | None" = None,
) -> torch.Tensor:
    """Gather → per-relation matmul → dst-segment-sum over a
    relation-bucketed edge layout: relation ``r`` owns the contiguous
    slice ``[rel_offsets[r], rel_offsets[r+1])`` of the edge arrays. Each
    slice gathers its masked source rows, applies one ``[H, K]`` product
    with float32 accumulation, and adds each message row into ``out[dst]``
    in edge order, so every ``out[d]`` is the sum of its messages in
    ascending edge index, starting from zero.

    ``compute_dtype`` (e.g. ``"bfloat16"``) casts ``h``, ``w_rel`` and
    ``mask`` once, before the gathers; products and sums stay float32."""
    out_dtype = h.dtype
    if compute_dtype is not None:
        cdt = as_dtype(compute_dtype)
        h, w_rel, mask = h.to(cdt), w_rel.to(cdt), mask.to(cdt)
    agg = torch.zeros((num_segments, w_rel.shape[-1]), dtype=out_dtype,
                      device=h.device)
    for r in range(len(rel_offsets) - 1):
        lo, hi = int(rel_offsets[r]), int(rel_offsets[r + 1])
        if hi <= lo:
            continue   # relation with no edges: zero-width slice
        g = h[src[lo:hi].long()] * mask[lo:hi, None]
        msg = g.to(out_dtype) @ w_rel[r].to(out_dtype)
        agg.index_add_(0, dst[lo:hi].long(), msg)
    return agg


def as_dtype(name: "torch.dtype | str") -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (the JAX package's setting values) or
    a torch dtype → the torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown compute dtype {name!r}")
    return dtype
