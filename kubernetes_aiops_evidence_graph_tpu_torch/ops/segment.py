"""The relation-bucketed message pass, in plain PyTorch.

``gather_matmul_segment`` is the plain version of ``kernels/gms`` (the
hand-written CUDA kernel that the learned RCA path launches on the card).
The tests hold it against the JAX package's ``ops.segment`` and Pallas
kernel; ``chip_smoke.py`` holds the kernel against it on the card. On the
main path only CPU tensors reach it.

Its backward, in plain PyTorch too: ``gms_grad_w`` (the per-relation
weight gradient, the plain version of ``kernels/grad_w``) and
``gather_matmul_segment_vjp`` (both gradients, ``dh`` as the forward on the
transposed layout). On the CPU torch's autograd differentiates the plain
forward; these are what the card's backward is held against.
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


def gms_grad_w(
    h: torch.Tensor,              # [N, H] node table of the forward
    g: torch.Tensor,              # [S, K] float32 cotangent of its output
    src: torch.Tensor,            # [E] int32
    dst: torch.Tensor,            # [E] int32
    mask: torch.Tensor,           # [E] 1.0 live / 0.0 padding
    rel_offsets: tuple[int, ...],  # [R+1] slice bounds into E
    num_rels: int,
    *,
    compute_dtype: "torch.dtype | str | None" = None,
) -> torch.Tensor:
    """The message pass's weight gradient, ``[num_rels, H, K]`` float32:
    ``dw[r] = sum over e in slice r of (h[src[e]] * mask[e])^T g[dst[e]]``.
    ``num_rels`` is the full depth of ``w_rel``: relations past the
    layout's slices, and slices with no live edge, get exact zeros. Under
    ``compute_dtype`` the gathered rows ``h * mask`` are formed in that
    dtype, as the forward formed them; ``g`` and the sums stay float32."""
    offs = tuple(int(o) for o in rel_offsets)
    if len(offs) - 1 > num_rels:
        raise ValueError(f"layout has {len(offs) - 1} relation slices, "
                         f"w_rel {num_rels}")
    if compute_dtype is not None:
        cdt = as_dtype(compute_dtype)
        h, mask = h.to(cdt), mask.to(cdt)
    dw = torch.zeros((num_rels, h.shape[1], g.shape[1]), dtype=torch.float32,
                     device=h.device)
    for r in range(len(offs) - 1):
        lo, hi = offs[r], offs[r + 1]
        live = torch.nonzero(mask[lo:hi] != 0).flatten() + lo
        if live.numel() == 0:
            continue   # zero-width or all-padding slice: exact zeros
        a = (h[src[live].long()] * mask[live, None]).float()
        dw[r] = a.T @ g[dst[live].long()].float()
    return dw


def gather_matmul_segment_vjp(
    h: torch.Tensor, w_rel: torch.Tensor, src: torch.Tensor,
    dst: torch.Tensor, mask: torch.Tensor, rel_offsets: tuple[int, ...],
    num_segments: int, g: torch.Tensor, *,
    compute_dtype: "torch.dtype | str | None" = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dh, dw)`` of :func:`gather_matmul_segment` for the output
    cotangent ``g`` ``[num_segments, K]``: ``dh`` is the forward on the
    transposed layout (``g`` gathered at ``dst``, added at ``src``,
    ``w_rel`` transposed), ``dw`` is :func:`gms_grad_w`. ``mask`` and the
    index arrays are layout constants and get no gradient."""
    dh = gather_matmul_segment(g, w_rel.transpose(-1, -2), dst, src, mask,
                               rel_offsets, h.shape[0],
                               compute_dtype=compute_dtype)
    dw = gms_grad_w(h, g, src, dst, mask, rel_offsets, w_rel.shape[0],
                    compute_dtype=compute_dtype)
    return dh, dw


def as_dtype(name: "torch.dtype | str") -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (the JAX package's setting values) or
    a torch dtype → the torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown compute dtype {name!r}")
    return dtype
