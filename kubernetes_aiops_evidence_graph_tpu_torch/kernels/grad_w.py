"""The weight gradient of the relation-bucketed message pass.

``gms_grad_w`` computes, for a relation-bucketed edge layout and the
cotangent ``g`` of the message pass's output,
``dw[r] = sum over e in slice r of (h[src[e]] * mask[e])^T g[dst[e]]``: what
the JAX package's ``ops/pallas_segment.py::_grad_w_kernel`` (launched by
``_gms_grad_w``, the ``w_rel`` half of the message pass's ``custom_vjp``)
computes on every training backward, once per layer.

On a CUDA tensor it launches ``grad_w.cu``: two kernels a weight gradient
(:data:`KERNEL_NAMES`). The first runs one block per (work item, 64-row
block of ``H``, column group of ``K``); a work item is a run of whole
64-edge tiles of one relation's slice (:func:`work_items`, passed to the
kernel as the layout's slices and item length), and :func:`col_groups`
splits each item's ``[H, K]`` output over 1, 2 or 4 blocks where the items
alone cannot fill the card. A block keeps a ring of stages in flight
(``cp.async`` gathers of each live edge's ``h`` row and each destination
run's ``g`` row) and each thread keeps its share of the item's partial in
registers: one ``fmaf`` chain per element over the item's live edges in
ascending order. The second kernel sums each relation's partials in item
order. No floating-point atomics, so the result is the same bit for bit on
every run and under every split. On a CPU tensor it runs the plain
version, ``ops/segment.gms_grad_w``, which the tests hold against the JAX
package and ``chip_smoke.py`` holds the kernel against on the card. There
is no fallback from one to the other.

Bound on an H100 at the learned path's widths (H = K = 64): operations,
``2 * live * H * K`` over the float32 rate (:func:`bound`). See the
``.cu`` source for the staging, why the sum is a second kernel, and what
is left for later (tensor cores, a producer warp, fusing with the ``dh``
pass, CUDA graphs for the step's dispatch).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops.segment import as_dtype
from ..ops.segment import gms_grad_w as gms_grad_w_reference
from . import _build

launches = 0
"""Kernel launches so far (one per weight gradient); a run resets it to show
that its path went through the kernel. Plain-version calls never count."""

KERNEL_NAMES = ("grad_w_items_kernel", "grad_w_sum_kernel")
"""The function names of the kernels one weight gradient launches, as a
profiler reports them (``chip_smoke.py`` splits device time by them)."""

ITEM_TILES_TARGET = 528
"""Work items a layout is cut into, about: four blocks for each of an
H100's 132 SMs. A constant, so the cut (and with it the order of every
sum) depends on the layout alone."""

_EDGE_TILE = 64
_BLOCK_ROWS = 64          # rows of H, and columns of K at one group, a block
_COL_GROUPS = (4, 2, 1)
_lib: ctypes.CDLL | None = None
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_items_cache: dict = {}


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("grad_w")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.grad_w_launch.argtypes = [
            i, p, i, i, p, i, i,            # dtype, h, n_h, H, g, n_g, K
            p, p, p,                        # src, dst, mask
            p, p, i, i, i,                  # offs, rel_items (host),
            #                                 n_slices, per_item, num_rels
            i,                              # col_groups
            p, p, p]                        # partial, dw, stream
        lib.grad_w_launch.restype = ctypes.c_int
        lib.grad_w_error_string.argtypes = [ctypes.c_int]
        lib.grad_w_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def work_items(rel_offsets: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    """The layout cut into work items: ``(items [n, 3], rel_items [S+1])``
    with ``items[i] = (relation, first edge, end edge)``, a run of whole
    64-edge tiles of one slice (the same tile count for every item, about
    :data:`ITEM_TILES_TARGET` items in all), and relation ``r``'s items
    ``rel_items[r]:rel_items[r+1]``, in edge order."""
    offs = [int(o) for o in rel_offsets]
    per_item = _item_edges(offs)
    items, rel_items = [], [0]
    for r, (lo, hi) in enumerate(zip(offs, offs[1:])):
        for start in range(lo, hi, per_item):
            items.append((r, start, min(hi, start + per_item)))
        rel_items.append(len(items))
    return (np.asarray(items, np.int32).reshape(-1, 3),
            np.asarray(rel_items, np.int32))


GRID_CAPACITY = {4: 4 * 132, 2: 5 * 132}
"""Blocks of the items kernel an H100 holds at once at 4 and at 2 column
groups: four, and five, on each of its 132 SMs (:func:`col_groups`)."""

MAX_SLICES = 32
"""Relation slices a layout may have: the kernel takes the layout's cut
into work items as an argument, not from device memory."""


def col_groups(n_items: int, hid: int, k_out: int) -> int:
    """Column groups each item's ``[H, K]`` output is split over: the
    largest of 4, 2, 1 whose grid the card holds at once
    (:data:`GRID_CAPACITY`), so that a layout with few items still spreads
    over the card. It depends on the layout and the widths alone; the
    split changes no output's operations, so not its bits."""
    base = n_items * -(-hid // _BLOCK_ROWS) * -(-k_out // _BLOCK_ROWS)
    return next(g for g in _COL_GROUPS
                if g == 1 or base * g <= GRID_CAPACITY[g])


def _item_edges(offs: list[int]) -> int:
    """Edges a work item of this layout runs over: whole 64-edge tiles,
    about :data:`ITEM_TILES_TARGET` items in all."""
    tiles = sum(-(-(hi - lo) // _EDGE_TILE) for lo, hi in zip(offs, offs[1:]))
    return _EDGE_TILE * max(1, -(-tiles // ITEM_TILES_TARGET))


def _launch_layout(offs: tuple[int, ...]):
    """``(offs, rel_items, n_items, per_item)`` as the kernel takes them:
    int32 host arrays, kept per layout."""
    hit = _items_cache.get(offs)
    if hit is None:
        items, rel_items = work_items(offs)
        hit = (np.asarray(offs, np.int32), rel_items, len(items),
               _item_edges(list(offs)))
        if len(_items_cache) >= 64:
            _items_cache.clear()
        _items_cache[offs] = hit
    return hit


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, h on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")


def gms_grad_w(
    h: torch.Tensor,              # [N, H] float32 or bfloat16 node table
    g: torch.Tensor,              # [S, K] float32 output cotangent
    src: torch.Tensor,            # [E] int32
    dst: torch.Tensor,            # [E] int32
    mask: torch.Tensor,           # [E] float32, 1.0 live / 0.0 padding
    rel_offsets: tuple[int, ...],  # [R+1] slice bounds into E
    num_rels: int,                # depth of w_rel (>= the layout's slices)
    *,
    compute_dtype: "torch.dtype | str | None" = None,
    _col_groups: "int | None" = None,
) -> torch.Tensor:
    """The message pass's weight gradient → ``[num_rels, H, K]`` float32.

    ``compute_dtype`` ("bfloat16") casts ``h`` and ``mask`` once, as the
    forward's operands were cast; ``g`` and the sums stay float32.
    ``_col_groups`` forces the split that :func:`col_groups` would choose
    (the tests show that every split gives the same bits).

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream (or raise)."""
    global launches
    dev = h.device
    if dev.type == "cpu":
        return gms_grad_w_reference(h, g, src, dst, mask, rel_offsets,
                                    num_rels, compute_dtype=compute_dtype)
    if dev.type != "cuda":
        raise ValueError(f"gms_grad_w runs on cuda or cpu, not {dev}")
    n_h, hid = h.shape
    n_g, k_out = g.shape
    e = int(src.shape[0])
    offs = tuple(int(o) for o in rel_offsets)
    cdt = h.dtype if compute_dtype is None else as_dtype(compute_dtype)
    if cdt not in _DTYPE_CODE:
        raise TypeError(f"compute dtype {cdt} not supported (float32, "
                        "bfloat16)")
    if h.dtype not in _DTYPE_CODE:
        raise TypeError(f"h must be float32 or bfloat16, got {h.dtype}")
    _check("g", g, torch.float32, (n_g, k_out), dev)
    _check("src", src, torch.int32, (e,), dev)
    _check("dst", dst, torch.int32, (e,), dev)
    _check("mask", mask, torch.float32, (e,), dev)
    if len(offs) < 1 or offs[0] < 0 or offs[-1] > e or any(
            b < a for a, b in zip(offs[:-1], offs[1:])):
        raise ValueError(f"rel_offsets {offs} must be non-decreasing within "
                         f"[0, {e}]")
    if len(offs) - 1 > num_rels:
        raise ValueError(f"layout has {len(offs) - 1} relation slices, "
                         f"w_rel {num_rels}")
    if len(offs) - 1 > MAX_SLICES:
        raise ValueError(f"layout has {len(offs) - 1} relation slices; the "
                         f"kernel takes at most {MAX_SLICES}")
    h_c = h.to(cdt).contiguous()
    # the mask as the forward's operand: rounded to the compute dtype
    m_c = mask.to(cdt).float().contiguous()
    g_c = g.contiguous()
    src, dst = src.contiguous(), dst.contiguous()
    offs_np, rel_items, n_items, per_item = _launch_layout(offs)
    groups = (col_groups(n_items, hid, k_out) if _col_groups is None
              else int(_col_groups))
    if groups not in _COL_GROUPS:
        raise ValueError(f"column groups {groups} not in {_COL_GROUPS}")
    partial = torch.empty((max(n_items, 1), hid, k_out), dtype=torch.float32,
                          device=dev)
    dw = torch.empty((num_rels, hid, k_out), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.grad_w_launch(
            _DTYPE_CODE[cdt], h_c.data_ptr(), n_h, hid, g_c.data_ptr(), n_g,
            k_out, src.data_ptr(), dst.data_ptr(), m_c.data_ptr(),
            offs_np.ctypes.data, rel_items.ctypes.data, len(offs) - 1,
            per_item, num_rels, groups, partial.data_ptr(), dw.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise _build.KernelError("grad_w launch failed: "
                           + lib.grad_w_error_string(rc).decode())
    launches += 1
    return dw


def bound(src: np.ndarray, dst: np.ndarray, mask: np.ndarray,
          rel_offsets: tuple[int, ...], hid: int, k_out: int, num_rels: int,
          operand_bytes: int = 4) -> tuple[int, int]:
    """(bytes, operations) one weight gradient must move and do at least,
    for this layout's data: each distinct ``h`` row and each distinct ``g``
    row the live edges gather, once; 12 B per live edge (src, dst, mask);
    ``dw`` written once; ``2 * live * H * K`` operations (a multiply and an
    add per output element each live edge updates)."""
    offs = tuple(int(o) for o in rel_offsets)
    lo, hi = offs[0], offs[-1]
    live = np.asarray(mask[lo:hi]) != 0
    h_rows = np.unique(np.asarray(src[lo:hi])[live]).size
    g_rows = np.unique(np.asarray(dst[lo:hi])[live]).size
    n_live = int(live.sum())
    nbytes = (h_rows * hid * operand_bytes + g_rows * k_out * 4
              + n_live * 12 + num_rels * hid * k_out * 4)
    return nbytes, 2 * n_live * hid * k_out
