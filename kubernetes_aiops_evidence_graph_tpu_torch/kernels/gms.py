"""The relation-bucketed message pass of the learned RCA path.

``gather_matmul_segment`` computes, for a relation-bucketed edge layout
(relation ``r`` owns the slice ``[rel_offsets[r], rel_offsets[r+1])``),
``out[dst[e]] += (h[src[e]] * mask[e]) @ w_rel[r]`` with every ``out[d]``
summed in ascending edge index from zero: what the JAX package's
``ops/pallas_segment.py::_gms_kernel`` (and its XLA twin
``ops/segment.py::gather_matmul_segment``) computes.

On a CUDA tensor it launches ``gms.cu`` (a tile kernel that writes each
live edge's message row, walking runs of one relation's tiles
(:func:`tile_runs`) with ``w_rel[r]`` held in shared memory, then an
ordered per-destination walk over a dst-CSR; no floating-point atomics,
so the result is the same bit for bit on every run). On a CPU tensor it
runs the plain version,
``ops/segment.gather_matmul_segment``, which the tests hold against the
JAX package and ``chip_smoke.py`` holds the kernel against on the card.
There is no fallback from one to the other.

The dst-CSR and the tile runs (:func:`make_plan`) depend only on the
layout, so a forward builds them once and passes them to each of its L
layers.

On the card the pass is differentiable in ``h`` and ``w_rel`` (a
``torch.autograd.Function``, entered only when a gradient is wanted): the
forward is the kernel launch above; the backward computes ``dh`` with the
SAME kernel on the transposed layout (the cotangent gathered at ``dst``,
added at ``src``, ``w_rel`` transposed) over the layout's src-CSR, which
the plan builds at its first backward and keeps for the other layers, and
``dw`` with ``kernels/grad_w``. ``mask`` and the index arrays are layout
constants and get no gradient, as in the JAX package's ``custom_vjp``.
Under ``torch.no_grad()`` nothing is saved and no src-CSR is built.

Bound on an H100 at the learned path's widths (H = K = 64, float32):
operations, ``2 * live * H * K`` over the float32 rate; the bytes it must
move (:func:`bound`) take about a third of that time.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.segment import as_dtype
from ..ops.segment import gather_matmul_segment as gather_matmul_segment_reference
from . import grad_w

launches = 0
"""Kernel launches so far (one per message pass); a run resets it to show
that its path went through the kernel. Plain-version calls never count."""

RUNS_TARGET = 2112
"""Tile runs a layout is cut into, about: sixteen for each of an H100's
132 SMs, which hold six blocks each at H = 64: about three waves, so the
last wave's tail is short. Runs only share out the work: each message row
is computed whole by one block, so the cut never changes a bit."""
RUN_TILES_MAX = 16
"""Most 64-edge tiles in one run (``gms_device.cuh`` kRunTiles)."""
MAX_HIDDEN = 768
"""Largest H (the depth of ``w_rel``) the kernel takes: a block holds a
``[H, 64]`` column block of ``w_rel[r]`` in shared memory
(``gms_device.cuh`` kMaxHid)."""

_EDGE_TILE = 64
_lib: ctypes.CDLL | None = None
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_runs_cache: dict = {}


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from . import _build
        lib = _build.load("gms")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gms_launch.argtypes = [
            i, p, i, i, p, i,               # dtype, h, n_h, H, w_rel, K
            p, p, p, i,                     # src, mask, runs, n_runs
            p, p, i, p, p, p]               # perm, rowptr, N, msg, out, stream
        lib.gms_launch.restype = ctypes.c_int
        lib.gms_error_string.argtypes = [ctypes.c_int]
        lib.gms_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


@dataclass(frozen=True)
class GmsPlan:
    """The dst-CSR of one edge layout: ``perm[rowptr[d]:rowptr[d+1]]``
    are the live edges (mask != 0, inside a relation slice) with
    destination ``d``, in ascending edge index; and the layout's tile
    runs (:func:`tile_runs`) on the device."""
    rel_offsets: tuple[int, ...]
    num_segments: int
    runs: torch.Tensor        # [n_runs * 3] int32
    perm: torch.Tensor        # [live] int32 edge indices
    rowptr: torch.Tensor      # [N+1] int32
    _transposed: list = field(default_factory=list, compare=False,
                              repr=False)

    def transposed(self, src: torch.Tensor, mask: torch.Tensor,
                   num_rows: int) -> "GmsPlan":
        """The src-CSR of the same layout (the plan of the backward's
        ``dh`` pass, whose destinations are the sources), built at the
        first call and kept: a forward's L layers share it. A later call
        with other ``src``/``mask`` tensors, or a changed one, or another
        ``num_rows`` raises rather than return the kept CSR."""
        key = tuple((t.data_ptr(), tuple(t.shape), t._version)
                    for t in (src, mask)) + (int(num_rows),)
        if not self._transposed:
            self._transposed.append((key, make_plan(
                src, mask, self.rel_offsets, num_rows)))
        kept, plan = self._transposed[0]
        if kept != key:
            raise ValueError("the plan's src-CSR was built for other src / "
                             "mask tensors or another row count")
        return plan

    @property
    def n_runs(self) -> int:
        return self.runs.numel() // 3


def tile_runs(rel_offsets: tuple[int, ...]) -> np.ndarray:
    """The tile kernel's work: ``[n, 3]`` int32 rows ``(relation, first
    edge, end edge)``, each a run of whole 64-edge tiles of one relation's
    slice cut from the slice's start (the last run of a slice may end on
    a partial tile), in edge order. Every run but a slice's last has the
    same tile count: ``ceil(tiles / RUNS_TARGET)`` capped at
    :data:`RUN_TILES_MAX`. Zero-width slices have no run."""
    offs = [int(o) for o in rel_offsets]
    tiles = sum(-(-(hi - lo) // _EDGE_TILE) for lo, hi in zip(offs, offs[1:]))
    per_run = _EDGE_TILE * min(RUN_TILES_MAX, max(1, -(-tiles // RUNS_TARGET)))
    runs = [(r, start, min(hi, start + per_run))
            for r, (lo, hi) in enumerate(zip(offs, offs[1:]))
            for start in range(lo, hi, per_run)]
    return np.asarray(runs, np.int32).reshape(-1, 3)


def _device_runs(offs: tuple[int, ...], dev: torch.device) -> torch.Tensor:
    """:func:`tile_runs` of ``offs`` on ``dev``, uploaded once per layout."""
    key = (offs, str(dev))
    hit = _runs_cache.get(key)
    if hit is None:
        hit = torch.from_numpy(tile_runs(offs).reshape(-1)).to(dev)
        if len(_runs_cache) >= 64:
            _runs_cache.clear()
        _runs_cache[key] = hit
    return hit


def _check_offsets(offs: tuple[int, ...], num_edges: int) -> None:
    if len(offs) < 1 or offs[0] < 0 or offs[-1] > num_edges or any(
            b < a for a, b in zip(offs[:-1], offs[1:])):
        raise ValueError(f"rel_offsets {offs} must be non-decreasing within "
                         f"[0, {num_edges}]")


def make_plan(dst: torch.Tensor, mask: torch.Tensor,
              rel_offsets: tuple[int, ...], num_segments: int) -> GmsPlan:
    """The dst-CSR of a layout, built on the tensors' device by a STABLE
    sort of dst over the live edges (edges of one destination keep their
    ascending index). Edges outside every slice, with mask 0 or with a
    destination outside ``[0, num_segments)`` are left out."""
    offs = tuple(int(o) for o in rel_offsets)
    _check_offsets(offs, int(dst.shape[0]))
    dev = dst.device
    lo, hi = offs[0], offs[-1]
    if hi > lo:
        d = dst[lo:hi].long()
        valid = (mask[lo:hi] != 0) & (d >= 0) & (d < num_segments)
        key = torch.where(valid, d, torch.full_like(d, num_segments))
        skey, perm = torch.sort(key, stable=True)
        rowptr = torch.searchsorted(
            skey, torch.arange(num_segments + 1, device=dev))
        perm = (perm + lo).to(torch.int32)
        rowptr = rowptr.to(torch.int32)
    else:
        perm = torch.zeros(0, dtype=torch.int32, device=dev)
        rowptr = torch.zeros(num_segments + 1, dtype=torch.int32, device=dev)
    return GmsPlan(offs, int(num_segments), _device_runs(offs, dev),
                   perm.contiguous(), rowptr.contiguous())


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, h on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")


def _launch(table: torch.Tensor, w: torch.Tensor, gather: torch.Tensor,
            mask: torch.Tensor, offs: tuple[int, ...], num_segments: int,
            cdt: torch.dtype, plan: GmsPlan) -> torch.Tensor:
    """One launch of the pass on the current stream: rows ``gather`` of
    ``table`` (masked, times ``w[r]`` per slice) summed into
    ``[num_segments, K]`` over ``plan``'s CSR."""
    global launches
    dev = table.device
    n_h, hid = table.shape
    k_out = w.shape[-1]
    if hid > MAX_HIDDEN:
        raise ValueError(f"gms takes H up to {MAX_HIDDEN}, got {hid}")
    h_c = table.to(cdt).contiguous()
    w_c = w.to(cdt).contiguous()
    m_c = mask.to(cdt).contiguous()
    gather = gather.contiguous()
    n_edges = offs[-1]
    msg = torch.empty((n_edges, k_out), dtype=torch.float32, device=dev)
    out = torch.empty((num_segments, k_out), dtype=torch.float32, device=dev)
    if num_segments == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gms_launch(
            _DTYPE_CODE[cdt], h_c.data_ptr(), n_h, hid, w_c.data_ptr(),
            k_out, gather.data_ptr(), m_c.data_ptr(), plan.runs.data_ptr(),
            plan.n_runs, plan.perm.data_ptr(), plan.rowptr.data_ptr(),
            num_segments, msg.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("gms launch failed: "
                           + lib.gms_error_string(rc).decode())
    launches += 1
    return out


class _GmsFunction(torch.autograd.Function):
    """The pass on the card with its backward (see the module docstring):
    gradients for ``h`` and ``w_rel`` only."""

    @staticmethod
    def forward(ctx, h, w_rel, src, dst, mask, offs, num_segments, cdt,
                plan):
        ctx.save_for_backward(h, w_rel, src, dst, mask)
        ctx.layout = (offs, num_segments, cdt, plan)
        return _launch(h, w_rel, src, mask, offs, num_segments, cdt, plan)

    @staticmethod
    def backward(ctx, g):
        h, w_rel, src, dst, mask = ctx.saved_tensors
        offs, _, cdt, plan = ctx.layout
        g = g.float().contiguous()
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = _launch(g, w_rel.transpose(1, 2), dst, mask, offs,
                         h.shape[0], cdt,
                         plan.transposed(src, mask, h.shape[0]))
        if ctx.needs_input_grad[1]:
            dw = grad_w.gms_grad_w(h, g, src, dst, mask, offs,
                                   w_rel.shape[0], compute_dtype=cdt)
        return dh, dw, None, None, None, None, None, None, None


def gather_matmul_segment(
    h: torch.Tensor,              # [N, H] float32 node table
    w_rel: torch.Tensor,          # [R, H, K] float32 per-relation transforms
    src: torch.Tensor,            # [E] int32
    dst: torch.Tensor,            # [E] int32
    mask: torch.Tensor,           # [E] float32, 1.0 live / 0.0 padding
    rel_offsets: tuple[int, ...],  # [R+1] slice bounds into E
    num_segments: int,
    *,
    compute_dtype: "torch.dtype | str | None" = None,
    plan: GmsPlan | None = None,
) -> torch.Tensor:
    """One message pass → ``[num_segments, K]`` float32.

    ``compute_dtype`` ("bfloat16") casts ``h``, ``w_rel`` and ``mask``
    once before the gathers; products and sums stay float32. ``plan`` is
    the layout's dst-CSR (:func:`make_plan`), built here when not given.

    CPU tensors run the plain version (which torch's autograd
    differentiates); CUDA tensors launch the kernel on the current stream
    (or raise), through the autograd Function when ``h`` or ``w_rel``
    requires a gradient and grad mode is on. On both, ``mask`` is a layout
    constant: no gradient flows to it through the pass."""
    dev = h.device
    if dev.type == "cpu":
        return gather_matmul_segment_reference(
            h, w_rel, src, dst, mask.detach(), rel_offsets, num_segments,
            compute_dtype=compute_dtype)
    if dev.type != "cuda":
        raise ValueError(f"gather_matmul_segment runs on cuda or cpu, not {dev}")
    n_h, hid = h.shape
    n_rel, _, k_out = w_rel.shape
    e = int(src.shape[0])
    offs = tuple(int(o) for o in rel_offsets)
    _check("h", h, torch.float32, (n_h, hid), dev)
    _check("w_rel", w_rel, torch.float32, (n_rel, hid, k_out), dev)
    _check("src", src, torch.int32, (e,), dev)
    _check("dst", dst, torch.int32, (e,), dev)
    _check("mask", mask, torch.float32, (e,), dev)
    if len(offs) != n_rel + 1:
        raise ValueError(f"rel_offsets has {len(offs)} entries for {n_rel} "
                         "relations")
    _check_offsets(offs, e)
    cdt = torch.float32 if compute_dtype is None else as_dtype(compute_dtype)
    if cdt not in _DTYPE_CODE:
        raise TypeError(f"compute dtype {cdt} not supported (float32, "
                        "bfloat16)")
    if plan is None:
        plan = make_plan(dst, mask, offs, num_segments)
    elif plan.rel_offsets != offs or plan.num_segments != num_segments:
        raise ValueError("plan was built for another layout")
    if torch.is_grad_enabled() and (h.requires_grad or w_rel.requires_grad):
        return _GmsFunction.apply(h, w_rel, src, dst, mask, offs,
                                  num_segments, cdt, plan)
    return _launch(h, w_rel, src, mask, offs, num_segments, cdt, plan)


def bound(src: np.ndarray, mask: np.ndarray, rel_offsets: tuple[int, ...],
          hid: int, k_out: int, num_segments: int,
          operand_bytes: int = 4) -> tuple[int, int]:
    """(bytes, operations) one message pass must move and do at least, for
    this layout's data: each distinct source row the live edges gather
    once, 12 B per live edge (src, dst, mask), ``w_rel``, and the
    ``[N, K]`` float32 output written once; ``2 * live * H * K`` operations
    (a multiply and an add per weight a live edge applies)."""
    offs = tuple(int(o) for o in rel_offsets)
    lo, hi = offs[0], offs[-1]
    live = np.asarray(mask[lo:hi]) != 0
    rows = np.unique(np.asarray(src[lo:hi])[live]).size
    n_live = int(live.sum())
    n_rel = len(offs) - 1
    nbytes = (rows * hid * operand_bytes + n_live * 12
              + n_rel * hid * k_out * operand_bytes + num_segments * k_out * 4)
    return nbytes, 2 * n_live * hid * k_out
