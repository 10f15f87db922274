"""The GNN serving tick of the learned RCA path, in one chain of kernels.

Two entry points, each with the contract of a JAX package kernel in
``ops/pallas_segment.py``:

* :func:`fused_gnn_tick` — the fused tick (``_fused_kernel_factory``,
  ``pallas_fused_gnn_tick``): the packed delta scattered into the resident
  mirrors in place, the forward, the verdict;
* :func:`fused_gnn_tick_dma` — the streamed tick (``_dma_kernel_factory``,
  ``pallas_fused_gnn_tick_dma``): the same over the caller's persistent
  activation buffers, with the f32 / bf16 / int8 feature tables.

On CUDA tensors each launches ``fused_tick.cu`` on the current stream: the
scatter, then the layout's dst-CSR (:func:`kernels.gms.make_plan`, a stable
sort of the scattered ``edst``), then degree, embed, L message passes (the
tile kernel, then the segment walk, which applies the layer's update in
its epilogue), and the readout. Both entry points run the same kernels on
the same grid, so on the same state the streamed tick's float32 result
equals the fused tick's bit for bit. On CPU tensors each runs its plain version,
``ops/fused_tick``, which the tests hold against the JAX package and
``chip_smoke.py`` holds the kernels against on the card. There is no
fallback from one to the other.

The fused tick is differentiable, as the JAX package's ``_fused_vjp``
makes it: when grad mode is on and a param, ``features``,
``nmask`` or ``emask`` requires a gradient, the launch runs inside a
``torch.autograd.Function`` whose backward recomputes
:func:`composed_tick` (through ``kernels/gms``'s own backward)
and pulls the cotangents of ``nmask``, ``emask``, ``logits`` and ``probs``
into those inputs. The streamed tick has no backward, in JAX as here: it
raises when a gradient is wanted, rather than return a result autograd
cannot see through.

Bound (:func:`bound`): float32 operations at the learned path's widths.
"""
from __future__ import annotations

import ctypes

import torch

from ..graph.schema import EntityKind
from ..ops.fused_tick import (check_layout, check_quant, dma_node_block,
                              dma_tick_traffic_floor,
                              fused_gnn_tick_dma_plain, fused_gnn_tick_plain,
                              scatter_delta, split_ints)
from ..ops.segment import as_dtype
from ..rca import gnn
from . import _build, gms

launches = 0
"""Launches of :func:`fused_gnn_tick` so far (one per tick); a run resets
it to show that its path went through the kernel. Plain-version calls
never count."""
dma_launches = 0
"""Launches of :func:`fused_gnn_tick_dma` so far, counted the same way."""

_lib: ctypes.CDLL | None = None
_FEAT_TYPE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("fused_tick")
        p, i = ctypes.c_void_p, ctypes.c_int
        pp = ctypes.POINTER(ctypes.c_void_p)
        lib.fused_tick_scatter.argtypes = [
            p, i, i, i, i, p, p,            # ints, pk, ek, pn, pe, kind, nmask
            p, p, p, p, p, p, i, p]         # esrc, edst, erel, emask, fq_rows,
        #                                     feat_q, row_bytes, stream
        forward = [
            i, i, i, i, i, i, pp, pp, i,    # pn, dim, hid, classes, kinds, rels,
            #                                 params, layers, n_layers
            p, p, p, p, p, i, p, p, p, i,   # kind, nmask, esrc, emask, runs,
            #                                 n_runs, perm, rowptr, inc, pi
            p, p, p, p, p, p, p]            # inv_deg, msg, h_a, h_b, logits,
        #                                     probs, stream
        lib.fused_gnn_tick.argtypes = [i, p] + forward
        lib.fused_gnn_tick_dma.argtypes = [i, i, p, p] + forward
        for fn in (lib.fused_tick_scatter, lib.fused_gnn_tick,
                   lib.fused_gnn_tick_dma):
            fn.restype = ctypes.c_int
        lib.fused_tick_error_string.argtypes = [ctypes.c_int]
        lib.fused_tick_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _on_cpu(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
    return False


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, features on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: "torch.Tensor | None") -> "int | None":
    return None if t is None else t.data_ptr()


def _raise(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise _build.KernelError(f"fused_tick {what} launch failed: "
                           + lib.fused_tick_error_string(rc).decode())


def _launch(params, features, mirrors, ints, h_a, h_b, pk, ek, pi, offs,
            compute_dtype, fq_rows, feat_scale, dma: bool):
    """Check the operands, then launch the scatter, build the dst-CSR and
    launch the forward, all on the current stream. Returns (logits, probs)."""
    kind, nmask, esrc, edst, erel, emask = mirrors
    dev = features.device
    pn, dim = features.shape
    pe = offs[-1]
    hid = int(params["embed_b"].shape[0])
    classes = int(params["head_b"].shape[0])
    n_kinds = int(params["kind_emb"].shape[0])
    layers = params["layers"]
    n_rel = int(layers[0]["w_rel"].shape[0])
    f32, i32 = torch.float32, torch.int32
    if len(offs) != n_rel + 1:
        raise ValueError(f"rel_offsets has {len(offs)} entries for {n_rel} "
                         "relations")
    for name, t, dtype, n in (("kind", kind, i32, pn), ("nmask", nmask, f32, pn),
                              ("esrc", esrc, i32, pe), ("edst", edst, i32, pe),
                              ("erel", erel, i32, pe), ("emask", emask, f32, pe)):
        _check(name, t, dtype, (n,), dev)
    _check("ints", ints, i32, (3 * pk + 5 * ek + 2 * pi,), dev)
    shapes = {"embed_w": (dim, hid), "embed_b": (hid,),
              "kind_emb": (n_kinds, hid), "head_w": (hid, classes),
              "head_b": (classes,)}
    for name, shape in shapes.items():
        _check(name, params[name], f32, shape, dev)
    for li, layer in enumerate(layers):
        for name, shape in (("w_self", (hid, hid)), ("w_rel", (n_rel, hid, hid)),
                            ("b", (hid,))):
            _check(f"layers.{li}.{name}", layer[name], f32, shape, dev)
    for name, t in (("h_a", h_a), ("h_b", h_b)):
        _check(name, t, f32, (pn, hid), dev)
    cdt = torch.float32 if compute_dtype is None else as_dtype(compute_dtype)
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute dtype {cdt} not supported (float32, "
                        "bfloat16)")
    quant = fq_rows is not None
    if quant:
        _check("fq_rows", fq_rows, features.dtype, (pk, dim), dev)
    if features.dtype == torch.int8:
        _check("feat_scale", feat_scale, f32, (dim,), dev)

    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_tick_scatter(
            _ptr(ints), pk, ek, pn, pe, _ptr(kind), _ptr(nmask), _ptr(esrc),
            _ptr(edst), _ptr(erel), _ptr(emask), _ptr(fq_rows),
            _ptr(features) if quant else None,
            dim * features.element_size(), stream)
        _raise(lib, rc, "scatter")
        plan = gms.make_plan(edst, emask, offs, pn)
        inv_deg = torch.empty(pn, dtype=f32, device=dev)
        msg = torch.empty((pe, hid), dtype=f32, device=dev)
        logits = torch.empty((pi, classes), dtype=f32, device=dev)
        probs = torch.empty((pi, classes), dtype=f32, device=dev)
        param_ptrs = (ctypes.c_void_p * 5)(*(_ptr(params[k]) for k in (
            "embed_w", "embed_b", "kind_emb", "head_w", "head_b")))
        layer_ptrs = (ctypes.c_void_p * (3 * len(layers)))(*(
            _ptr(layer[k]) for layer in layers for k in ("w_self", "w_rel", "b")))
        forward = (pn, dim, hid, classes, n_kinds, n_rel, param_ptrs,
                   layer_ptrs, len(layers), _ptr(kind), _ptr(nmask), _ptr(esrc),
                   _ptr(emask), _ptr(plan.runs), plan.n_runs,
                   _ptr(plan.perm), _ptr(plan.rowptr),
                   ints.data_ptr() + 4 * (3 * pk + 5 * ek),
                   pi, _ptr(inv_deg), _ptr(msg), _ptr(h_a), _ptr(h_b),
                   _ptr(logits), _ptr(probs), stream)
        bf16 = int(cdt == torch.bfloat16)
        if dma:
            rc = lib.fused_gnn_tick_dma(bf16, _FEAT_TYPE[features.dtype],
                                        _ptr(features), _ptr(feat_scale),
                                        *forward)
        else:
            rc = lib.fused_gnn_tick(bf16, _ptr(features), *forward)
        _raise(lib, rc, "forward")
    return logits, probs


def _fused_forward(params, features, mirrors, ints, pk, ek, pi, offs,
                   compute_dtype) -> tuple:
    """(logits, probs) of one fused tick, the mirrors scattered in place:
    the plain version on the CPU, the kernels on the card."""
    if features.device.type == "cpu":
        return fused_gnn_tick_plain(
            params, features, *mirrors, ints, pk=pk, ek=ek, pi=pi,
            rel_offsets=offs, compute_dtype=compute_dtype)[6:]
    hid = int(params["embed_b"].shape[0])
    h = [torch.empty((features.shape[0], hid), dtype=torch.float32,
                     device=features.device) for _ in range(2)]
    return _launch(params, features, mirrors, ints, *h, pk, ek, pi, offs,
                   compute_dtype, None, None, dma=False)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def composed_tick(params, features, kind, nmask, esrc, edst, erel, emask,
                  ints, *, pk: int, ek: int, pi: int, rel_offsets,
                  compute_dtype=None) -> tuple:
    """The fused tick as a composition of differentiable ops, the path its
    backward recomputes: the packed delta scattered into COPIES of the six
    mirrors (the inputs are not touched), ``gnn.forward`` over them (on the
    card through ``kernels/gms``'s autograd Function) and the masked
    softmax. Returns ``(nmask', emask', logits, probs)``, differentiable in
    ``params``, ``features``, ``nmask`` and ``emask``; ``compute_dtype``
    has ``gnn.forward``'s meaning (the message pass and self transform)."""
    d = split_ints(ints, pk, ek, pi)
    mirrors = [t.clone() for t in (kind, nmask, esrc, edst, erel, emask)]
    scatter_delta(d, *mirrors)
    kind2, nm2, esrc2, edst2, erel2, em2 = mirrors
    logits = gnn.forward(params, features, kind2, nm2, esrc2, edst2, erel2,
                         em2, d["inc_nodes"], rel_offsets=rel_offsets,
                         compute_dtype=compute_dtype)
    probs = torch.softmax(logits, dim=-1) * d["inc_mask"].float()[:, None]
    return nm2, em2, logits, probs



class _FusedTickFunction(torch.autograd.Function):
    """The fused tick on the card with its backward (module docstring).

    The kernel scatters the delta into the caller's mirrors IN PLACE, so
    the pre-tick mirrors that the JAX package keeps as residuals are gone.
    The backward recomputes from the POST-tick mirrors with the same
    ``ints``, and that is exact: the scatter is a set (last entry wins,
    out-of-range entries drop), so applying it again to its own result
    changes nothing, and the positions it overwrote get no gradient from
    the pre-tick ``nmask``/``emask`` either way (their values were
    replaced)."""

    @staticmethod
    def forward(ctx, meta, features, kind, nmask, esrc, edst, erel, emask,
                ints, *leaves):
        keys, pk, ek, pi, offs, compute_dtype = meta
        mirrors = (kind, nmask, esrc, edst, erel, emask)
        logits, probs = _fused_forward(
            gnn.unflat_params(dict(zip(keys, leaves))), features, mirrors,
            ints, pk, ek, pi, offs, compute_dtype)
        ctx.mark_dirty(*mirrors)
        ctx.mark_non_differentiable(kind, esrc, edst, erel)
        ctx.save_for_backward(features, *mirrors, ints, *leaves)
        ctx.meta = meta
        return (*mirrors, logits, probs)

    @staticmethod
    def backward(ctx, _g_kind, g_nmask, _g_esrc, _g_edst, _g_erel, g_emask,
                 g_logits, g_probs):
        features, kind, nmask, esrc, edst, erel, emask, ints, *leaves = \
            ctx.saved_tensors
        keys, pk, ek, pi, offs, compute_dtype = ctx.meta
        with torch.enable_grad():
            p_in = [t.detach().requires_grad_(True) for t in leaves]
            f_in = features.detach().requires_grad_(True)
            nm_in = nmask.detach().clone().requires_grad_(True)
            em_in = emask.detach().clone().requires_grad_(True)
            outs = composed_tick(
                gnn.unflat_params(dict(zip(keys, p_in))), f_in, kind, nm_in,
                esrc, edst, erel, em_in, ints, pk=pk, ek=ek, pi=pi,
                rel_offsets=offs, compute_dtype=compute_dtype)
            pairs = [(o, g) for o, g in zip(outs, (g_nmask, g_emask,
                                                     g_logits, g_probs))
                     if g is not None]
            inputs = [f_in, nm_in, em_in, *p_in]
            grads = (torch.autograd.grad([o for o, _ in pairs], inputs,
                                         [g for _, g in pairs],
                                         allow_unused=True)
                     if pairs else [None] * len(inputs))
        d_f, d_nm, d_em, *d_p = grads
        need = ctx.needs_input_grad
        return (None, d_f if need[1] else None, None,
                d_nm if need[3] else None, None, None, None,
                d_em if need[7] else None, None,
                *(g if n else None for g, n in zip(d_p, need[9:])))


def fused_gnn_tick(params, features, kind, nmask, esrc, edst, erel, emask,
                   ints, *, pk: int, ek: int, pi: int, rel_offsets,
                   compute_dtype=None) -> tuple:
    """The fused serving tick → ``(kind, nmask, esrc, edst, erel, emask,
    logits, probs)``; the six mirrors are the tensors passed in, updated in
    place by the packed delta ``ints`` (the layout of
    ``rca/gnn_streaming._gnn_tick``; out-of-range entries drop, a repeated
    index takes its last entry). ``features`` float32 ``[Pn, DIM]``; the
    layout non-empty and EDGE_TILE-aligned; ``compute_dtype`` None or
    "bfloat16" (operands of every product rounded, float32 sums).

    CPU tensors run the plain version; CUDA tensors launch the kernels on
    the current stream (or raise). When a gradient is wanted (module
    docstring) the same forward runs inside the autograd Function, whose
    backward recomputes ``composed_tick``; the mirrors are still updated
    in place and returned."""
    global launches
    offs = check_layout(rel_offsets, "fused_gnn_tick")
    on_cpu = _on_cpu(features, "fused_gnn_tick")
    if not on_cpu:
        _check("features", features, torch.float32, tuple(features.shape),
               features.device)
    flat = gnn.flat_params(params)
    mirrors = (kind, nmask, esrc, edst, erel, emask)
    if _wants_grad(features, nmask, emask, *flat.values()):
        out = _FusedTickFunction.apply(
            (tuple(flat), pk, ek, pi, offs, compute_dtype), features,
            *mirrors, ints, *flat.values())
    else:
        out = (*mirrors, *_fused_forward(params, features, mirrors, ints, pk,
                                         ek, pi, offs, compute_dtype))
    launches += int(not on_cpu)
    return out


def fused_gnn_tick_dma(params, features, kind, nmask, esrc, edst, erel,
                       emask, ints, h_a, h_b, *, pk: int, ek: int, pi: int,
                       rel_offsets, node_block: int = 2048,
                       compute_dtype=None, feat_quant: str = "",
                       fq_rows=None, feat_scale=None) -> tuple:
    """The streamed serving tick → the fused tick's 8-tuple + ``(h_a,
    h_b)`` (+ the quant table under a quant tier). ``h_a``/``h_b`` are the
    caller's two ``[Pn, H]`` float32 activation buffers, rewritten in place
    (the embed writes ``h_a``, layer ``l`` writes buffer ``(l+1) % 2``).
    ``node_block`` is the JAX schedule's window (the rows it streams
    through VMEM at a time), validated as there: clamped to Pn, which it
    must divide. It does not change the card's grid, which is the fused
    tick's, nor any bit of the result. With ``feat_quant`` ("bfloat16" or
    "int8"), ``features`` is the quantized table: the scatter writes the
    aux delta's ``fq_rows`` into it in place and the embed dequantizes it
    (int8 times ``feat_scale`` per column).

    CPU tensors run the plain version; CUDA tensors launch the kernels on
    the current stream (or raise)."""
    global dma_launches
    if _wants_grad(features, nmask, emask, h_a, h_b,
                   *gnn.flat_params(params).values()):
        raise RuntimeError(
            "fused_gnn_tick_dma has no backward (the streamed tick serves "
            "only, as in the JAX package): run it under torch.no_grad(), "
            "or train through fused_gnn_tick or rca/gnn.forward")
    offs = check_layout(rel_offsets, "fused_gnn_tick_dma")
    check_quant(feat_quant, fq_rows, feat_scale)
    nb = dma_node_block(features.shape[0], node_block)
    if _on_cpu(features, "fused_gnn_tick_dma"):
        return fused_gnn_tick_dma_plain(
            params, features, kind, nmask, esrc, edst, erel, emask, ints,
            h_a, h_b, pk=pk, ek=ek, pi=pi, rel_offsets=offs, node_block=nb,
            compute_dtype=compute_dtype, feat_quant=feat_quant,
            fq_rows=fq_rows, feat_scale=feat_scale)
    want = {"": torch.float32, "bfloat16": torch.bfloat16,
            "int8": torch.int8}[feat_quant]
    _check("features", features, want, tuple(features.shape), features.device)
    mirrors = (kind, nmask, esrc, edst, erel, emask)
    logits, probs = _launch(params, features, mirrors, ints, h_a, h_b, pk,
                            ek, pi, offs, compute_dtype,
                            fq_rows if feat_quant else None,
                            feat_scale if feat_quant == "int8" else None,
                            dma=True)
    dma_launches += 1
    out = (*mirrors, logits, probs, h_a, h_b)
    return out + (features,) if feat_quant else out


def bound(*, pn: int, pe: int, live: int, dim: int, hidden: int,
          classes: int, num_layers: int, num_rels: int, pk: int, ek: int,
          pi: int, num_kinds: int = len(EntityKind), feat_quant: str = "",
          dma: bool = False) -> dict:
    """What one tick must move and do at least, for this run's data:

    * ``bytes``: each input read once (the feature table, kind and nmask,
      the edge mirror's src, dst and mask, the packed delta, the weights;
      under a quant tier its rows and the int8 scale) and each output
      written once (the delta's mirror entries, logits and probs; the
      streamed tick's two activation buffers and quant rows);
    * ``floor_bytes``: the streamed schedule's own floor
      (:func:`ops.fused_tick.dma_tick_traffic_floor`), which also counts
      the activations' trips through device memory;
    * ``ops``: ``2 (Pn DIM H + L (live H H + Pn H H) + Pi H C)`` float32
      operations (a multiply and an add per weight each product applies;
      ``live`` edges carry messages)."""
    qb = {"": 0, "bfloat16": 2, "int8": 1}[feat_quant]
    fb = qb or 4
    weights = 4 * (dim * hidden + hidden + num_kinds * hidden
                   + hidden * classes + classes
                   + num_layers * (hidden * hidden
                                   + num_rels * hidden * hidden + hidden))
    reads = (pn * dim * fb + 8 * pn + 12 * pe
             + 4 * (3 * pk + 5 * ek + 2 * pi) + weights + pk * dim * qb
             + (4 * dim if feat_quant == "int8" else 0))
    writes = (8 * pk + 16 * ek + 2 * 4 * pi * classes + pk * dim * qb
              + (2 * 4 * pn * hidden if dma else 0))
    ops = 2 * (pn * dim * hidden
               + num_layers * (live * hidden * hidden + pn * hidden * hidden)
               + pi * hidden * classes)
    floor = dma_tick_traffic_floor(pn=pn, pe=pe, dim=dim, hidden=hidden,
                                   num_layers=num_layers, pk=pk, ek=ek, pi=pi,
                                   feat_bytes=fb, quant_delta_bytes=qb)
    return {"bytes": reads + writes, "floor_bytes": floor, "ops": ops}
