"""The fused GNN serving tick, in plain PyTorch.

``fused_gnn_tick_plain`` and ``fused_gnn_tick_dma_plain`` are the plain
versions of ``kernels/fused_tick`` (the hand-written CUDA chain the
resident GNN scorer launches on the card), with the semantics of the JAX
package's ``ops/pallas_segment.py`` fused tick (``_fused_kernel_factory``)
and streamed tick (``_dma_kernel_factory``):

* the packed aux and edge deltas are scattered into the resident mirrors
  IN PLACE (the tensors passed in are the ones returned). An entry whose
  index lies outside ``[0, Pn)`` (aux) or ``[0, Pe)`` (edges) is dropped,
  wherever it sits in the delta; when an index repeats, the last entry
  wins, in entry order;
* degree is the sum of ``emask`` over ``edst``;
* embed ``relu(feat @ embed_w + embed_b + kind_emb[kind]) * nmask``, then
  per layer ``relu(h @ w_self + agg * inv_deg + b) + h`` with ``agg`` the
  relation-bucketed message pass (``ops/segment``), every destination's
  messages summed in ascending edge index;
* logits ``h[inc] @ head_w + head_b``, probs the softmax times the
  incident mask.

``compute_dtype="bfloat16"`` rounds the operands of every product (embed,
messages, self transform, head) to bfloat16; products and sums stay
float32, as in the Pallas kernels' ``mm``. The tests hold these functions
against the JAX package; ``chip_smoke.py`` holds the kernels against them.

Also here: the port's copy of ``quantize_features`` (the streamed tick's
bf16/int8 feature tables) and of ``dma_tick_traffic_floor``.
"""
from __future__ import annotations

import torch

from ..ladders import EDGE_TILE
from .segment import as_dtype, gather_matmul_segment

FEAT_QUANTS = ("", "bfloat16", "int8")


def tiles_align(rel_offsets) -> bool:
    """Whether every relation slice capacity is a multiple of EDGE_TILE
    (true for any layout drawn from the REL_SLICE_BUCKETS ladder)."""
    offs = [int(o) for o in rel_offsets]
    return all((hi - lo) % EDGE_TILE == 0 for lo, hi in zip(offs[:-1], offs[1:]))


def check_layout(rel_offsets, name: str) -> tuple[int, ...]:
    """The offsets as ints; raises unless the layout is non-empty and
    EDGE_TILE-aligned (the scorer keeps the composed tick otherwise)."""
    offs = tuple(int(o) for o in rel_offsets or ())
    if len(offs) < 2 or offs[-1] <= 0 or not tiles_align(offs):
        raise ValueError(f"{name} needs a non-empty EDGE_TILE-aligned "
                         "relation-bucketed layout")
    return offs


def dma_node_block(pn: int, node_block: int) -> int:
    """The streamed tick's rows per block: ``node_block`` clamped to the
    node count, which it must divide."""
    nb = min(int(node_block), int(pn))
    if nb <= 0 or pn % nb != 0:
        raise ValueError(f"node count {pn} must be a multiple of the node "
                         f"block {nb} (both come off power-of-two ladders)")
    return nb


def check_quant(feat_quant: str, fq_rows, feat_scale) -> None:
    if feat_quant not in FEAT_QUANTS:
        raise ValueError(f"unsupported feat_quant: {feat_quant!r}")
    if feat_quant and fq_rows is None:
        raise ValueError("feat_quant tiers need the per-tick fq_rows")
    if feat_quant == "int8" and feat_scale is None:
        raise ValueError("int8 feat_quant needs the per-column scale")


def split_ints(ints: torch.Tensor, pk: int, ek: int, pi: int) -> dict:
    """Views of the packed delta:

      [ f_idx pk | kind_v pk | nmask_v pk |
        e_idx ek | e_src ek | e_dst ek | e_rel ek | e_mask ek |
        incident_nodes pi | incident_mask pi ]"""
    if int(ints.shape[0]) != 3 * pk + 5 * ek + 2 * pi:
        raise ValueError(f"ints has {int(ints.shape[0])} entries, the layout "
                         f"(pk={pk}, ek={ek}, pi={pi}) "
                         f"{3 * pk + 5 * ek + 2 * pi}")
    names = ("f_idx", "kind_v", "nmask_v")
    out = {n: ints[j * pk:(j + 1) * pk] for j, n in enumerate(names)}
    o = 3 * pk
    for j, n in enumerate(("e_idx", "e_src", "e_dst", "e_rel", "e_mask")):
        out[n] = ints[o + j * ek:o + (j + 1) * ek]
    o += 5 * ek
    out["inc_nodes"] = ints[o:o + pi]
    out["inc_mask"] = ints[o + pi:o + 2 * pi]
    return out


def _landing(idx: torch.Tensor, bound: int) -> torch.Tensor:
    """Positions of the delta entries that land: index in ``[0, bound)``
    and no later entry with the same index (the last one wins)."""
    i = idx.long()
    pos = torch.nonzero((i >= 0) & (i < bound)).flatten()
    if pos.numel() == 0:
        return pos
    last = torch.full((bound,), -1, dtype=torch.long, device=idx.device)
    last.scatter_reduce_(0, i[pos], pos, reduce="amax")
    return pos[last[i[pos]] == pos]


def scatter_delta(d: dict, kind, nmask, esrc, edst, erel, emask,
                  features_q=None, fq_rows=None) -> None:
    """Apply the aux and edge deltas to the mirrors in place (drop out of
    range, last wins); under a quant tier the aux rows' ``fq_rows`` land
    in the quantized feature table at the same rows."""
    win = _landing(d["f_idx"], int(kind.shape[0]))
    rows = d["f_idx"][win].long()
    kind[rows] = d["kind_v"][win].to(kind.dtype)
    nmask[rows] = d["nmask_v"][win].to(nmask.dtype)
    if features_q is not None:
        features_q[rows] = fq_rows[win]
    win = _landing(d["e_idx"], int(esrc.shape[0]))
    slots = d["e_idx"][win].long()
    for mirror, key in ((esrc, "e_src"), (edst, "e_dst"), (erel, "e_rel"),
                        (emask, "e_mask")):
        mirror[slots] = d[key][win].to(mirror.dtype)


def _mm(a: torch.Tensor, b: torch.Tensor, cdt) -> torch.Tensor:
    """A product with operands rounded to ``cdt`` and float32 sums."""
    if cdt is not None:
        a, b = a.to(cdt).float(), b.to(cdt).float()
    return a @ b


def dequantize(features: torch.Tensor, feat_scale=None) -> torch.Tensor:
    """The float32 feature table of an f32, bf16 or int8 (per-column
    scale) table."""
    x = features.float()
    return x * feat_scale[None, :] if features.dtype == torch.int8 else x


def _tick_forward(params, x, kind, nmask, esrc, edst, emask, d, offs, cdt,
                  bufs):
    """Embed, the L rounds and the readout over the scattered mirrors.
    Activations ping-pong between ``bufs``: the embed writes ``bufs[0]``;
    layer ``li`` reads ``bufs[li % 2]`` and writes its aggregate, then its
    output, into the other. Returns (logits, probs)."""
    pn = x.shape[0]
    deg = torch.zeros(pn, dtype=torch.float32, device=x.device
                      ).index_add_(0, edst.long(), emask)
    inv_deg = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1.0),
                          torch.zeros_like(deg))
    n_kinds = params["kind_emb"].shape[0]
    bufs[0].copy_(torch.relu(
        _mm(x, params["embed_w"], cdt) + params["embed_b"]
        + params["kind_emb"][kind.long().clamp(0, n_kinds - 1)])
        * nmask[:, None])
    for li, layer in enumerate(params["layers"]):
        cur, nxt = bufs[li % 2], bufs[(li + 1) % 2]
        nxt.copy_(gather_matmul_segment(cur, layer["w_rel"], esrc, edst, emask,
                                        offs, pn, compute_dtype=cdt))
        nxt.copy_(torch.relu(_mm(cur, layer["w_self"], cdt)
                             + nxt * inv_deg[:, None] + layer["b"]) + cur)
    h = bufs[len(params["layers"]) % 2]
    inc = d["inc_nodes"].long().clamp(0, pn - 1)
    logits = _mm(h[inc], params["head_w"], cdt) + params["head_b"]
    probs = torch.softmax(logits, dim=-1) * d["inc_mask"].float()[:, None]
    return logits, probs


def fused_gnn_tick_plain(params, features, kind, nmask, esrc, edst, erel,
                         emask, ints, *, pk: int, ek: int, pi: int,
                         rel_offsets, compute_dtype=None) -> tuple:
    """The fused tick (``kernels/fused_tick.fused_gnn_tick``): the packed
    delta scattered into the mirrors in place, then the forward and the
    verdict. Returns ``(kind, nmask, esrc, edst, erel, emask, logits,
    probs)``, the first six the tensors passed in."""
    offs = check_layout(rel_offsets, "fused_gnn_tick")
    cdt = None if compute_dtype is None else as_dtype(compute_dtype)
    d = split_ints(ints, pk, ek, pi)
    scatter_delta(d, kind, nmask, esrc, edst, erel, emask)
    hid = params["embed_b"].shape[0]
    bufs = [torch.empty((features.shape[0], hid), dtype=torch.float32,
                        device=features.device) for _ in range(2)]
    logits, probs = _tick_forward(params, features, kind, nmask, esrc, edst,
                                  emask, d, offs, cdt, bufs)
    return kind, nmask, esrc, edst, erel, emask, logits, probs


def fused_gnn_tick_dma_plain(params, features, kind, nmask, esrc, edst, erel,
                             emask, ints, h_a, h_b, *, pk: int, ek: int,
                             pi: int, rel_offsets, node_block: int = 2048,
                             compute_dtype=None, feat_quant: str = "",
                             fq_rows=None, feat_scale=None) -> tuple:
    """The streamed tick (``kernels/fused_tick.fused_gnn_tick_dma``): the
    fused tick over the caller's activation buffers ``h_a``/``h_b``
    (rewritten in place, returned). With ``feat_quant`` ("bfloat16" or
    "int8"), ``features`` is the quantized table: the aux delta's
    ``fq_rows`` land in it in place and it is dequantized for the embed
    (int8 times ``feat_scale``). ``node_block`` is validated and, being a
    blocking of rows, changes nothing here. Returns the fused tick's
    8-tuple + ``(h_a, h_b)`` (+ the quant table under a quant tier)."""
    offs = check_layout(rel_offsets, "fused_gnn_tick_dma")
    check_quant(feat_quant, fq_rows, feat_scale)
    dma_node_block(features.shape[0], node_block)
    cdt = None if compute_dtype is None else as_dtype(compute_dtype)
    d = split_ints(ints, pk, ek, pi)
    quant = bool(feat_quant)
    scatter_delta(d, kind, nmask, esrc, edst, erel, emask,
                  features if quant else None, fq_rows)
    x = dequantize(features, feat_scale) if quant else features
    logits, probs = _tick_forward(params, x, kind, nmask, esrc, edst, emask,
                                  d, offs, cdt, [h_a, h_b])
    out = (kind, nmask, esrc, edst, erel, emask, logits, probs, h_a, h_b)
    return out + (features,) if quant else out


def quantize_features(features: torch.Tensor, dtype: str = "int8"):
    """The streamed tick's quantized feature table. ``int8``: per-column
    symmetric absmax scale, ``q = clip(round(x / scale), -127, 127)``,
    dequantized as ``q * scale``; an all-zero column gets scale 0 and
    dequantizes exactly to zero. ``bfloat16``: a plain downcast, scale
    None. Returns ``(table, scale)``."""
    if dtype == "bfloat16":
        return features.to(torch.bfloat16), None
    if dtype != "int8":
        raise ValueError(f"unsupported feature quant dtype: {dtype!r}")
    scale = (features.abs().amax(dim=0) / 127.0).float()
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(features / safe[None, :]), -127, 127)
    q = torch.where(scale[None, :] > 0, q, torch.zeros_like(q))
    return q.to(torch.int8), scale


def dma_tick_traffic_floor(*, pn: int, pe: int, dim: int, hidden: int,
                           num_layers: int, pk: int, ek: int, pi: int,
                           feat_bytes: int = 4,
                           quant_delta_bytes: int = 0) -> int:
    """The device-memory bytes one streamed tick moves when every block
    and row it stages is moved exactly once: the edge delta, one pass over
    the feature table and the h0 write, and per layer the accumulator
    zero, the (src, dst, mask) windows, the row gathers, the accumulate's
    read and write and the update's two reads and one write; then the
    readout rows."""
    f = 4
    nbytes = 4 * ek * f                       # edge delta: 3 x i32 + f32
    if quant_delta_bytes:
        nbytes += pk * dim * quant_delta_bytes    # fq row scatter
    nbytes += pn * dim * feat_bytes           # embed: feature read
    nbytes += pn * hidden * f                 # embed: h0 write
    per_layer = (pn * hidden * f              # zero the accumulator
                 + 3 * pe * f                 # (src, dst, mask) windows
                 + pe * hidden * f            # row gathers
                 + 2 * pe * hidden * f        # read + write accumulate
                 + 3 * pn * hidden * f)       # update: hv + agg in, h out
    nbytes += num_layers * per_layer
    nbytes += pi * hidden * f                 # readout row gathers
    return nbytes
