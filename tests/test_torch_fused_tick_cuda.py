"""The fused GNN serving tick (``kernels/fused_tick.cu``: the fused tick
and the streamed tick) against its plain version on the card. This file
imports no JAX, so it also runs on a machine with a GPU and no JAX;
there, from the repository root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_fused_tick_cuda.py

(``tests/conftest.py`` imports JAX). Without a GPU the test skips. The
operands here are shared with test_torch_fused_tick.py, which holds the
plain version to the JAX package on the CPU."""
import numpy as np
import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu_torch.graph.schema import DIM
from kubernetes_aiops_evidence_graph_tpu_torch.kernels import fused_tick as fk
from kubernetes_aiops_evidence_graph_tpu_torch.ops.fused_tick import (
    fused_gnn_tick_dma_plain, fused_gnn_tick_plain, quantize_features)
from kubernetes_aiops_evidence_graph_tpu_torch.rca import gnn as tgnn

MIRRORS = ("kind", "nmask", "esrc", "edst", "erel", "emask")


def numpy_params(seed, hidden=16, layers=3, classes=tgnn.NUM_CLASSES,
                 kinds=tgnn.NUM_KINDS, rels=3, dim=DIM):
    """Random weights in the JAX package's nesting, as numpy."""
    rng = np.random.default_rng(seed + 1000)

    def normal(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {
        "embed_w": normal(dim, hidden, scale=1 / np.sqrt(dim)),
        "embed_b": normal(hidden, scale=0.1),
        "kind_emb": normal(kinds, hidden, scale=0.1),
        "head_w": normal(hidden, classes, scale=1 / np.sqrt(hidden)),
        "head_b": normal(classes, scale=0.1),
        "layers": [{"w_self": normal(hidden, hidden, scale=1 / np.sqrt(hidden)),
                    "w_rel": normal(rels, hidden, hidden,
                                    scale=1 / np.sqrt(hidden)),
                    "b": normal(hidden, scale=0.1)} for _ in range(layers)],
    }


def tick_operands(seed, pn=256, pi=8, pk=64, ek=64, caps=(64, 128, 64),
                  live=(40, 100, 30), hidden=16, layers=3, empty=False,
                  dim=DIM):
    """A relation-bucketed mirror and a packed delta: each slice a
    dst-sorted live prefix then padding (dst pinned to the last row, mask
    0); the delta holds live entries, a repeated index with other values
    (the last must win) and an out-of-range index between live entries
    (dropped), then out-of-range padding. ``empty``: padding only.
    Returns (numpy params, features, mirrors, ints, offsets, shapes)."""
    rng = np.random.default_rng(seed)
    offs = (0,) + tuple(int(c) for c in np.cumsum(caps))
    pe = offs[-1]
    params = numpy_params(seed, hidden, layers, rels=len(caps), dim=dim)
    features = rng.standard_normal((pn, dim)).astype(np.float32)
    kind = rng.integers(0, 5, pn).astype(np.int32)
    nmask = (rng.random(pn) > 0.1).astype(np.float32)
    esrc = rng.integers(0, pn, pe).astype(np.int32)
    edst = np.full(pe, pn - 1, np.int32)
    erel = np.full(pe, -1, np.int32)
    emask = np.zeros(pe, np.float32)
    for r, c in enumerate(live):
        lo = offs[r]
        edst[lo:lo + c] = np.sort(rng.integers(0, pn, c))
        erel[lo:lo + c] = r
        emask[lo:lo + c] = 1.0
    ints = np.zeros(3 * pk + 5 * ek + 2 * pi, np.int32)
    ints[:pk] = pn                        # aux padding (dropped)
    o = 3 * pk
    ints[o:o + ek] = pe                   # edge-slot padding (dropped)
    if not empty:
        na = 9
        ints[:na] = rng.choice(pn, na, replace=False)
        ints[5] = ints[1]                 # repeated row: entry 5 wins
        ints[3] = pn + 7                  # out of range mid-delta: dropped
        ints[pk:pk + na] = rng.integers(0, 5, na)
        ints[2 * pk:2 * pk + na] = rng.integers(0, 2, na)
        ints[2 * pk + 5] = 1 - ints[2 * pk + 1]
        ne = 8
        ints[o:o + ne] = rng.choice(pe, ne, replace=False)
        ints[o + 6] = ints[o + 2]         # repeated slot: entry 6 wins
        ints[o + 4] = pe + 3              # out of range mid-delta: dropped
        ints[o + ek:o + ek + ne] = rng.integers(0, pn, ne)
        ints[o + 2 * ek:o + 2 * ek + ne] = rng.integers(0, pn, ne)
        ints[o + 3 * ek:o + 3 * ek + ne] = rng.integers(0, len(caps), ne)
        ints[o + 4 * ek:o + 4 * ek + ne] = rng.integers(0, 2, ne)
        ints[o + 4 * ek + 6] = 1
    io = 3 * pk + 5 * ek
    ints[io:io + pi] = rng.integers(0, pn, pi)
    ints[io + pi:io + 2 * pi] = (rng.random(pi) > 0.25).astype(np.int32)
    mirrors = (kind, nmask, esrc, edst, erel, emask)
    return params, features, mirrors, ints, offs, dict(pk=pk, ek=ek, pi=pi)


# layouts that stress the segment walk's update epilogue: (hidden, feature
# width); each with a hub destination of 600 edges over two relations,
# most rows of in-degree 0, and Pn = 1000, not a multiple of the walk's
# 16 destinations a block. H 128 runs two column passes and H 72 a ragged
# second one of 8 columns; H 30 rows are not whole 16-byte pieces, so
# every stage takes plain loads.
HARD_TICKS = {"h40_dim24": (40, 24), "h128_dim48": (128, 48),
              "h72_dim16": (72, 16), "h30_dim10": (30, 10)}


def hard_tick_operands(name, seed=21, pn=1000, hub=3):
    """:func:`tick_operands` on a hard layout of ``HARD_TICKS``: relation
    slices of 640, 192 and 128 edges with 620, 150 and 90 live; 450 of
    relation 0's and all of relation 1's live edges go to ``hub`` (600 in
    all, each slice's live prefix dst-sorted), and the first incident
    reads the hub's row. The edge delta writes only relation 2's slots."""
    hidden, dim = HARD_TICKS[name]
    caps, live = (640, 192, 128), (620, 150, 90)
    ops = tick_operands(seed, pn=pn, caps=caps, live=live, hidden=hidden,
                        dim=dim)
    params, features, mirrors, ints, offs, kw = ops
    edst = mirrors[3]
    for r, n_hub in ((0, 450), (1, 150)):
        lo = offs[r]
        edst[lo:lo + n_hub] = hub
        edst[lo:lo + live[r]] = np.sort(edst[lo:lo + live[r]])
    # the edge delta's in-range slots move into relation 2, so that the
    # hub keeps its 600 edges after the scatter
    o, ek = 3 * kw["pk"], kw["ek"]
    slots = ints[o:o + ek]
    inside = slots < offs[-1]
    slots[inside] = offs[2] + slots[inside] % (offs[3] - offs[2])
    ints[3 * kw["pk"] + 5 * kw["ek"]] = hub
    return ops


def quant_rows(table: np.ndarray, ints: np.ndarray, pk: int) -> np.ndarray:
    """The per-tick quantized delta rows serving stages: each in-range aux
    entry's row of the (already quantized) table."""
    fq = np.zeros((pk, table.shape[1]), table.dtype)
    rows = ints[:pk]
    live = rows < table.shape[0]
    fq[live] = table[rows[live]]
    return fq


def torch_operands(ops, device, feat_quant=""):
    """The operands of both entry points as tensors on ``device``: (params,
    features or the quant table, mirrors, ints, fq_rows, scale)."""
    params, features, mirrors, ints, offs, kw = ops
    p = tgnn.params_from_numpy(params, device=device)
    x = torch.from_numpy(features)
    scale = fq = None
    if feat_quant:
        x, scale = quantize_features(x, feat_quant)
        table = x.float().numpy() if feat_quant == "bfloat16" else x.numpy()
        fq = torch.from_numpy(quant_rows(table, ints, kw["pk"])).to(
            device=device, dtype=x.dtype)
        scale = None if scale is None else scale.to(device)
    m = [torch.from_numpy(a.copy()).to(device) for a in mirrors]
    return p, x.to(device), m, torch.from_numpy(ints).to(device), fq, scale


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _held(got, want, names, tol):
    for name, a, b in zip(names, got, want):
        a = a.cpu()
        if name in MIRRORS or name == "table":
            assert torch.equal(a, b), name
        else:
            torch.testing.assert_close(a.float(), b.float(), rtol=tol,
                                       atol=tol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["fused", "fused_bf16", "dma", "dma_bf16",
                                  "dma_int8", "dma_empty"])
def test_cuda_kernel_equals_plain_version(cuda_device, tier):
    """On the card: every output within rtol/atol 1e-5 of the plain
    version on a CPU copy (mirrors and the quant table equal), argmax
    equal; bf16 operands within 0.05; two launches equal bit for bit, one
    count each; the streamed tick equal at node blocks 64 and 256."""
    ops = tick_operands(5, empty=tier == "dma_empty")
    offs, kw = ops[4], ops[5]
    quant = {"dma_bf16": "bfloat16", "dma_int8": "int8"}.get(tier, "")
    cdt = "bfloat16" if tier == "fused_bf16" else None
    tol = 0.05 if cdt else 1e-5
    pn, hid = ops[1].shape[0], ops[0]["embed_b"].shape[0]
    runs = []
    for nb in (64, 256, 64):
        p, x, m, ints, fq, scale = torch_operands(ops, cuda_device, quant)
        if tier.startswith("fused"):
            before = fk.launches
            out = fk.fused_gnn_tick(p, x, *m, ints, rel_offsets=offs,
                                    compute_dtype=cdt, **kw)
            assert fk.launches == before + 1
        else:
            h = [torch.zeros((pn, hid), device=cuda_device) for _ in range(2)]
            before = fk.dma_launches
            out = fk.fused_gnn_tick_dma(
                p, x, *m, ints, *h, rel_offsets=offs, node_block=nb,
                feat_quant=quant, fq_rows=fq, feat_scale=scale, **kw)
            assert fk.dma_launches == before + 1
        torch.cuda.synchronize()
        runs.append([t.cpu() for t in out])
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b), tier
    p, x, m, ints, fq, scale = torch_operands(ops, "cpu", quant)
    if tier.startswith("fused"):
        want = fused_gnn_tick_plain(p, x, *m, ints, rel_offsets=offs,
                                    compute_dtype=cdt, **kw)
    else:
        h = [torch.zeros((pn, hid)) for _ in range(2)]
        want = fused_gnn_tick_dma_plain(
            p, x, *m, ints, *h, rel_offsets=offs, feat_quant=quant,
            fq_rows=fq, feat_scale=scale, **kw)
    names = MIRRORS + ("logits", "probs", "h_a", "h_b", "table")
    _held(runs[0], want, names, tol)
    assert torch.equal(runs[0][6].argmax(-1), want[6].argmax(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["", "bfloat16", "int8"])
def test_cuda_streamed_tick_same_bits_at_every_node_block(cuda_device,
                                                          quant):
    """On the card the streamed tick's grid does not follow node_block:
    every output is equal bit for bit at node blocks 64, 512, 2,048 and Pn
    (4,096), on each feature table; on the float32 table its logits and
    probs equal the fused tick's bit for bit on the same state."""
    ops = tick_operands(17, pn=4096, hidden=64, caps=(256, 512, 192),
                        live=(200, 480, 100))
    offs, kw = ops[4], ops[5]
    pn, hid = ops[1].shape[0], ops[0]["embed_b"].shape[0]
    runs = []
    for nb in (64, 512, 2048, pn):
        p, x, m, ints, fq, scale = torch_operands(ops, cuda_device, quant)
        h = [torch.zeros((pn, hid), device=cuda_device) for _ in range(2)]
        out = fk.fused_gnn_tick_dma(
            p, x, *m, ints, *h, rel_offsets=offs, node_block=nb,
            feat_quant=quant, fq_rows=fq, feat_scale=scale, **kw)
        torch.cuda.synchronize()
        runs.append([t.cpu() for t in out])
    for nb, other in zip((512, 2048, pn), runs[1:]):
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b), (quant, nb)
    if not quant:
        p, x, m, ints, _, _ = torch_operands(ops, cuda_device)
        fused = fk.fused_gnn_tick(p, x, *m, ints, rel_offsets=offs, **kw)
        torch.cuda.synchronize()
        for a, b in zip(runs[0][:8], fused):
            assert torch.equal(a, b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [None, "bfloat16"])
@pytest.mark.parametrize("name", sorted(HARD_TICKS))
def test_cuda_update_epilogue_equals_plain_version_on_hard_layouts(
        cuda_device, name, cdt):
    """On the card, the layer update that the segment walk applies in its
    epilogue, on ``HARD_TICKS``' layouts (a hub of 600 edges, rows of
    in-degree 0, Pn not a multiple of 16, H 40 / 128 / 72 / 30 with
    feature widths 24 / 48 / 16 / 10): both entry points within rtol/atol 1e-5 (bf16
    operands 0.05) of the plain version on a CPU copy, argmax equal; two
    launches equal bit for bit; the streamed tick (node block Pn) equal to
    the fused tick bit for bit."""
    ops = hard_tick_operands(name)
    offs, kw = ops[4], ops[5]
    pn, hid = ops[1].shape[0], ops[0]["embed_b"].shape[0]
    tol = 0.05 if cdt else 1e-5
    runs = []
    for _ in range(2):
        p, x, m, ints, _, _ = torch_operands(ops, cuda_device)
        out = fk.fused_gnn_tick(p, x, *m, ints, rel_offsets=offs,
                                compute_dtype=cdt, **kw)
        torch.cuda.synchronize()
        runs.append([t.cpu() for t in out])
    for a, b in zip(*runs):
        assert torch.equal(a, b), name
    p, x, m, ints, _, _ = torch_operands(ops, cuda_device)
    h = [torch.zeros((pn, hid), device=cuda_device) for _ in range(2)]
    dma = fk.fused_gnn_tick_dma(p, x, *m, ints, *h, rel_offsets=offs,
                                node_block=pn, compute_dtype=cdt, **kw)
    torch.cuda.synchronize()
    for a, b in zip(runs[0], dma[:8]):
        assert torch.equal(a, b.cpu()), name
    p, x, m, ints, _, _ = torch_operands(ops, "cpu")
    want = fused_gnn_tick_plain(p, x, *m, ints, rel_offsets=offs,
                                compute_dtype=cdt, **kw)
    _held(runs[0], want, MIRRORS + ("logits", "probs"), tol)
    assert torch.equal(runs[0][6].argmax(-1), want[6].argmax(-1))
