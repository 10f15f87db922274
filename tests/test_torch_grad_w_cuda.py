"""The weight-gradient kernel (``kernels/grad_w.cu``) and the message
pass's autograd Function (``kernels/gms``) against their plain versions on
the card. This file imports no JAX, so it also runs on a machine with a GPU
and no JAX; there, from the repository root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_grad_w_cuda.py

(``tests/conftest.py`` imports JAX). Without a GPU the tests skip. The
layouts here are shared with test_torch_grad_w.py, which holds the plain
versions to the JAX package on the CPU."""
import numpy as np
import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu_torch.kernels import gms, grad_w
from kubernetes_aiops_evidence_graph_tpu_torch.ops.segment import (
    gather_matmul_segment, gms_grad_w)


def layout(seed, caps, live, n=33, h=8, k=8, sort_dst=True, e_extra=0):
    """A relation-bucketed layout (test_torch_gms_cuda.py's, kept here so
    this file imports nothing of the tests package): per slice a live
    prefix, padding with dst pinned to the last row and mask 0;
    ``e_extra`` edges past the last slice belong to no relation."""
    rng = np.random.default_rng(seed)
    offs = (0,) + tuple(int(c) for c in np.cumsum(caps))
    pe = offs[-1] + e_extra
    src = rng.integers(0, n, pe).astype(np.int32)
    dst = np.full(pe, n - 1, np.int32)
    mask = np.zeros(pe, np.float32)
    for r, c in enumerate(live):
        d = rng.integers(0, n, c).astype(np.int32)
        dst[offs[r]:offs[r] + c] = np.sort(d) if sort_dst else d
        mask[offs[r]:offs[r] + c] = 1.0
    hmat = rng.standard_normal((n, h)).astype(np.float32)
    w_rel = rng.standard_normal((len(caps), h, k)).astype(np.float32)
    return hmat, w_rel, src, dst, mask, offs, n


# name: (caps, live, layout kwargs, depth of w_rel)
GRAD_CASES = {
    "aligned": ((64, 128, 0, 64), (40, 128, 0, 3), {}, 4),
    "all_padding_and_zero_width": ((0, 64, 0, 128, 0), (0, 0, 0, 50, 0), {},
                                   5),
    "relations_past_the_layout": ((64, 64), (30, 64), {}, 5),
    "repeated_src_and_dst": ((128, 64), (128, 50), {"n": 4}, 2),
    "rectangular_h48_k64": ((64, 64, 64), (50, 64, 7), {"h": 48, "k": 64},
                            3),
    "unaligned": ((5, 0, 17, 70, 1), (5, 0, 9, 70, 1), {"sort_dst": False},
                  5),
    "edges_past_the_slices": ((30, 40), (30, 12), {"e_extra": 9}, 2),
}
# the layouts on the EDGE_TILE ladder (the JAX Pallas kernel's own)
ALIGNED = ("aligned", "all_padding_and_zero_width",
           "relations_past_the_layout", "repeated_src_and_dst",
           "rectangular_h48_k64")


def grad_case(name, seed=0):
    """(h, w_rel, src, dst, mask, offs, n, ct) of a case; w_rel as deep as
    the case says, ct a cotangent of the message pass's output."""
    caps, live, kw, num_rels = GRAD_CASES[name]
    hmat, w_rel, src, dst, mask, offs, n = layout(seed, caps, live, **kw)
    rng = np.random.default_rng(seed + 100)
    ct = rng.standard_normal((n, w_rel.shape[-1])).astype(np.float32)
    if num_rels > w_rel.shape[0]:
        extra = rng.standard_normal((num_rels - w_rel.shape[0],)
                                    + w_rel.shape[1:]).astype(np.float32)
        w_rel = np.concatenate([w_rel, extra])
    return hmat, w_rel, src, dst, mask, offs, n, ct


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_grad_w_kernel_equals_plain_version(cuda_device):
    """Every case within 1e-5 of the result's scale of the plain version on
    a CPU copy (bf16 h too), relations with no live edge exactly zero, two
    launches equal bit for bit, one count each."""
    for name in sorted(GRAD_CASES):
        hmat, w_rel, src, dst, mask, offs, n, ct = grad_case(name, seed=2)
        t = [torch.from_numpy(x).to(cuda_device)
             for x in (hmat, ct, src, dst, mask)]
        nr = w_rel.shape[0]
        for cdt in (None, "bfloat16"):
            before = grad_w.launches
            got = grad_w.gms_grad_w(*t, offs, nr, compute_dtype=cdt)
            again = grad_w.gms_grad_w(*t, offs, nr, compute_dtype=cdt)
            torch.cuda.synchronize()
            assert grad_w.launches == before + 2
            assert torch.equal(got, again), (name, cdt)
            want = gms_grad_w(*(x.cpu() for x in t), offs, nr,
                              compute_dtype=cdt)
            scale = max(float(want.abs().max()), 1.0)
            assert float((got.cpu() - want).abs().max()) <= 1e-5 * scale, \
                (name, cdt)
            for r in range(nr):
                lo, hi = (offs[r], offs[r + 1]) if r < len(offs) - 1 else (0, 0)
                if not mask[lo:hi].any():
                    assert not got[r].any(), (name, r)


@pytest.mark.cuda
def test_gms_function_grads_equal_plain_autograd(cuda_device):
    """grads of ``(out * ct).sum()`` through the Function on the card (dh by
    the gms kernel on the src-CSR, dw by grad_w) against torch's autograd of
    the plain version on a CPU copy, rtol/atol 1e-4; dw non-zero; under
    no_grad nothing is built for the backward."""
    for name in sorted(GRAD_CASES):
        hmat, w_rel, src, dst, mask, offs, n, ct = grad_case(name, seed=4)
        w_used = w_rel[:len(offs) - 1]
        dev = [torch.from_numpy(x).to(cuda_device)
               for x in (hmat, w_used, src, dst, mask, ct)]
        cpu = [x.cpu() for x in dev]
        h, w = (x.clone().requires_grad_() for x in dev[:2])
        plan = gms.make_plan(dev[3], dev[4], offs, n)
        g0, w0 = gms.launches, grad_w.launches
        out = gms.gather_matmul_segment(h, w, *dev[2:5], offs, n, plan=plan)
        dh, dw = torch.autograd.grad((out * dev[5]).sum(), (h, w))
        assert gms.launches == g0 + 2 and grad_w.launches == w0 + 1
        assert len(plan._transposed) == 1
        hc, wc = (x.clone().requires_grad_() for x in cpu[:2])
        want = torch.autograd.grad(
            (gather_matmul_segment(hc, wc, *cpu[2:5], offs, n) * cpu[5]).sum(),
            (hc, wc))
        torch.testing.assert_close(dh.cpu(), want[0], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(dw.cpu(), want[1], rtol=1e-4, atol=1e-4)
        if mask.any():
            assert dw.abs().sum() > 0, name
        with torch.no_grad():
            fresh = gms.make_plan(dev[3], dev[4], offs, n)
            gms.gather_matmul_segment(h, w, *dev[2:5], offs, n, plan=fresh)
        assert not fresh._transposed


def _device_case(name, dev, seed=6):
    hmat, w_rel, src, dst, mask, offs, n, ct = grad_case(name, seed=seed)
    t = [torch.from_numpy(x).to(dev) for x in (hmat, ct, src, dst, mask)]
    return t, offs, w_rel.shape[0], mask


@pytest.mark.cuda
def test_grad_w_bits_equal_under_every_column_split(cuda_device):
    """The column split the wrapper chooses from the layout changes no
    output's operations: 1, 2 and 4 column groups give the same bits (f32
    and bf16 h), and so does the wrapper's own choice."""
    for name in sorted(GRAD_CASES):
        t, offs, nr, _ = _device_case(name, cuda_device)
        for cdt in (None, "bfloat16"):
            chosen = grad_w.gms_grad_w(*t, offs, nr, compute_dtype=cdt)
            for groups in (1, 2, 4):
                got = grad_w.gms_grad_w(*t, offs, nr, compute_dtype=cdt,
                                        _col_groups=groups)
                torch.cuda.synchronize()
                assert torch.equal(got.view(torch.int32),
                                   chosen.view(torch.int32)), \
                    (name, cdt, groups)


@pytest.mark.cuda
def test_grad_w_long_items_equal_plain_version_under_every_split(
        cuda_device):
    """A layout of more than ITEM_TILES_TARGET tiles, so that each work item
    runs over several tiles (the staging ring wraps around) and relations
    hold many items: within 1e-5 of the result's scale of the plain version
    on a CPU copy, and the same bits at 1, 2 and 4 column groups."""
    caps = (64 * 300, 64 * 200, 64 * 3, 0, 64 * 150)
    hmat, _, src, dst, mask, offs, n = layout(
        11, caps, (64 * 300 - 5, 64 * 180, 130, 0, 64 * 150), n=3000, h=64,
        k=64)
    assert len(grad_w.work_items(offs)[0]) < offs[-1] // 64
    ct = np.random.default_rng(12).standard_normal((n, 64)).astype(
        np.float32) / n
    t = [torch.from_numpy(x).to(cuda_device)
         for x in (hmat, ct, src, dst, mask)]
    want = gms_grad_w(*(x.cpu() for x in t), offs, 6)
    scale = float(want.abs().max())
    first = None
    for groups in (1, 2, 4):
        got = grad_w.gms_grad_w(*t, offs, 6, _col_groups=groups)
        torch.cuda.synchronize()
        assert float((got.cpu() - want).abs().max()) <= 1e-5 * scale
        if first is None:
            first = got
        assert torch.equal(got.view(torch.int32), first.view(torch.int32))


@pytest.mark.cuda
def test_grad_w_bits_equal_on_two_streams(cuda_device):
    """Two launches on two streams, back to back and free to overlap, each
    with its own partials: both equal a launch on the default stream."""
    for name in ("aligned", "unaligned", "repeated_src_and_dst"):
        t, offs, nr, _ = _device_case(name, cuda_device)
        want = grad_w.gms_grad_w(*t, offs, nr, _col_groups=4)
        torch.cuda.synchronize()
        streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
        got = []
        for s in streams:
            s.wait_stream(torch.cuda.current_stream(cuda_device))
            with torch.cuda.stream(s):
                got.append(grad_w.gms_grad_w(*t, offs, nr, _col_groups=4))
        torch.cuda.synchronize()
        for g in got:
            assert torch.equal(g.view(torch.int32), want.view(torch.int32)), \
                name


@pytest.mark.cuda
def test_grad_w_bits_equal_after_a_layout_with_more_relations(
        cuda_device):
    """A launch on a layout with more relations, each of several items,
    leaves nothing behind that a later launch reads: two launches on a
    smaller layout after it equal one before it, bit for bit."""
    small, offs_s, nr_s, _ = _device_case("aligned", cuda_device)
    hmat, _, src, dst, mask, offs_b, n = layout(
        8, (192,) * 7, (150, 192, 3, 0, 100, 192, 64))
    rng = np.random.default_rng(9)
    big = [torch.from_numpy(x).to(cuda_device) for x in (
        hmat, rng.standard_normal((n, 8)).astype(np.float32), src, dst,
        mask)]
    assert len(offs_b) > len(offs_s)
    before = grad_w.gms_grad_w(*small, offs_s, nr_s)
    for groups in (1, 4):
        grad_w.gms_grad_w(*big, offs_b, 7, _col_groups=groups)
    first = grad_w.gms_grad_w(*small, offs_s, nr_s)
    second = grad_w.gms_grad_w(*small, offs_s, nr_s)
    torch.cuda.synchronize()
    for got in (first, second):
        assert torch.equal(got.view(torch.int32), before.view(torch.int32))


@pytest.mark.cuda
def test_grad_w_exact_zeros_for_relations_without_live_edges(cuda_device):
    """Zero-width slices, all-padding slices and relations past the
    layout's slices get +0.0 in every element, under every split."""
    for name in ("all_padding_and_zero_width", "relations_past_the_layout",
                 "aligned", "unaligned"):
        t, offs, nr, mask = _device_case(name, cuda_device)
        for groups in (1, 2, 4):
            got = grad_w.gms_grad_w(*t, offs, nr, _col_groups=groups).cpu()
            for r in range(nr):
                lo, hi = (offs[r], offs[r + 1]) if r < len(offs) - 1 else (0, 0)
                if not mask[lo:hi].any():
                    assert not got[r].view(torch.int32).any(), \
                        (name, groups, r)
