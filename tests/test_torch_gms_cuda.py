"""The message-pass kernel (``kernels/gms.cu``) against its plain version
on the card. This file imports no JAX, so it also runs on a machine with
a GPU and no JAX; there, from the repository root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_gms_cuda.py

(``tests/conftest.py`` imports JAX). Without a GPU the test skips. The
layouts here are shared with test_torch_gms.py, which holds the plain
version to the JAX package on the CPU."""
import numpy as np
import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu_torch.kernels import gms
from kubernetes_aiops_evidence_graph_tpu_torch.ops.segment import (
    gather_matmul_segment)


def layout(seed, caps, live, n=33, h=8, k=8, sort_dst=True, e_extra=0):
    """A relation-bucketed layout: per slice a live prefix (dst-sorted when
    ``sort_dst``), padding with dst pinned to the last row and mask 0;
    ``e_extra`` edges past the last slice belong to no relation."""
    rng = np.random.default_rng(seed)
    offs = (0,) + tuple(int(c) for c in np.cumsum(caps))
    pe = offs[-1] + e_extra
    src = rng.integers(0, n, pe).astype(np.int32)
    dst = np.full(pe, n - 1, np.int32)
    mask = np.zeros(pe, np.float32)
    for r, c in enumerate(live):
        lo = offs[r]
        d = rng.integers(0, n, c).astype(np.int32)
        dst[lo:lo + c] = np.sort(d) if sort_dst else d
        mask[lo:lo + c] = 1.0
    hmat = rng.standard_normal((n, h)).astype(np.float32)
    w_rel = rng.standard_normal((len(caps), h, k)).astype(np.float32)
    return hmat, w_rel, src, dst, mask, offs, n


CASES = {
    # name: (caps, live, extra kwargs)
    "aligned": ((64, 128, 0, 64), (40, 128, 0, 3), {}),
    "aligned_unsorted": ((64, 128, 0, 64), (40, 128, 0, 3),
                         {"sort_dst": False}),
    "unaligned": ((5, 0, 17, 70, 1), (5, 0, 9, 70, 1), {"sort_dst": False}),
    "zero_width_and_all_padding": ((0, 64, 0, 128, 0), (0, 0, 0, 0, 0), {}),
    "rectangular_h48_k64": ((64, 64, 64), (50, 64, 7), {"h": 48, "k": 64}),
    "edges_past_the_slices": ((30, 40), (30, 12), {"e_extra": 9}),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_equals_plain_version(cuda_device):
    """On the card: every layout case within rtol 1e-5 / atol 1e-5 of the
    plain version on a CPU copy, which sums in the kernel's order (bf16
    operands within 0.05); two launches equal bit for bit, one count
    each."""
    for case in sorted(CASES) + ["bf16"]:
        caps, live, kw = CASES["aligned" if case == "bf16" else case]
        hmat, w_rel, src, dst, mask, offs, n = layout(9, caps, live, **kw)
        t = [torch.from_numpy(x).to(cuda_device)
             for x in (hmat, w_rel, src, dst, mask)]
        cdt = "bfloat16" if case == "bf16" else None
        before = gms.launches
        got = gms.gather_matmul_segment(*t, offs, n, compute_dtype=cdt)
        again = gms.gather_matmul_segment(*t, offs, n, compute_dtype=cdt)
        torch.cuda.synchronize()
        assert gms.launches == before + 2
        assert torch.equal(got, again), case
        want = gather_matmul_segment(*(x.cpu() for x in t), offs, n,
                                     compute_dtype=cdt)
        tol = 0.05 if cdt else 1e-5
        torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)


def hub_layout(seed, hub_edges, caps=(1000, 1200, 900), n=300, h=64, k=64,
               sort_dst=True):
    """Three relations whose live edges include ``hub_edges`` edges into
    one destination (row 5), spread over the three slices; the rest of
    each slice's live prefix goes to random rows, then padding."""
    rng = np.random.default_rng(seed)
    offs = (0,) + tuple(int(c) for c in np.cumsum(caps))
    pe = offs[-1]
    share = np.diff(np.linspace(0, hub_edges, len(caps) + 1).astype(int))
    src = rng.integers(0, n, pe).astype(np.int32)
    dst = np.full(pe, n - 1, np.int32)
    mask = np.zeros(pe, np.float32)
    for r, cap in enumerate(caps):
        live = min(cap, int(share[r]) + cap // 4)
        d = rng.integers(0, n, live).astype(np.int32)
        d[rng.permutation(live)[:share[r]]] = 5
        lo = offs[r]
        dst[lo:lo + live] = np.sort(d) if sort_dst else d
        mask[lo:lo + live] = 1.0
    hmat = rng.standard_normal((n, h)).astype(np.float32)
    w_rel = (rng.standard_normal((len(caps), h, k)) / np.sqrt(h)
             ).astype(np.float32)
    return hmat, w_rel, src, dst, mask, offs, n


def mirror_layout(seed, caps=(300, 0, 700, 256), n=400, h=64, k=64):
    """The streaming mirror's case: slices whose live edges lie anywhere
    in the slice (holes left by removed edges), destinations unsorted."""
    rng = np.random.default_rng(seed)
    offs = (0,) + tuple(int(c) for c in np.cumsum(caps))
    pe = offs[-1]
    src = rng.integers(0, n, pe).astype(np.int32)
    dst = rng.integers(0, n, pe).astype(np.int32)
    mask = (rng.random(pe) < 0.6).astype(np.float32)
    hmat = rng.standard_normal((n, h)).astype(np.float32)
    w_rel = (rng.standard_normal((len(caps), h, k)) / np.sqrt(h)
             ).astype(np.float32)
    return hmat, w_rel, src, dst, mask, offs, n


LAYOUTS = {
    # name: a layout (hmat, w_rel, src, dst, mask, offs, n)
    "hub_600_over_three_relations": lambda: hub_layout(21, 600),
    "hub_2000_over_three_relations": lambda: hub_layout(22, 2000),
    "hub_2000_unsorted": lambda: hub_layout(23, 2000, sort_dst=False),
    "mirror_unsorted_with_holes": lambda: mirror_layout(24),
    "unaligned_straddling_relations": lambda: layout(
        25, (5, 0, 17, 700, 1, 130, 3), (5, 0, 9, 650, 1, 130, 2), n=500,
        h=64, k=64, sort_dst=False),
    "empty_and_all_padding_slices": lambda: layout(
        26, (0, 64, 0, 640, 0), (0, 0, 0, 0, 0), n=200, h=64, k=64),
    "e_zero": lambda: layout(27, (0, 0, 0), (0, 0, 0), n=90, h=64, k=64),
    "h40_k24": lambda: layout(28, (64, 200, 64), (50, 180, 7), n=300,
                              h=40, k=24, sort_dst=False),
    "h128": lambda: layout(29, (128, 300, 64), (100, 300, 60), n=300,
                           h=128, k=64),
    "h24_k72": lambda: layout(30, (200, 90), (150, 90), n=150, h=24, k=72),
    # rows that are not whole 16-byte pieces: the kernels' scalar paths
    "h10_k7": lambda: layout(31, (70, 130), (70, 100), n=120, h=10, k=7),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LAYOUTS))
@pytest.mark.parametrize("cdt", [None, "bfloat16"])
def test_cuda_kernel_equals_plain_version_on_hard_layouts(cuda_device, name,
                                                          cdt):
    """On the card, layouts that stress the tile runs and the walk: hub
    destinations of 600 and 2,000 edges over three relations, unsorted
    slices with holes, unaligned offsets, empty slices, E = 0, H and K
    off the 32-column grid, rows that are not whole 16-byte pieces, H =
    128. Within rtol/atol 1e-5 (bf16 operands
    0.05) of the plain version on a CPU copy, which sums in the kernel's
    order; two launches equal bit for bit."""
    hmat, w_rel, src, dst, mask, offs, n = LAYOUTS[name]()
    t = [torch.from_numpy(x).to(cuda_device)
         for x in (hmat, w_rel, src, dst, mask)]
    before = gms.launches
    got = gms.gather_matmul_segment(*t, offs, n, compute_dtype=cdt)
    again = gms.gather_matmul_segment(*t, offs, n, compute_dtype=cdt)
    torch.cuda.synchronize()
    assert gms.launches == before + 2
    assert torch.equal(got, again), name
    want = gather_matmul_segment(*(x.cpu() for x in t), offs, n,
                                 compute_dtype=cdt)
    tol = 0.05 if cdt else 1e-5
    torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)
