"""The relation-bucketed message pass (``kernels/gms``): its plain version
against the JAX package's XLA kernel (``ops.segment``) and Pallas kernel
(``ops.pallas_segment``, interpret mode on the CPU) on the same numpy
inputs; and the dst-CSR the CUDA kernel walks, emulated on the CPU. The
kernel itself is held to the plain version in test_torch_gms_cuda.py."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kubernetes_aiops_evidence_graph_tpu.ops.pallas_segment import (
    pallas_gather_matmul_segment)
from kubernetes_aiops_evidence_graph_tpu.ops.segment import (
    gather_matmul_segment as jax_gms)
from kubernetes_aiops_evidence_graph_tpu_torch.kernels import gms
from kubernetes_aiops_evidence_graph_tpu_torch.ops.segment import (
    gather_matmul_segment)
from tests.test_torch_gms_cuda import CASES, LAYOUTS, layout

# one intra-op thread: these tensors are small, and the suite runs
# several pytest workers side by side on the host's cores
torch.set_num_threads(1)


def _port(a, compute_dtype=None):
    hmat, w_rel, src, dst, mask, offs, n = a
    t = [torch.from_numpy(x) for x in (hmat, w_rel, src, dst, mask)]
    return gather_matmul_segment(*t, offs, n,
                                 compute_dtype=compute_dtype).numpy()


def _f64(a):
    """Independent float64 oracle of the semantics, in edge order."""
    hmat, w_rel, src, dst, mask, offs, n = a
    out = np.zeros((n, w_rel.shape[-1]), np.float64)
    for r in range(len(offs) - 1):
        for e in range(offs[r], offs[r + 1]):
            out[dst[e]] += (hmat[src[e]].astype(np.float64) * mask[e]) \
                @ w_rel[r].astype(np.float64)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_equals_jax_xla_and_pallas(case):
    caps, live, kw = CASES[case]
    a = layout(sorted(CASES).index(case), caps, live, **kw)
    hmat, w_rel, src, dst, mask, offs, n = a
    mine = _port(a)
    j = [jnp.asarray(x) for x in (hmat, w_rel, src, dst, mask)]
    xla = np.asarray(jax_gms(*j, offs, n))
    pallas = np.asarray(pallas_gather_matmul_segment(*j, offs, n,
                                                     interpret=True))
    assert mine.shape == xla.shape == (n, w_rel.shape[-1])
    np.testing.assert_allclose(mine, xla, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mine, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mine, _f64(a), rtol=1e-5, atol=1e-5)
    if not mask.any():
        assert not mine.any()


def test_empty_layout_gives_zeros():
    a = layout(0, (0, 0, 0), (0, 0, 0))
    hmat, w_rel, src, dst, mask, offs, n = a
    assert src.size == 0
    mine = _port(a)
    assert mine.shape == (n, 8) and not mine.any()
    j = [jnp.asarray(x) for x in (hmat, w_rel, src, dst, mask)]
    np.testing.assert_array_equal(
        mine, np.asarray(pallas_gather_matmul_segment(*j, offs, n,
                                                      interpret=True)))


@pytest.mark.parametrize("case", ["aligned", "unaligned"])
def test_bf16_operands_within_tolerance(case):
    """bf16 operands, f32 accumulation: within 0.05 of the JAX kernels'
    bf16 path and of the f32 result (tests/test_ops.py's tolerance)."""
    caps, live, kw = CASES[case]
    a = layout(7, caps, live, **kw)
    hmat, w_rel, src, dst, mask, offs, n = a
    mine = _port(a, compute_dtype="bfloat16")
    j = [jnp.asarray(x) for x in (hmat, w_rel, src, dst, mask)]
    for fn in (jax_gms, lambda *x, **kw: pallas_gather_matmul_segment(
            *x, interpret=True, **kw)):
        ref = np.asarray(fn(*j, offs, n, compute_dtype=jnp.bfloat16))
        np.testing.assert_allclose(mine, ref, rtol=0.05, atol=0.05)
    np.testing.assert_allclose(mine, _port(a), rtol=0.05, atol=0.05)


def test_sorted_and_unsorted_slices_agree():
    """The same edges in another order within their slices: the same sums
    to float tolerance (the order of a destination's adds changes)."""
    a = layout(3, (64, 64), (60, 64), sort_dst=True)
    hmat, w_rel, src, dst, mask, offs, n = a
    rng = np.random.default_rng(4)
    perm = np.concatenate([rng.permutation(64), 64 + rng.permutation(64)])
    b = (hmat, w_rel, src[perm], dst[perm], mask[perm], offs, n)
    np.testing.assert_allclose(_port(a), _port(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_csr_walk_equals_plain_version_bit_for_bit(case):
    """The CUDA kernel's order, emulated on the CPU: per-edge messages, then
    each destination's messages summed along make_plan's CSR. It equals the
    plain version exactly (both add a destination's messages in ascending
    edge index; skipped padding only ever adds +-0)."""
    caps, live, kw = CASES[case]
    hmat, w_rel, src, dst, mask, offs, n = layout(11, caps, live, **kw)
    t = {k: torch.from_numpy(v) for k, v in
         (("h", hmat), ("w", w_rel), ("src", src), ("dst", dst), ("m", mask))}
    plan = gms.make_plan(t["dst"], t["m"], offs, n)
    assert plan.rowptr.shape == (n + 1,) and int(plan.rowptr[-1]) == \
        int((mask[offs[0]:offs[-1]] != 0).sum())
    msg = torch.zeros((src.shape[0], w_rel.shape[-1]))
    for r in range(len(offs) - 1):
        lo, hi = offs[r], offs[r + 1]
        if hi > lo:
            msg[lo:hi] = (t["h"][t["src"][lo:hi].long()]
                          * t["m"][lo:hi, None]) @ t["w"][r]
    out = torch.zeros((n, w_rel.shape[-1]))
    perm, rowptr = plan.perm.tolist(), plan.rowptr.tolist()
    for d in range(n):
        edges = perm[rowptr[d]:rowptr[d + 1]]
        assert edges == sorted(edges) and all(dst[e] == d for e in edges)
        for e in edges:
            out[d] += msg[e]
    np.testing.assert_array_equal(out.numpy(), _port(
        (hmat, w_rel, src, dst, mask, offs, n)))


def test_bound_counts_distinct_rows_live_edges_and_weights():
    src = np.array([1, 1, 2, 0, 5, 5], np.int32)
    mask = np.array([1, 1, 1, 0, 1, 0], np.float32)
    nbytes, ops = gms.bound(src, mask, (0, 4, 6), hid=8, k_out=4,
                            num_segments=10)
    # rows {1, 2, 5}, 4 live edges, w_rel [2, 8, 4], out [10, 4]
    assert nbytes == 3 * 8 * 4 + 4 * 12 + 2 * 8 * 4 * 4 + 10 * 4 * 4
    assert ops == 2 * 4 * 8 * 4


def test_wrapper_runs_plain_version_only_for_cpu_tensors():
    a = layout(5, (64,), (10,))
    hmat, w_rel, src, dst, mask, offs, n = a
    before = gms.launches
    t = [torch.from_numpy(x) for x in (hmat, w_rel, src, dst, mask)]
    out = gms.gather_matmul_segment(*t, offs, n)
    assert gms.launches == before, "the plain version must not count"
    np.testing.assert_array_equal(out.numpy(), _port(a))
    with pytest.raises(ValueError, match="cuda or cpu"):
        gms.gather_matmul_segment(*[x.to("meta") for x in t], offs, n)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_plain_version_equals_jax_on_hard_layouts(name):
    """The layouts the CUDA test stresses the kernel with (hubs of 600 and
    2,000 edges, unsorted slices with holes, unaligned offsets, empty
    slices, E = 0, H x K of 40 x 24, 128 x 64, 24 x 72 and 10 x 7): the
    plain version within 1e-5 of the JAX package's XLA kernel and of a
    float64 oracle in edge order."""
    a = LAYOUTS[name]()
    hmat, w_rel, src, dst, mask, offs, n = a
    mine = _port(a)
    j = [jnp.asarray(x) for x in (hmat, w_rel, src, dst, mask)]
    xla = np.asarray(jax_gms(*j, offs, n))
    np.testing.assert_allclose(mine, xla, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mine, _f64(a), rtol=1e-5, atol=1e-4)


def _runs_by_brute_force(offs):
    """Tile runs from their definition, edge by edge: a slice's edges in
    order, a new run every ``per_run`` edges from the slice's start, with
    per_run = 64 * min(RUN_TILES_MAX, max(1, ceil(tiles / RUNS_TARGET)))
    and tiles = the 64-edge tiles of all slices."""
    tiles = 0
    for lo, hi in zip(offs, offs[1:]):
        tiles += len(range(lo, hi, 64))
    per_tiles = 1
    while (per_tiles < gms.RUN_TILES_MAX
           and per_tiles * gms.RUNS_TARGET < tiles):
        per_tiles += 1
    per_run = 64 * per_tiles
    runs = []
    for r, (lo, hi) in enumerate(zip(offs, offs[1:])):
        for e in range(lo, hi):
            if (e - lo) % per_run == 0:
                runs.append([r, e, e + 1])
            else:
                runs[-1][2] = e + 1
    return runs, per_run


RUN_OFFSETS = {
    "aligned": (0, 64, 192, 192, 256),
    "unaligned": (0, 5, 5, 22, 92, 93, 96, 296),
    "empty_slices": (0, 0, 0, 640, 640, 1000),
    "e_zero": (0, 0, 0),
    "one_relation_none": (0,),
    "nonzero_start": (10, 10, 75, 400),
    "config3": (0, 57048, 127334, 202534, 272534, 273038, 273138, 273238,
                273238, 273238),
    "capped_at_16_tiles": (0, 1_200_000, 2_500_000, 2_500_001),
}


@pytest.mark.parametrize("name", sorted(RUN_OFFSETS))
def test_tile_runs_equal_a_brute_force_cut(name):
    """The host-side cut of the tile kernel's work (``gms.tile_runs``)
    against its definition on the same offsets: the same runs; each run
    inside one slice and at most RUN_TILES_MAX tiles; the runs cover every
    slice's edges once, in order; make_plan carries them to the device."""
    offs = RUN_OFFSETS[name]
    runs = gms.tile_runs(offs)
    want, per_run = _runs_by_brute_force(offs)
    assert runs.dtype == np.int32 and runs.shape == (len(want), 3)
    assert runs.tolist() == want
    assert per_run <= 64 * gms.RUN_TILES_MAX
    covered = [e for _, a, b in want for e in range(a, b)]
    assert covered == list(range(offs[0], offs[-1]))
    for r, a, b in want:
        assert offs[r] <= a < b <= offs[r + 1] and b - a <= per_run
    if offs[-1] <= 2000:
        dst = torch.zeros(offs[-1], dtype=torch.int32)
        plan = gms.make_plan(dst, torch.ones(offs[-1]), offs, 4)
        assert plan.n_runs == len(want)
        assert plan.runs.tolist() == runs.reshape(-1).tolist()
