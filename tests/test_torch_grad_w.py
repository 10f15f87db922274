"""The backward of the message pass: the plain weight gradient
(``ops/segment.gms_grad_w``, the plain version of ``kernels/grad_w``)
against the JAX package's Pallas kernel ``_gms_grad_w`` in interpret mode
and a float64 oracle; the plain backward ``gather_matmul_segment_vjp`` and
torch's autograd of the plain forward against ``jax.grad`` of the XLA and
Pallas message passes; and the kernel's cut into work items, emulated on
the CPU. The CUDA kernel and the autograd Function are held to these in
test_torch_grad_w_cuda.py."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kubernetes_aiops_evidence_graph_tpu.ops.pallas_segment import (
    _gms_grad_w, pallas_gather_matmul_segment)
from kubernetes_aiops_evidence_graph_tpu.ops.segment import (
    gather_matmul_segment as jax_gms)
from kubernetes_aiops_evidence_graph_tpu_torch.kernels import grad_w
from kubernetes_aiops_evidence_graph_tpu_torch.ops.segment import (
    gather_matmul_segment, gather_matmul_segment_vjp, gms_grad_w)
from tests.test_torch_grad_w_cuda import ALIGNED, GRAD_CASES, grad_case

torch.set_num_threads(1)


def _f64_grads(hmat, w_rel, src, dst, mask, offs, ct, num_rels):
    """Independent float64 oracle: ``dh[s] += mask * ct[d] @ w_r^T`` and
    ``dw_r += outer(h[s] * mask, ct[d])`` per edge of slice r."""
    h64, ct64 = hmat.astype(np.float64), ct.astype(np.float64)
    dh = np.zeros_like(h64)
    dw = np.zeros((num_rels,) + w_rel.shape[1:], np.float64)
    for r in range(len(offs) - 1):
        wr = w_rel[r].astype(np.float64)
        for e in range(offs[r], offs[r + 1]):
            dh[src[e]] += mask[e] * (ct64[dst[e]] @ wr.T)
            dw[r] += np.outer(h64[src[e]] * mask[e], ct64[dst[e]])
    return dh, dw


def _close(got, want, tol=1e-5):
    """Within ``tol`` of the result's scale: sums of many products cancel,
    so an element's error tracks the largest terms, not its own size."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * scale)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_plain_grad_w_equals_f64_oracle(name):
    hmat, w_rel, src, dst, mask, offs, n, ct = grad_case(name)
    nr = w_rel.shape[0]
    got = gms_grad_w(*_t(hmat, ct, src, dst, mask), offs, nr).numpy()
    assert got.shape == (nr,) + w_rel.shape[1:] and got.dtype == np.float32
    _, want = _f64_grads(hmat, w_rel, src, dst, mask, offs, ct, nr)
    _close(got, want)
    # relations past the layout, zero-width and all-padding slices: exact 0
    for r in range(nr):
        lo, hi = (offs[r], offs[r + 1]) if r < len(offs) - 1 else (0, 0)
        if not mask[lo:hi].any():
            assert (got[r] == 0.0).all(), r


@pytest.mark.parametrize("name", sorted(ALIGNED))
@pytest.mark.parametrize("cdt", [None, "bfloat16"])
def test_plain_grad_w_equals_jax_pallas_kernel(name, cdt):
    """Against ``_gms_grad_w`` (the Pallas TPU kernel, interpret mode), on
    the EDGE_TILE-aligned layouts it takes, within 1e-5 of the result's
    scale; bf16 operands too (both round the gathered rows h * mask to bf16
    and sum the same products in float32)."""
    hmat, w_rel, src, dst, mask, offs, n, ct = grad_case(name, seed=3)
    nr = w_rel.shape[0]
    got = gms_grad_w(*_t(hmat, ct, src, dst, mask), offs, nr,
                     compute_dtype=cdt).numpy()
    want = np.asarray(_gms_grad_w(
        offs, True, None if cdt is None else jnp.bfloat16,
        *[jnp.asarray(x) for x in (hmat, ct, src, dst, mask)],
        jnp.float32, nr))
    _close(got, want)


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_plain_vjp_equals_jax_grad_of_xla_and_pallas(name):
    """``gather_matmul_segment_vjp`` and torch's autograd of the plain
    forward against ``jax.grad`` of ``(gms(h, w) * ct).sum()`` through the
    XLA kernel and the Pallas kernel (interpret mode; it takes the XLA
    kernel off the EDGE_TILE ladder), rtol/atol 1e-4 as tests/test_ops.py
    holds them, and the f64 oracle."""
    hmat, w_rel, src, dst, mask, offs, n, ct = grad_case(name, seed=5)
    w_used = w_rel[:len(offs) - 1]
    th, tw, tsrc, tdst, tm, tct = _t(hmat, w_used, src, dst, mask, ct)
    dh, dw = gather_matmul_segment_vjp(th, tw, tsrc, tdst, tm, offs, n, tct)
    ah, aw = th.clone().requires_grad_(), tw.clone().requires_grad_()
    (gather_matmul_segment(ah, aw, tsrc, tdst, tm, offs, n) * tct
     ).sum().backward()
    j = [jnp.asarray(x) for x in (src, dst, mask, ct)]
    for fn in (jax_gms, lambda *a, **k: pallas_gather_matmul_segment(
            *a, interpret=True, **k)):
        jh, jw = jax.grad(lambda hh, ww: (fn(hh, ww, j[0], j[1], j[2], offs,
                                             n) * j[3]).sum(),
                          argnums=(0, 1))(jnp.asarray(hmat),
                                          jnp.asarray(w_used))
        for mine in ((dh, dw), (ah.grad, aw.grad)):
            np.testing.assert_allclose(mine[0].numpy(), np.asarray(jh),
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(mine[1].numpy(), np.asarray(jw),
                                       rtol=1e-4, atol=1e-4)
    oh, ow = _f64_grads(hmat, w_used, src, dst, mask, offs, ct, len(w_used))
    np.testing.assert_allclose(dh.numpy(), oh, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dw.numpy(), ow, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_plain_bf16_grads_within_the_jax_bf16_tolerance(kernel):
    """compute_dtype=bfloat16: float32 grads, within tests/test_ops.py's
    bf16 tolerance of the JAX kernel's bf16 grads and of the f32 grads."""
    hmat, w_rel, src, dst, mask, offs, n, ct = grad_case("aligned", seed=7)
    w_used = w_rel[:len(offs) - 1]
    args = _t(hmat, w_used, src, dst, mask)
    tct = torch.from_numpy(ct)
    mine = gather_matmul_segment_vjp(*args, offs, n, tct,
                                     compute_dtype="bfloat16")
    assert mine[0].dtype == mine[1].dtype == torch.float32
    f32 = gather_matmul_segment_vjp(*args, offs, n, tct)
    fn = jax_gms if kernel == "xla" else (
        lambda *a, **k: pallas_gather_matmul_segment(*a, interpret=True, **k))
    j = [jnp.asarray(x) for x in (src, dst, mask, ct)]
    ref = jax.grad(lambda hh, ww: (fn(hh, ww, j[0], j[1], j[2], offs, n,
                                      compute_dtype=jnp.bfloat16)
                                   * j[3]).sum(),
                   argnums=(0, 1))(jnp.asarray(hmat), jnp.asarray(w_used))
    for want in (ref, f32):
        for a, b in zip(want, mine):
            a = np.asarray(a)
            np.testing.assert_allclose(b.numpy(), a, rtol=0.06,
                                       atol=0.02 * float(np.abs(a).max()))


def test_work_items_cut_every_slice_into_equal_runs_of_tiles():
    offs = (0, 5, 5, 700, 9000, 9001, 20000)
    items, rel_items = grad_w.work_items(offs)
    assert rel_items[0] == 0 and rel_items[-1] == len(items)
    per = {int(hi - lo) for _, lo, hi in items if hi - lo}
    step = max(per)
    assert step % 64 == 0
    for r in range(len(offs) - 1):
        mine = items[rel_items[r]:rel_items[r + 1]]
        assert (mine[:, 0] == r).all()
        covered = [e for _, lo, hi in mine for e in range(lo, hi)]
        assert covered == list(range(offs[r], offs[r + 1]))
        # every item but a slice's last is a full run
        assert all(hi - lo == step for _, lo, hi in mine[:-1])
    big = grad_w.work_items((0, 64 * 100_000))[0]
    assert len(big) <= grad_w.ITEM_TILES_TARGET


def test_col_groups_spread_few_items_and_depend_on_the_layout_alone():
    """Four column groups where the items alone leave most of the card
    idle, one where they fill it; a split is taken only when the card holds
    its whole grid at once, and the same layout always gets the same
    split."""
    cap = grad_w.GRID_CAPACITY
    assert grad_w.col_groups(17, 64, 64) == 4
    assert grad_w.col_groups(cap[4] // 4, 64, 64) == 4
    assert grad_w.col_groups(cap[4] // 4 + 1, 64, 64) == 2
    assert grad_w.col_groups(cap[2] // 2, 64, 64) == 2
    assert grad_w.col_groups(cap[2] // 2 + 1, 64, 64) == 1
    assert grad_w.col_groups(10 * cap[2], 64, 64) == 1
    assert grad_w.col_groups(0, 64, 64) == 4
    # wider outputs already give more blocks per item
    assert grad_w.col_groups(cap[4] // 4, 128, 64) == 2
    for offs in ((0, 1088), (0, 64, 64, 5000, 20000), (0, 64 * 4000)):
        n_items = len(grad_w.work_items(offs)[0])
        groups = grad_w.col_groups(n_items, 64, 64)
        assert groups == 1 or n_items * groups <= cap[groups]
        assert groups == grad_w.col_groups(
            len(grad_w.work_items(offs)[0]), 64, 64)


@pytest.mark.parametrize("offs", [
    (0,), (0, 0), (0, 5, 5, 700, 9000, 9001, 20000), (0, 64 * 100_000),
    tuple(range(0, 64 * 33, 64)), (0, 1088, 1088, 4000)])
def test_launch_layout_gives_every_work_item_by_arithmetic(offs):
    """What the kernel takes instead of the item table: the slices, each
    slice's first item and the item length. Its arithmetic (the relation
    is the last slice whose first item is at most i; the item runs
    per_item edges from its slice's start) gives work_items' items."""
    items, rel_items = grad_w.work_items(offs)
    offs_np, rel_np, n_items, per_item = grad_w._launch_layout(offs)
    assert n_items == len(items) == rel_np[-1]
    np.testing.assert_array_equal(rel_np, rel_items)
    n_slices = len(offs) - 1
    for i, (r, lo, hi) in enumerate(items):
        rel = 0
        while rel + 1 < n_slices and rel_np[rel + 1] <= i:
            rel += 1
        start = offs_np[rel] + (i - rel_np[rel]) * per_item
        assert (rel, start, min(offs_np[rel + 1], start + per_item)) == \
            (r, lo, hi)


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_kernel_order_emulated_equals_plain_version(name):
    """The CUDA kernel's order on the CPU: per work item the live edges'
    outer products summed in edge order, then each relation's items summed
    in item order. Within 1e-5 of the scale of the plain version (which sums
    the same products in one matmul)."""
    hmat, w_rel, src, dst, mask, offs, n, ct = grad_case(name, seed=9)
    nr = w_rel.shape[0]
    items, rel_items = grad_w.work_items(offs)
    parts = np.zeros((len(items),) + w_rel.shape[1:], np.float32)
    for i, (_, lo, hi) in enumerate(items):
        for e in range(lo, hi):
            if mask[e] != 0:
                parts[i] += np.outer(hmat[src[e]] * mask[e], ct[dst[e]])
    dw = np.zeros((nr,) + w_rel.shape[1:], np.float32)
    for r in range(len(offs) - 1):
        for i in range(rel_items[r], rel_items[r + 1]):
            dw[r] += parts[i]
    want = gms_grad_w(*_t(hmat, ct, src, dst, mask), offs, nr).numpy()
    _close(dw, want)


def test_bound_counts_distinct_rows_live_edges_and_dw():
    src = np.array([1, 1, 2, 0, 5, 5], np.int32)
    dst = np.array([3, 4, 4, 0, 3, 9], np.int32)
    mask = np.array([1, 1, 1, 0, 1, 0], np.float32)
    nbytes, ops = grad_w.bound(src, dst, mask, (0, 4, 6), hid=8, k_out=4,
                               num_rels=3)
    # h rows {1, 2, 5}, g rows {3, 4}, 4 live edges, dw [3, 8, 4]
    assert nbytes == 3 * 8 * 4 + 2 * 4 * 4 + 4 * 12 + 3 * 8 * 4 * 4
    assert ops == 2 * 4 * 8 * 4


def test_wrapper_runs_plain_version_only_for_cpu_tensors():
    hmat, w_rel, src, dst, mask, offs, n, ct = grad_case("aligned")
    t = _t(hmat, ct, src, dst, mask)
    before = grad_w.launches
    out = grad_w.gms_grad_w(*t, offs, w_rel.shape[0])
    assert grad_w.launches == before, "the plain version must not count"
    np.testing.assert_array_equal(
        out.numpy(), gms_grad_w(*t, offs, w_rel.shape[0]).numpy())
    with pytest.raises(ValueError, match="cuda or cpu"):
        grad_w.gms_grad_w(*[x.to("meta") for x in t], offs, w_rel.shape[0])
    with pytest.raises(ValueError, match="relation slices"):
        gms_grad_w(*t, offs, len(offs) - 2)


def test_plan_keeps_one_src_csr_and_refuses_another_layout():
    """The src-CSR a plan keeps for the backward is the src-CSR of the
    tensors it was first asked for: the same tensors get the kept one,
    other tensors, a changed mask or another row count raise."""
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import gms
    _, _, src, dst, mask, offs, n, _ = grad_case("unaligned")
    src, dst, mask = _t(src, dst, mask)
    plan = gms.make_plan(dst, mask, offs, n)
    csr = plan.transposed(src, mask, n)
    want = gms.make_plan(src, mask, offs, n)
    assert torch.equal(csr.perm, want.perm)
    assert torch.equal(csr.rowptr, want.rowptr)
    assert plan.transposed(src, mask, n) is csr
    with pytest.raises(ValueError, match="src-CSR"):
        plan.transposed(src.clone(), mask, n)
    with pytest.raises(ValueError, match="src-CSR"):
        plan.transposed(src, mask, n + 1)
    mask[0] = 1 - mask[0]
    with pytest.raises(ValueError, match="src-CSR"):
        plan.transposed(src, mask, n)
