"""The fused GNN serving tick: the port's plain versions
(``ops/fused_tick``: the fused tick and the streamed tick with its
bf16/int8 feature tiers) against the JAX package's
``pallas_fused_gnn_tick`` and ``pallas_fused_gnn_tick_dma`` in interpret
mode, on the same numpy inputs with repeated and out-of-range delta
entries; ``quantize_features`` against the JAX one; the layout checks and
the bound. The kernels themselves are held to the plain versions in
test_torch_fused_tick_cuda.py."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kubernetes_aiops_evidence_graph_tpu.ops.pallas_segment import (
    dma_tick_traffic_floor as jax_floor, pallas_fused_gnn_tick,
    pallas_fused_gnn_tick_dma, quantize_features as jax_quantize)
from kubernetes_aiops_evidence_graph_tpu.rca.gnn_streaming import _gnn_tick
from kubernetes_aiops_evidence_graph_tpu_torch.graph.schema import DIM
from kubernetes_aiops_evidence_graph_tpu_torch.kernels import fused_tick as fk
from kubernetes_aiops_evidence_graph_tpu_torch.ops.fused_tick import (
    dma_tick_traffic_floor, fused_gnn_tick_dma_plain, fused_gnn_tick_plain,
    quantize_features)
from tests.test_torch_fused_tick_cuda import (
    HARD_TICKS, MIRRORS, hard_tick_operands, quant_rows, tick_operands,
    torch_operands)

# one intra-op thread: these tensors are small, and the suite runs
# several pytest workers side by side on the host's cores
torch.set_num_threads(1)

NAMES = MIRRORS + ("logits", "probs", "h_a", "h_b", "table")
QUANT_TOL = {"bfloat16": 0.05, "int8": 0.1}
_CACHE: dict = {}


def _jax_args(ops, feat_quant=""):
    params, features, mirrors, ints, offs, kw = ops
    p = jax.tree_util.tree_map(jnp.asarray, params)
    x, scale, fq = jnp.asarray(features), None, None
    if feat_quant:
        x, scale = jax_quantize(x, feat_quant)
        fq = jnp.asarray(quant_rows(np.asarray(x, np.float32)
                                    if feat_quant == "bfloat16"
                                    else np.asarray(x), ints, kw["pk"])
                         ).astype(x.dtype)
    return p, x, [jnp.asarray(m) for m in mirrors], jnp.asarray(ints), fq, scale


def _jax_tick(key, ops, tier, feat_quant="", compute_dtype=None,
              node_block=64):
    """The JAX package's kernel in interpret mode, once per key."""
    if key not in _CACHE:
        p, x, m, ints, fq, scale = _jax_args(ops, feat_quant)
        offs, kw = ops[4], ops[5]
        if tier == "fused":
            out = pallas_fused_gnn_tick(p, x, *m, ints, rel_offsets=offs,
                                        compute_dtype=compute_dtype,
                                        interpret=True, **kw)
        else:
            hid = ops[0]["embed_b"].shape[0]
            h = [jnp.zeros((x.shape[0], hid), jnp.float32)] * 2
            out = pallas_fused_gnn_tick_dma(
                p, x, *m, ints, *h, rel_offsets=offs, node_block=node_block,
                compute_dtype=compute_dtype, feat_quant=feat_quant,
                fq_rows=fq, feat_scale=scale, interpret=True, **kw)
        _CACHE[key] = [np.asarray(a.astype(jnp.float32)
                                  if a.dtype == jnp.bfloat16 else a)
                       for a in out]
    return _CACHE[key]


def _port_tick(ops, tier, feat_quant="", compute_dtype=None, node_block=64):
    p, x, m, ints, fq, scale = torch_operands(ops, "cpu", feat_quant)
    offs, kw = ops[4], ops[5]
    if tier == "fused":
        out = fused_gnn_tick_plain(p, x, *m, ints, rel_offsets=offs,
                                   compute_dtype=compute_dtype, **kw)
    else:
        hid = ops[0]["embed_b"].shape[0]
        h = [torch.zeros((x.shape[0], hid)) for _ in range(2)]
        out = fused_gnn_tick_dma_plain(
            p, x, *m, ints, *h, rel_offsets=offs, node_block=node_block,
            compute_dtype=compute_dtype, feat_quant=feat_quant, fq_rows=fq,
            feat_scale=scale, **kw)
    return [t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
            for t in out]


def _assert_tick(mine, ref, tol=1e-5, what=""):
    """Mirrors (and the quant table) exactly; logits, probs and the
    activation buffers within ``tol``; argmax equal."""
    assert len(mine) == len(ref), what
    for name, a, b in zip(NAMES, mine, ref):
        if name in MIRRORS or name == "table":
            np.testing.assert_array_equal(a, b.astype(a.dtype),
                                          err_msg=f"{name} {what}")
        else:
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                       err_msg=f"{name} {what}")
    np.testing.assert_array_equal(mine[6].argmax(-1), ref[6].argmax(-1))


@pytest.mark.parametrize("case", ["seed1", "seed2", "all_padding_slices",
                                  "empty_delta"])
def test_fused_plain_equals_jax_fused_kernel(case):
    """Every output of the 8-tuple: mirrors exactly (the repeated entry's
    last value landed, the out-of-range entries dropped), logits and probs
    within rtol/atol 1e-5 with the same argmax."""
    ops = {"seed1": lambda: tick_operands(1),
           "seed2": lambda: tick_operands(2),
           "all_padding_slices": lambda: tick_operands(11, live=(0, 0, 0)),
           "empty_delta": lambda: tick_operands(13, empty=True)}[case]()
    mine = _port_tick(ops, "fused")
    _assert_tick(mine, _jax_tick(("fused", case), ops, "fused"), what=case)
    ints, pk, ek = ops[3], ops[5]["pk"], ops[5]["ek"]
    if case == "seed1":
        # the delta's repeated entries: the later one's value landed
        assert mine[0][ints[1]] == ints[pk + 5]
        slot = ints[3 * pk + 2]
        assert mine[2][slot] == ints[3 * pk + ek + 6]
    if case == "empty_delta":
        for a, b in zip(mine[:6], ops[2]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cdt", [None, "bfloat16"])
@pytest.mark.parametrize("name", sorted(HARD_TICKS))
def test_fused_plain_equals_jax_fused_kernel_on_hard_layouts(name, cdt):
    """The layouts the card's update epilogue is held to (a hub of 600
    edges, rows of in-degree 0, Pn 1000, H 40 / 128 / 72 / 30 with feature
    widths 24 / 48 / 16 / 10): the plain fused tick against the JAX package's
    kernel in interpret mode, mirrors exactly, logits and probs within
    rtol/atol 1e-5 (bf16 operands 0.05) with the same argmax."""
    ops = hard_tick_operands(name)
    mine = _port_tick(ops, "fused", compute_dtype=cdt)
    ref = _jax_tick(("fused", "hard", name, cdt), ops, "fused",
                    compute_dtype=cdt)
    _assert_tick(mine, ref, tol=0.05 if cdt else 1e-5, what=name)


def test_fused_plain_bf16_operands_equal_jax_fused_kernel():
    """compute_dtype="bfloat16": every product's operands rounded to bf16
    with float32 sums, in the port and in JAX alike (probs within the
    bf16 tier's 0.05; both sides round the same values, so they agree far
    closer)."""
    ops = tick_operands(3)
    mine = _port_tick(ops, "fused", compute_dtype="bfloat16")
    ref = _jax_tick(("fused", "bf16"), ops, "fused", compute_dtype="bfloat16")
    _assert_tick(mine, ref, tol=0.05, what="bf16")
    np.testing.assert_allclose(mine[6], ref[6], rtol=1e-3, atol=1e-3)


def test_dma_plain_equals_jax_dma_kernel_and_node_block_invariance():
    """The streamed tick's 10-tuple against JAX's at node block 64, the
    ping-pong activation buffers included; the port's result is the same
    bit for bit at node blocks 32, 64 and 256, and equals the fused
    tick's."""
    ops = tick_operands(1)
    mine = _port_tick(ops, "dma", node_block=64)
    _assert_tick(mine, _jax_tick(("dma", "f32"), ops, "dma"), what="dma")
    for nb in (32, 256):
        other = _port_tick(ops, "dma", node_block=nb)
        for a, b in zip(mine, other):
            np.testing.assert_array_equal(a, b)
    fused = _port_tick(ops, "fused")
    for a, b in zip(mine[:8], fused):
        np.testing.assert_array_equal(a, b)


def _composed_on(ops, table):
    """The JAX package's composed tick (XLA) on a float32 table."""
    params, _, mirrors, ints, offs, kw = ops
    p = jax.tree_util.tree_map(jnp.asarray, params)
    out = _gnn_tick(p, jnp.asarray(table), *[jnp.asarray(m) for m in mirrors],
                    jnp.asarray(ints), rel_offsets=offs, slices_sorted=False,
                    compute_dtype=None, pallas=False, **kw)
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("feat_quant", ["bfloat16", "int8"])
def test_quant_tiers_equal_jax_and_hold_the_tier_tolerance(feat_quant):
    """The quantized streamed tick against JAX's (the quant table with the
    delta rows scattered in, exactly); against the composed tick on the
    dequantized table within 1e-5; and within the tier's tolerance (bf16
    0.05, int8 0.1) of the float32 probs, argmax equal."""
    ops = tick_operands(3)
    mine = _port_tick(ops, "dma", feat_quant=feat_quant)
    ref = _jax_tick(("dma", feat_quant), ops, "dma", feat_quant=feat_quant)
    _assert_tick(mine, ref, what=feat_quant)
    q, scale = quantize_features(torch.from_numpy(ops[1]), feat_quant)
    deq = (q.float() * scale[None, :] if scale is not None else q.float())
    exact = _composed_on(ops, deq.numpy())
    np.testing.assert_allclose(mine[6], exact[6], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mine[7], exact[7], rtol=1e-5, atol=1e-5)
    f32 = _port_tick(ops, "dma")
    assert np.abs(mine[7] - f32[7]).max() < QUANT_TOL[feat_quant]
    np.testing.assert_array_equal(mine[7].argmax(-1), f32[7].argmax(-1))


@pytest.mark.parametrize("feat_quant", ["", "bfloat16", "int8"])
def test_empty_delta_keeps_mirrors_per_tier(feat_quant):
    """A delta of padding only leaves every mirror, and the quant table,
    unchanged under every tier."""
    ops = tick_operands(13, empty=True)
    mine = _port_tick(ops, "dma", feat_quant=feat_quant)
    for a, b in zip(mine[:6], ops[2]):
        np.testing.assert_array_equal(a, b)
    if feat_quant:
        q, _ = quantize_features(torch.from_numpy(ops[1]), feat_quant)
        np.testing.assert_array_equal(mine[10], q.float().numpy())
    assert np.isfinite(mine[7]).all()


def test_quantize_features_equals_jax_with_zero_scale_columns():
    """Per-column absmax int8 and the bf16 downcast equal the JAX
    package's; an all-zero column gets scale 0 and quantizes to exact
    zeros."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((512, DIM))
         * 10.0 ** rng.integers(-3, 3, (512, DIM))).astype(np.float32)
    x[:, 3] = 0.0
    x[:, 17] = 0.0
    q, scale = quantize_features(torch.from_numpy(x), "int8")
    jq, jscale = jax_quantize(jnp.asarray(x), "int8")
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert q.dtype == torch.int8 and scale[3] == 0 and scale[17] == 0
    assert not q[:, 3].any() and not q[:, 17].any()
    assert (q.float() * scale)[:, 3].eq(0).all()
    b, none = quantize_features(torch.from_numpy(x), "bfloat16")
    jb, _ = jax_quantize(jnp.asarray(x), "bfloat16")
    assert none is None and b.dtype == torch.bfloat16
    np.testing.assert_array_equal(b.float().numpy(),
                                  np.asarray(jb.astype(jnp.float32)))
    with pytest.raises(ValueError):
        quantize_features(torch.from_numpy(x), "fp8")


def test_layout_and_tier_checks_raise():
    """Unaligned or empty layouts, a node block that does not divide the
    node count, an unknown tier and missing quant operands raise, on the
    CPU as on the card."""
    ops = tick_operands(5)
    p, x, m, ints, _, _ = torch_operands(ops, "cpu")
    kw = ops[5]
    h = [torch.zeros((x.shape[0], 16)) for _ in range(2)]
    for offs in ((0, 24, 88), (0, 0)):
        with pytest.raises(ValueError, match="EDGE_TILE"):
            fk.fused_gnn_tick(p, x, *m, ints, rel_offsets=offs, **kw)
        with pytest.raises(ValueError, match="EDGE_TILE"):
            fk.fused_gnn_tick_dma(p, x, *m, ints, *h, rel_offsets=offs, **kw)
    bad = [dict(node_block=96), dict(feat_quant="fp8"),
           dict(feat_quant="int8"), dict(feat_quant="bfloat16")]
    for over in bad:
        with pytest.raises(ValueError):
            fk.fused_gnn_tick_dma(p, x, *m, ints, *h, rel_offsets=ops[4],
                                  **kw, **over)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fk.fused_gnn_tick(p, x.to("meta"), *m, ints, rel_offsets=ops[4], **kw)


def test_wrappers_take_the_plain_version_for_cpu_tensors_uncounted():
    ops = tick_operands(2)
    p, x, m, ints, _, _ = torch_operands(ops, "cpu")
    before = (fk.launches, fk.dma_launches)
    out = fk.fused_gnn_tick(p, x, *m, ints, rel_offsets=ops[4], **ops[5])
    assert (fk.launches, fk.dma_launches) == before
    _assert_tick([t.numpy() for t in out], _port_tick(ops, "fused"))


def test_bound_counts_config4_operations_and_the_dma_floor():
    """At config 4's resident shape (Pn 65,536, DIM 48, H 64, L 3, 64,014
    live edges in 102,912 slots, Pi 512, 11 classes) a tick does
    2 (Pn DIM H + L (live H H + Pn H H) + Pi H C) = 3.587e9 float32
    operations: 0.0535 ms at 67 TFLOP/s. The streamed schedule's floor is
    the JAX package's closed form."""
    b = fk.bound(pn=65536, pe=102912, live=64014, dim=DIM, hidden=64,
                 classes=11, num_layers=3, num_rels=9, pk=64, ek=64, pi=512)
    assert b["ops"] == 3_587_194_880
    assert b["ops"] / 67e12 * 1e3 == pytest.approx(0.05354, abs=1e-5)
    assert b["floor_bytes"] == jax_floor(pn=65536, pe=102912, dim=DIM,
                                         hidden=64, num_layers=3, pk=64,
                                         ek=64, pi=512)
    assert 0 < b["bytes"] < b["floor_bytes"]
    for kw in (dict(), dict(feat_bytes=1, quant_delta_bytes=1)):
        assert dma_tick_traffic_floor(
            pn=512, pe=1024, dim=DIM, hidden=16, num_layers=2, pk=64, ek=64,
            pi=8, **kw) == jax_floor(pn=512, pe=1024, dim=DIM, hidden=16,
                                     num_layers=2, pk=64, ek=64, pi=8, **kw)
