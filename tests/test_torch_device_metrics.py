"""The port's ``rca/device_metrics.py`` against the JAX package's and
against the kernel wrappers' bounds: the cost models equal the JAX
functions exactly over a grid of shapes; each kernel term of
``tick_cost`` equals the wrapper's ``bound`` for the same launches on a
small shape with every slot and edge live (so the roofline gauges and
the kernel table count the same work); the probes run and return
positive values on the CPU, with the card-only fields ``None``, and raise
without a card unless the CPU is asked for; ``observability.
device_trace`` on the CPU writes a Chrome trace that names the ops of a
plain ``rules_fold``. The pattern is tests/test_device_metrics.py."""
import json

import numpy as np
import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu.rca import device_metrics as jdm
from kubernetes_aiops_evidence_graph_tpu_torch.config import load_settings
from kubernetes_aiops_evidence_graph_tpu_torch.graph.schema import DIM, EntityKind
from kubernetes_aiops_evidence_graph_tpu_torch.kernels import fused_tick as fk
from kubernetes_aiops_evidence_graph_tpu_torch.kernels import gms, rules_fold
from kubernetes_aiops_evidence_graph_tpu_torch.rca import device_metrics as dm
from kubernetes_aiops_evidence_graph_tpu_torch.rca.gnn import (
    NUM_CLASSES, NUM_RELS)
from tests.test_torch_streaming import PORT_PKG, SMALL, _world

torch.set_num_threads(1)


@pytest.mark.parametrize("pi,width,pair_width,pn,e,hidden", [
    (8, 16, 4, 512, 1024, 64),
    (512, 64, 16, 65536, 287488, 64),
    (128, 128, 256, 4096, 102912, 32),
    (1, 1, 1, 1, 0, 8),
])
def test_cost_models_equal_jax(pi, width, pair_width, pn, e, hidden):
    assert dm.fold_accounting(pi, width, pair_width, DIM) == \
        jdm.fold_accounting(pi, width, pair_width, DIM)
    assert dm.fold_accounting(pi, width, pair_width, DIM, num_conds=3,
                              num_rules=5) == \
        jdm.fold_accounting(pi, width, pair_width, DIM, num_conds=3,
                            num_rules=5)
    for bucketed in (False, True):
        for cb in (4, 2):
            assert dm.gnn_layer_accounting(pn, e, hidden, bucketed, cb) == \
                jdm.gnn_layer_accounting(pn, e, hidden, bucketed, cb)
    cost = dm.fold_accounting(pi, width, pair_width, DIM)
    for per_pass_s, bw, tf in ((1e-5, 3350.0, 67.0), (2.5e-3, 819.0, 197.0),
                               (1.0, 1.0, 0.0)):
        assert dm.roofline_record(cost["bytes"], cost["flops"], per_pass_s,
                                  bw, tf) == \
            jdm.roofline_record(cost["bytes"], cost["flops"], per_pass_s,
                                bw, tf)


def _layout(rng, pn, caps):
    """A relation-bucketed layout with every slot live: ``caps`` slots per
    relation, sources covering min(E, Pn) distinct rows."""
    offs = tuple(int(o) for o in np.concatenate([[0], np.cumsum(caps)]))
    e = offs[-1]
    src = (np.arange(e) % pn).astype(np.int32)
    dst = rng.integers(0, pn, e).astype(np.int32)
    return src, dst, np.ones(e, np.float32), offs


# (entry point, feature quant, compute dtype)
GNN_CASES = {
    "composed_f32": ("streaming.gnn_tick.bucketed", "", None),
    "composed_bf16": ("streaming.gnn_tick.bucketed", "", "bfloat16"),
    "fused": ("streaming.gnn_tick.fused", "", None),
    "dma_f32": ("streaming.gnn_tick.dma", "", None),
    "dma_int8": ("streaming.gnn_tick.dma.int8", "int8", None),
}


@pytest.mark.parametrize("case", ["rules"] + list(GNN_CASES))
def test_tick_cost_kernel_terms_equal_the_wrappers_bounds(case):
    """The B1/B2/B3/B4 terms of ``tick_cost`` on a small shape with every
    slot and edge live are the wrappers' bounds for the launches the tick
    makes (B1 once; B2 once a layer; B3 or B4 once), bytes and
    operations."""
    rng = np.random.default_rng(7)
    pn, pi, pk, ek, hidden, layers = 512, 8, 16, 32, 64, 3
    if case == "rules":
        width, rk = 16, 8
        ev_idx = rng.permutation(pn)[:pi * width].reshape(pi, width)
        ev_cnt = np.full(pi, width, np.int32)
        cost = dm.tick_cost("streaming.rules_tick", pn=pn, pi=pi,
                            width=width, pk=pk, rk=rk)
        assert cost["terms"]["B1"] == (
            rules_fold.bound_bytes(ev_idx.astype(np.int32), ev_cnt),
            pi * width * (DIM + 1))
        assert cost["bytes"] == sum(b for b, _ in cost["terms"].values())
        return
    entry, quant, cdt = GNN_CASES[case]
    src, dst, mask, offs = _layout(rng, pn, [64] * NUM_RELS)
    pe = offs[-1]
    cost = dm.tick_cost(entry, pn=pn, pi=pi, pe=pe, pk=pk, ek=ek,
                        hidden=hidden, layers=layers, compute_dtype=cdt)
    if case.startswith("composed"):
        nbytes, ops = gms.bound(src, mask, offs, hidden, hidden, pn,
                                operand_bytes=2 if cdt else 4)
        assert cost["terms"]["B2"] == (layers * nbytes, layers * ops)
    else:
        b = fk.bound(pn=pn, pe=pe, live=int(mask.sum()), dim=DIM,
                     hidden=hidden, classes=NUM_CLASSES, num_layers=layers,
                     num_rels=NUM_RELS, pk=pk, ek=ek, pi=pi,
                     num_kinds=len(EntityKind), feat_quant=quant,
                     dma=entry.startswith("streaming.gnn_tick.dma"))
        key = "B4" if ".dma" in entry else "B3"
        assert cost["terms"] == {key: (b["bytes"], b["ops"])}
    assert cost["bytes"] == sum(b for b, _ in cost["terms"].values()) > 0
    with pytest.raises(KeyError):
        dm.tick_cost("streaming.gnn_tick", pn=pn)


def test_probes_run_on_the_cpu_and_raise_without_a_card():
    """Anchors and the two slopes on the CPU: positive, the card-only
    fields ``None``; the chained scoring passes' last pass equals one
    dispatch bit for bit; without ``"cpu"`` a probe asks for the card and
    raises here."""
    from kubernetes_aiops_evidence_graph_tpu_torch.graph.snapshot import (
        build_snapshot)
    from kubernetes_aiops_evidence_graph_tpu_torch.rca import gnn
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.cuda_backend import (
        CudaRcaBackend)
    assert dm.measure_hbm_gbps(mib=16, k1=2, k2=8, device="cpu") > 0.0
    assert dm.measure_matmul_tflops(n=64, k1=2, k2=6, device="cpu") > 0.0
    assert dm.measure_fetch_rtt_ms(device="cpu") > 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dm.measure_hbm_gbps(mib=1)
    cfg = load_settings(**SMALL)
    cluster, builder, _ = _world(PORT_PKG, cfg, num_pods=100)
    snap = build_snapshot(builder.store, cfg, now_s=cluster.now.timestamp())
    backend = CudaRcaBackend("cpu")
    batch, args = backend.prepared(snap), backend.device_arrays(snap)
    rec = dm.measure_scan_per_pass_s(batch, args, k1=2, k2=6, repeats=1)
    assert rec["method"] == "host" and rec["dispatch_s_per_pass"] > 0.0
    assert rec["device_s_per_pass"] is None
    assert rec["overhead_s_per_dispatch"] is None
    last = dm.loop_score(args, batch.pair_width, 5)
    one = backend.dispatch(snap)
    for a, b in zip(last, one):
        assert torch.equal(a, b)
    params = gnn.init_params(torch.Generator().manual_seed(0))
    fwd = dm.measure_gnn_forward_per_pass_s(params, gnn.snapshot_batch(snap),
                                            k1=1, k2=3, repeats=1)
    assert fwd["method"] == "host" and fwd["dispatch_s_per_pass"] > 0.0
    assert fwd["device_s_per_pass"] is None


def test_device_trace_on_the_cpu_names_the_rules_fold_ops(tmp_path):
    from kubernetes_aiops_evidence_graph_tpu_torch import observability
    rng = np.random.default_rng(3)
    pn, pi, width = 256, 8, 16
    feats = torch.from_numpy(rng.random((pn, DIM)).astype(np.float32))
    ev_idx = torch.from_numpy(rng.integers(0, pn, (pi, width)).astype(np.int32))
    ev_cnt = torch.full((pi,), width, dtype=torch.int32)
    ev_pair = torch.zeros((pi, width), dtype=torch.int32)
    chain = torch.zeros(pi)
    with observability.device_trace(str(tmp_path), device="cpu"):
        rules_fold.rules_fold(feats, ev_idx, ev_cnt, ev_pair, chain, 4)
    doc = json.load(open(tmp_path / "trace.json"))
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"aten::index_select", "aten::gt"} & names
    assert not any(e.get("cat") == "kernel" for e in doc["traceEvents"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            with observability.device_trace(str(tmp_path / "card")):
                pass
