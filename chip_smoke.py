#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``kubernetes_aiops_evidence_graph_tpu_torch`` on the card, both RCA
paths: the rules path (``rca_backend="tpu"``, kernel ``rules_fold``) and
the learned path (``rca_backend="gnn"``, kernel ``gms``, and the serving
tick ``fused_tick`` with its two entry points ``fused_gnn_tick`` and
``fused_gnn_tick_dma`` behind the scorer's fused and streamed tiers):

1. requires CUDA (exits non-zero without it) and prints the card's name
   and power limit as nvidia-smi reports them;
2. builds every kernel from the sources in this checkout (one nvcc per
   source, started together);
3. holds ``rules_fold`` against its plain PyTorch version on the card,
   with exact equality of every output, at edge shapes (W > 256, pair
   width > 64, empty rows, an 8-row batch of threshold edges);
4. config 3, rules: builds a 35,000-pod cluster with 500 concurrent
   incidents (seed 0), scores it with ``CudaRcaBackend.score_snapshot``
   and materializes ``results()``; the kernel must have launched, the
   verdicts must equal the plain version run on a CPU copy, and top-1
   must equal the CPU rules oracle on the 50-incident sample bench.py
   checks (the count of disagreements over all 500 is printed);
5. ``gms`` against its plain version at edge shapes: the config-3 layout
   (its real edge arrays, the shipped layer-0 weights and the real
   layer-0 node table), an unaligned layout, zero-width and all-padding
   slices, E = 0, H != K (48 -> 64), bf16 operands. float32 is held to
   rtol 1e-5 / atol 1e-5, bf16 to 0.05, of the plain version on a CPU copy
   of the inputs (which sums in the kernel's order; the plain version on
   the card sums with atomics, and its difference is printed); two
   launches on the same inputs must be ``torch.equal``;
6. config 3, learned: ``GnnRcaBackend`` with the shipped weights on the
   same snapshot, ``results()`` for every incident; ``gms`` must have
   launched L = 3 times; the logits must be within rtol 1e-5 / atol 1e-5
   of the same forward with the plain message pass on the card, and the
   argmax equal wherever the plain version's top two logits differ by
   more than 1e-4 (the rest are counted); the GNN's top-1 agreement with
   the CPU rules oracle is printed for information;
7. both ``fused_tick`` entry points against their plain versions on a
   CPU copy, with the shipped weights: repeated and out-of-range delta
   entries with zero-width and all-padding slices, every slice padding,
   an empty delta; float32, bf16 operands, node blocks 64 and 2048 (equal
   bit for bit), bf16 and int8 feature tables. Mirrors equal; logits,
   probs and activations within rtol 1e-5 / atol 1e-5 (bf16 operands
   0.05) with equal argmax; a quant table also within 1e-5 of the
   composed forward on the dequantized table and within 0.05 (bf16) / 0.1
   (int8) of the float32 table's probs; two launches ``torch.equal``;
8. config 4: 2,000 full-mix churn events on a 10,000-pod cluster with
   100 incidents, one ``dispatch()`` per 100-event tick and one
   ``rescore()`` at the end (bench.py's streaming loop), through the
   rules path and through the learned path once per tier (composed,
   fused, streamed, streamed on the int8 table; settings
   ``gnn_fused_tick`` / ``gnn_tick_dma`` / ``gnn_feature_quant``); the
   incremental state must equal a fresh scorer rebuilt from the same
   store (rules: every output exactly; learned: top-1, probs within
   rtol 1e-4 / atol 1e-5), the tier's kernel must have launched once a
   tick, and the kernels must equal their plain versions on the resident
   state (config 4's resident shape, Pn 65,536) after the first tick and
   after the churn, as in 7; each tier's tick is then timed beside the
   composed tick at the same shape; the rules run adds 500 events
   through ``tick_async`` + ``serve(newest=True)``;
9. prints one ``{"kernels": [...]}`` line with each kernel's launches on
   the main paths, its time, the plain version's time and its bound, then
   the nvidia-smi line, then ``{"ok": true, "device": {...}}`` last.

Any failed phase raises and the script exits non-zero. A kernel's ``ms``
is its device time per call from the profiler's CUDA activity;
``ms_per_call`` is CUDA-event time over back-to-back calls, host launch
cost included. Every kernel count is set to 0 just before a path runs and
read just after; launches made to compare a kernel with its plain version
are not counted.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def assert_equal_outputs(got, want, what: str) -> float:
    """Raise unless the seven outputs are equal, bit for bit; returns the
    largest absolute difference of the float outputs (0.0 when equal)."""
    import torch
    names = ("conds", "matched", "scores", "top_idx", "any_match",
             "top_conf", "top_score")
    err = 0.0
    for name, a, b in zip(names, got, want):
        a, b = a.cpu(), b.cpu()
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{what}: {name} has {a.dtype}{list(a.shape)}"
                                 f", the plain version {b.dtype}{list(b.shape)}")
        if a.is_floating_point():
            err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
        if not torch.equal(a, b):
            bad = (a != b).nonzero()[:5].tolist()
            raise AssertionError(f"{what}: {name} differs from the plain "
                                 f"version (first rows {bad})")
    return err


def random_batch(rng, pn: int, pi: int, width: int, pair_width: int, dev):
    """Integer-valued features (sums are exact in any order), random live
    counts with every fifth row empty, pair ids including the sentinel."""
    import torch
    from kubernetes_aiops_evidence_graph_tpu_torch.graph.schema import DIM, F
    features = ((rng.random((pn, DIM)) < 0.15)
                * rng.integers(1, 4, (pn, DIM))).astype(np.float32)
    features[:, F.POD_PROBLEM] = rng.random(pn) < 0.5
    ev_cnt = rng.integers(0, width + 1, pi).astype(np.int32)
    ev_cnt[::5] = 0
    ev_idx = rng.integers(0, pn, (pi, width)).astype(np.int32)
    ev_pair = rng.integers(0, pair_width + 1, (pi, width)).astype(np.int32)
    chain = np.zeros(pi, np.float32)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (features, ev_idx, ev_cnt, ev_pair, chain))


def edge_batch(dev):
    """8 rows at the rules' thresholds (the cases of the JAX package's
    synthetic-edge test), one feature row per evidence slot."""
    import torch
    from kubernetes_aiops_evidence_graph_tpu_torch.graph.schema import DIM, F
    rows = [
        [{F.W_CRASHLOOPBACKOFF: 2, F.HAS_RECENT_DEPLOY: 1}],
        [{F.W_CRASHLOOPBACKOFF: 1}],
        [],
        [{F.LOG_NETWORK: 5, F.NETWORK_ERROR_COUNT: 9}],
        [{F.LOG_CONNECTION: 1, F.NETWORK_ERROR_COUNT: 10}],
        [{F.NODE_NOT_READY: 1}, {F.POD_PROBLEM: 1}],
        [{F.NODE_NOT_READY: 1}, {F.POD_PROBLEM: 1}, {F.POD_PROBLEM: 1}],
        [],
    ]
    width, pair_width = 16, 4
    feats, ev_idx = [np.zeros(DIM, np.float32)], np.zeros((8, width), np.int32)
    ev_cnt = np.zeros(8, np.int32)
    ev_pair = np.full((8, width), pair_width, np.int32)
    for i, slots in enumerate(rows):
        for w, cols in enumerate(slots):
            f = np.zeros(DIM, np.float32)
            for c, v in cols.items():
                f[c] = v
            ev_idx[i, w] = len(feats)
            feats.append(f)
            if F.POD_PROBLEM in cols:
                ev_pair[i, w] = 0       # every problem pod on one node
        ev_cnt[i] = len(slots)
    arrays = (np.stack(feats), ev_idx, ev_cnt, ev_pair, np.zeros(8, np.float32))
    return tuple(torch.from_numpy(a).to(dev) for a in arrays), pair_width


def build_world(num_pods: int, num_incidents: int, seed: int = 0):
    """The config-3 world of the JAX package's benchmark, through the port."""
    from kubernetes_aiops_evidence_graph_tpu_torch.collectors import (
        collect_all, default_collectors)
    from kubernetes_aiops_evidence_graph_tpu_torch.config import load_settings
    from kubernetes_aiops_evidence_graph_tpu_torch.graph import (
        GraphBuilder, build_snapshot)
    from kubernetes_aiops_evidence_graph_tpu_torch.graph.topology_sync import (
        sync_topology)
    from kubernetes_aiops_evidence_graph_tpu_torch.simulator import (
        SCENARIOS, generate_cluster, inject)

    settings = load_settings()
    cluster = generate_cluster(num_pods=num_pods, seed=seed)
    rng = np.random.default_rng(seed)
    deploy_keys = sorted(cluster.deployments)
    scenario_names = sorted(SCENARIOS)
    builder = GraphBuilder()
    sync_topology(cluster, builder.store)
    incidents = []
    stride = max(1, len(deploy_keys) // max(num_incidents, 1))
    for i in range(num_incidents):
        name = scenario_names[i % len(scenario_names)]
        target = deploy_keys[(i * stride) % len(deploy_keys)]
        incidents.append(inject(cluster, name, target, rng))
    evidence = {}
    for inc in incidents:
        results = collect_all(inc, default_collectors(cluster, settings),
                              parallel=False)
        builder.ingest(inc, results)
        evidence[inc.id] = [ev.model_dump(mode="json")
                            for r in results for ev in r.evidence]
    snapshot = build_snapshot(builder.store, settings,
                              now_s=cluster.now.timestamp())
    return incidents, evidence, snapshot


def device_ms(fn, iters: int = 20, by_kernel: bool = False):
    """Mean device-busy time of ``fn`` in ms, from the profiler's CUDA
    activity (CUPTI): the sum of the kernels' and copies' own device time
    over ``iters`` calls. 0.0 when the profiler saw no device activity.
    With ``by_kernel``, a dict of that time per kernel name instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per = {e.key: e.self_device_time_total / iters / 1e3
           for e in prof.key_averages() if e.self_device_time_total > 0}
    return per if by_kernel else sum(per.values())


def timed(kernel, plain, plain_iters: int = 10) -> dict:
    """A kernel and its plain version on the same inputs: device time per
    call (profiler; CUDA events over back-to-back calls where the profiler
    saw nothing) and time per call as the stream sees it (CUDA events,
    host launch cost included)."""
    t = {"ms_per_call": cuda_ms(kernel),
         "plain_ms_per_call": cuda_ms(plain, iters=plain_iters, warmup=2)}
    t["ms"], t["plain_ms"] = device_ms(kernel), device_ms(plain, iters=plain_iters)
    t["timed_by"] = "profiler"
    if t["ms"] <= 0.0 or t["plain_ms"] <= 0.0:
        t["ms"], t["plain_ms"] = t["ms_per_call"], t["plain_ms_per_call"]
        t["timed_by"] = "cuda events"
    return t


def bound_of(nbytes: int, ops: int, flop_per_s: float = F32_FLOP_PER_S
             ) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / flop_per_s * 1e3
    return {"bound_bytes": nbytes, "bound_ops": ops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def kernel_timing(args, pair_width: int) -> dict:
    """rules_fold and its plain version on these inputs (see ``timed``),
    and the bound of these inputs."""
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import rules_fold as rf
    t = timed(lambda: rf.rules_fold(*args, pair_width),
              lambda: rf.rules_fold_reference(*args, pair_width))
    ev_idx, ev_cnt = args[1].cpu().numpy(), args[2].cpu().numpy()
    # one add per gathered value, and one per live slot into the histogram
    live = int(np.minimum(ev_cnt, ev_idx.shape[1]).clip(0).sum())
    t.update(bound_of(rf.bound_bytes(ev_idx, ev_cnt),
                      live * (args[0].shape[1] + 1)))
    return t


# -- gms: the learned path's message pass -----------------------------------

@contextlib.contextmanager
def kept_counts():
    """Launches inside are comparisons, not the path's: restore the
    counts afterwards."""
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import fused_tick as fk
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import gms
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import rules_fold as rf
    saved = gms.launches, rf.launches, fk.launches, fk.dma_launches
    try:
        yield
    finally:
        gms.launches, rf.launches, fk.launches, fk.dma_launches = saved


def reset_counts() -> None:
    """Every kernel's launch count to 0, just before a path runs."""
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import fused_tick as fk
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import gms
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import rules_fold as rf
    gms.launches = rf.launches = fk.launches = fk.dma_launches = 0


def read_counts() -> dict:
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import fused_tick as fk
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import gms
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import rules_fold as rf
    return {"rules_fold": rf.launches, "gms": gms.launches,
            "fused_tick": fk.launches, "fused_tick_dma": fk.dma_launches}


@contextlib.contextmanager
def plain_message_pass():
    """Run ``gnn.forward`` with the plain version of the message pass on
    the card (the comparison path): the forward calls
    ``kernels.gms.gather_matmul_segment`` by module attribute."""
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import gms
    kernel = gms.gather_matmul_segment

    def plain(*args, plan=None, **kw):
        return gms.gather_matmul_segment_reference(*args, **kw)
    gms.gather_matmul_segment = plain
    try:
        yield
    finally:
        gms.gather_matmul_segment = kernel


def node_table(params, features, kind, nmask):
    """The layer-0 input of the forward: the embedded node table."""
    import torch
    h = torch.relu(features @ params["embed_w"] + params["embed_b"]
                   + params["kind_emb"][kind.long()])
    return h * nmask[:, None]


def gms_check(args: tuple, offs, n: int, what: str, compute_dtype=None
              ) -> float:
    """Hold gms against its plain version: two launches equal bit for bit,
    and the result within rtol 1e-5 / atol 1e-5 (float32; bf16 operands
    0.05) of the plain version on a CPU copy of the same inputs, which
    adds each destination's messages in ascending edge index as the
    kernel does. The plain version on the card adds them with atomics in
    no fixed order; its difference is logged, not held. Returns the
    largest absolute difference from the CPU copy's."""
    import torch
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import gms
    with kept_counts():
        got = gms.gather_matmul_segment(*args, offs, n,
                                        compute_dtype=compute_dtype)
        again = gms.gather_matmul_segment(*args, offs, n,
                                          compute_dtype=compute_dtype)
        torch.cuda.synchronize()
    on_card = gms.gather_matmul_segment_reference(
        *args, offs, n, compute_dtype=compute_dtype).cpu()
    want = gms.gather_matmul_segment_reference(
        *(a.cpu() for a in args), offs, n, compute_dtype=compute_dtype)
    got = got.cpu()
    if not torch.equal(got, again.cpu()):
        raise AssertionError(f"gms {what}: two launches differ")
    tol = 0.05 if compute_dtype else 1e-5
    if got.shape != want.shape or not torch.allclose(got, want, rtol=tol,
                                                     atol=tol):
        raise AssertionError(f"gms {what}: differs from the plain version "
                             f"(max |d| {float((got - want).abs().max())})")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    card = float((got - on_card).abs().max()) if got.numel() else 0.0
    log(f"gms == plain: {what} (N={n} H={args[0].shape[1]} "
        f"K={args[1].shape[-1]} E={args[2].shape[0]} offsets={len(offs)}; "
        f"max |d| {err:.3g}, {card:.3g} from the plain version on the card)")
    return err


def synthetic_layout(rng, caps, live, n, h, k, dev, sort_dst=True):
    """A random relation-bucketed layout: live prefix per slice, padding
    dst pinned to the last row, mask 0."""
    import torch
    offs = (0,) + tuple(int(c) for c in np.cumsum(caps))
    pe = offs[-1]
    src = rng.integers(0, n, pe).astype(np.int32)
    dst = np.full(pe, n - 1, np.int32)
    mask = np.zeros(pe, np.float32)
    for r, c in enumerate(live):
        d = rng.integers(0, n, c).astype(np.int32)
        dst[offs[r]:offs[r] + c] = np.sort(d) if sort_dst else d
        mask[offs[r]:offs[r] + c] = 1.0
    hmat = rng.standard_normal((n, h)).astype(np.float32)
    w_rel = (rng.standard_normal((len(caps), h, k)) / np.sqrt(h)
             ).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (hmat, w_rel, src, dst, mask)), offs, n


def gms_edge_cases(dev) -> float:
    rng = np.random.default_rng(1)
    cases = {
        "unaligned slices": ((5, 0, 17, 70, 1, 3, 200, 64, 9),
                             (5, 0, 9, 70, 1, 0, 150, 64, 9), 700, 64, 64,
                             False),
        "zero-width and all-padding slices": ((0, 64, 0, 128, 0, 0, 64, 0, 0),
                                              (0, 0, 0, 0, 0, 0, 0, 0, 0),
                                              500, 64, 64, True),
        "E = 0": ((0,) * 9, (0,) * 9, 300, 64, 64, True),
        "H != K (48 -> 64)": ((64, 128, 64), (60, 100, 64), 900, 48, 64,
                              False),
    }
    err = 0.0
    for what, (caps, live, n, h, k, srt) in cases.items():
        args, offs, n = synthetic_layout(rng, caps, live, n, h, k, dev, srt)
        err = max(err, gms_check(args, offs, n, what))
    return err


def gms_args_from(params, features, kind, nmask, esrc, edst, emask):
    """(h, w_rel, src, dst, mask) of a real layout: the layer-0 node table
    and the shipped layer-0 weights."""
    h = node_table(params, features, kind, nmask)
    return (h, params["layers"][0]["w_rel"], esrc, edst, emask)


def gms_timing(args: tuple, offs, n: int) -> dict:
    """gms (with its dst-CSR built once, as a forward does) and its plain
    version on these inputs, the CSR build on its own, and the bound."""
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import gms
    with kept_counts():
        plan = gms.make_plan(args[3], args[4], offs, n)
        t = timed(lambda: gms.gather_matmul_segment(*args, offs, n, plan=plan),
                  lambda: gms.gather_matmul_segment_reference(*args, offs, n))
        t["plan_ms"] = device_ms(lambda: gms.make_plan(args[3], args[4],
                                                       offs, n))
        t["ms_by_kernel"] = {
            (re.findall(r"\w+_kernel", name) or [name])[0]: ms
            for name, ms in device_ms(
                lambda: gms.gather_matmul_segment(*args, offs, n, plan=plan),
                by_kernel=True).items()}
    hid, k_out = args[0].shape[1], args[1].shape[-1]
    nbytes, ops = gms.bound(args[2].cpu().numpy(), args[4].cpu().numpy(),
                            offs, hid, k_out, n)
    t.update(bound_of(nbytes, ops))
    t["live_edges"] = ops // (2 * hid * k_out)
    t["padded_edges"] = int(offs[-1])
    return t


def run_learned_config3(snapshot, oracle: dict, dev) -> dict:
    """Config 3 through the learned path: GnnRcaBackend with the shipped
    weights, results() for every incident, gms launched L times; logits
    against the plain message pass on the card; kernel vs plain at the
    config-3 layout (f32 and bf16) and timed there. ``oracle`` maps each
    incident node id to the CPU rules oracle's top-1 rule."""
    import torch
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import gms
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import rules_fold as rf
    from kubernetes_aiops_evidence_graph_tpu_torch.rca import gnn
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.gnn_backend import (
        GnnRcaBackend)

    backend = GnnRcaBackend()
    layers = len(backend.params["layers"])
    reset_counts()
    t0 = time.perf_counter()
    raw = backend.score_snapshot(snapshot)
    results = backend.results(raw=raw)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = gms.launches
    if launches != layers:
        raise AssertionError(f"config 3 learned: {launches} gms launches, "
                             f"expected {layers} (one per layer)")
    if len(results) != snapshot.num_incidents:
        raise AssertionError("config 3 learned: results() lost incidents")
    if not np.isfinite(raw["probs"]).all():
        raise AssertionError("config 3 learned: non-finite probs")

    batch = gnn.snapshot_batch(snapshot)
    with kept_counts():
        logits = gnn.forward_batch(backend.params, batch)
        with plain_message_pass():
            plain = gnn.forward_batch(backend.params, batch)
        torch.cuda.synchronize()
    n = snapshot.num_incidents
    logits, plain = logits[:n].cpu(), plain[:n].cpu()
    logit_err = float((logits - plain).abs().max())
    if not torch.allclose(logits, plain, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"config 3 learned: logits differ from the "
                             f"plain path by {logit_err}")
    top2 = plain.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4
    if not torch.equal(logits.argmax(-1)[clear], plain.argmax(-1)[clear]):
        raise AssertionError("config 3 learned: argmax differs from the "
                             "plain path")
    near_ties = int((~clear).sum())

    row_of = {nid: i for i, nid in enumerate(raw["incident_ids"])}
    agree = sum(results[row_of[nid]].top_hypothesis.rule_id == rule
                for nid, rule in oracle.items())
    top1 = collections.Counter(r.top_hypothesis.rule_id for r in results)
    log(f"config 3 learned: {launches} gms launches, {n} verdicts, logits "
        f"== plain (max |d| {logit_err:.3g}, {near_ties} near-ties); GNN "
        f"top-1 == CPU rules oracle on {agree}/{len(oracle)}, GNN top-1 "
        f"counts {dict(top1.most_common())}; score_snapshot + results() "
        f"{wall_ms:.1f} ms")

    # the kernel at the config-3 layout, f32 and bf16, then timed
    arrays = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(dev)
              for k in gnn._BATCH_ARRAYS}
    args = gms_args_from(backend.params, arrays["features"],
                         arrays["node_kind"], arrays["node_mask"],
                         arrays["edge_src"], arrays["edge_dst"],
                         arrays["edge_mask"])
    offs, pn = snapshot.rel_offsets, snapshot.padded_nodes
    err = gms_check(args, offs, pn, "config-3 layout")
    gms_check(args, offs, pn, "config-3 layout, bf16 operands",
              compute_dtype="bfloat16")
    timing = gms_timing(args, offs, pn)
    # the whole forward on resident tensors, kernel and plain message pass
    fwd_args = [arrays[k] for k in gnn._BATCH_ARRAYS]
    with kept_counts():
        timing["forward_ms"] = device_ms(
            lambda: gnn.forward(backend.params, *fwd_args, rel_offsets=offs))
        with plain_message_pass():
            timing["forward_plain_ms"] = device_ms(
                lambda: gnn.forward(backend.params, *fwd_args,
                                    rel_offsets=offs), iters=10)
    log(f"config 3 gms timing: {timing}")
    return {"launches": launches, "timing": timing, "max_abs_err": err,
            "logit_max_abs_err": logit_err, "near_ties": near_ties,
            "oracle_agree": agree, "top1_counts": dict(top1),
            "wall_ms": wall_ms}


# -- config 4: streaming ----------------------------------------------------

def same_verdicts(mine: dict, ref: dict, what: str) -> int:
    """Raise unless two raw verdict dicts agree on every output of every
    incident, matched by incident id; returns the incident count."""
    a = {iid: i for i, iid in enumerate(mine["incident_ids"])}
    b = {iid: i for i, iid in enumerate(ref["incident_ids"])}
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: live incident sets differ")
    for k in ("conditions", "matched", "scores", "top_rule_index",
              "any_match", "top_confidence", "top_score"):
        if not np.array_equal(mine[k][[a[i] for i in a]],
                              ref[k][[b[i] for i in a]]):
            raise AssertionError(f"{what}: {k} differs from a fresh rebuild")
    return len(a)


def same_learned_verdicts(mine: dict, ref: dict, what: str,
                          quant_tol: "float | None" = None) -> tuple[int, int]:
    """Top-1 equal and probs within rtol 1e-4 / atol 1e-5 (slot reuse
    orders a destination's sum unlike a fresh layout), by incident id.

    A quantized feature table (``quant_tol``) keeps the scale of its last
    mirror build and quantizes later rows against it, while a fresh
    rebuild derives the scale anew: there probs are held within the tier's
    tolerance, and top-1 wherever the fresh rebuild's top two probs differ
    by more than twice it. Returns (incidents, near-ties not held)."""
    a = {iid: i for i, iid in enumerate(mine["incident_ids"])}
    b = {iid: i for i, iid in enumerate(ref["incident_ids"])}
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: live incident sets differ")
    ia, ib = [a[i] for i in a], [b[i] for i in a]
    p, q = mine["probs"][ia], ref["probs"][ib]
    held = np.ones(len(ia), bool)
    if quant_tol is not None:
        top2 = -np.sort(-q, axis=-1)[:, :2]
        held = top2[:, 0] - top2[:, 1] > 2 * quant_tol
    if not np.array_equal(mine["top_rule_index"][ia][held],
                          ref["top_rule_index"][ib][held]):
        raise AssertionError(f"{what}: top-1 differs from a fresh rebuild")
    ok = (np.abs(p - q).max() < quant_tol if quant_tol is not None
          else np.allclose(p, q, rtol=1e-4, atol=1e-5))
    if not ok:
        raise AssertionError(f"{what}: probs differ from a fresh rebuild "
                             f"(max |d| {float(np.abs(p - q).max())})")
    return len(a), int((~held).sum())


def resident_kernel_check(scorer, what: str) -> tuple[tuple, float]:
    """Hold rules_fold against its plain version on a copy of the scorer's
    resident tensors, as they stand after its last tick. These launches
    are a comparison, not the path's. Returns (the copied arguments, the
    largest float difference)."""
    import torch
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import rules_fold as rf
    torch.cuda.synchronize()
    args = tuple(t.clone() for t in (
        scorer._features_dev, scorer._ev_idx_dev, scorer._ev_cnt_dev,
        scorer._pair_dev, scorer._chain0))
    with kept_counts():
        got = rf.rules_fold(*args, scorer.pair_width)
        torch.cuda.synchronize()
    err = assert_equal_outputs(
        got, rf.rules_fold_reference(*args, scorer.pair_width), what)
    log(f"kernel == plain: {what} (Pn={args[0].shape[0]} "
        f"Pi={args[1].shape[0]} W={scorer.width} Wr={scorer.pair_width})")
    return args, err


def resident_gms_check(scorer, what: str) -> tuple[tuple, float]:
    """Hold gms against its plain version on the GNN scorer's resident
    mirror (its edge arrays and the layer-0 table of its resident
    features), as they stand after its last tick."""
    import torch
    torch.cuda.synchronize()
    args = gms_args_from(scorer._params, scorer._features_dev,
                         scorer._kind_dev, scorer._nmask_dev,
                         scorer._esrc_dev.clone(), scorer._edst_dev.clone(),
                         scorer._emask_dev.clone())
    err = gms_check(args, scorer._rel_offsets,
                    scorer.snapshot.padded_nodes, what)
    return args, err


def streaming_world(num_pods: int, num_incidents: int, seed: int):
    """bench.py's streaming world: (settings, cluster, builder)."""
    from kubernetes_aiops_evidence_graph_tpu_torch.collectors import (
        collect_all, default_collectors)
    from kubernetes_aiops_evidence_graph_tpu_torch.config import load_settings
    from kubernetes_aiops_evidence_graph_tpu_torch.graph import GraphBuilder
    from kubernetes_aiops_evidence_graph_tpu_torch.graph.topology_sync import (
        sync_topology)
    from kubernetes_aiops_evidence_graph_tpu_torch.simulator import (
        SCENARIOS, generate_cluster, inject)

    settings = load_settings()
    cluster = generate_cluster(num_pods=num_pods, seed=seed)
    rng = np.random.default_rng(seed)
    builder = GraphBuilder()
    sync_topology(cluster, builder.store)
    keys = sorted(cluster.deployments)
    names = sorted(SCENARIOS)
    for i in range(num_incidents):
        inc = inject(cluster, names[i % len(names)], keys[(i * 7) % len(keys)], rng)
        builder.ingest(inc, collect_all(inc, default_collectors(cluster, settings),
                                        parallel=False))
    return settings, cluster, builder


def churn_ticks(scorer, cluster, builder, stream, batch_size, check):
    """bench.py's loop: apply each tick's events, dispatch() (timed),
    ``check(scorer)`` once after the first tick (off the clock), one
    rescore() at the end. Returns (final raw, events/s, median dispatch
    ms, ticks)."""
    from kubernetes_aiops_evidence_graph_tpu_torch.simulator.stream import (
        stream_step)
    t0 = time.perf_counter()
    tick_times = []
    check_s = 0.0
    for tick_start in range(0, len(stream), batch_size):
        for ev in stream[tick_start:tick_start + batch_size]:
            stream_step(cluster, builder.store, scorer, ev)
        t1 = time.perf_counter()
        scorer.dispatch()
        tick_times.append(time.perf_counter() - t1)
        if tick_start == 0:
            t1 = time.perf_counter()
            check(scorer)
            check_s = time.perf_counter() - t1
    final = scorer.rescore()
    wall = time.perf_counter() - t0 - check_s
    return (final, len(stream) / wall, statistics.median(tick_times) * 1e3,
            len(tick_times) + 1)


def run_streaming(num_pods: int = 10_000, num_incidents: int = 100,
                  events: int = 2000, batch_size: int = 100, seed: int = 0):
    """Config 4, rules, as the JAX package's streaming benchmark runs it:
    returns (events/s, median dispatch ms, kernel launches, ticks, resident
    shape, kernel_timing at the resident shape, the largest float
    difference of the kernel from its plain version on the resident
    tensors)."""
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import gms
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import rules_fold as rf
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.streaming import (
        StreamingScorer)
    from kubernetes_aiops_evidence_graph_tpu_torch.simulator.stream import (
        churn_events, stream_step)

    settings, cluster, builder = streaming_world(num_pods, num_incidents, seed)
    scorer = StreamingScorer(builder.store, settings)
    scorer.rescore()
    stream = list(churn_events(
        cluster, events, seed=seed + 1,
        incident_ids=tuple(builder.store.incident_ids())))

    errs = []
    reset_counts()
    inc_res, eps, tick_ms, ticks = churn_ticks(
        scorer, cluster, builder, stream, batch_size,
        lambda s: errs.append(resident_kernel_check(
            s, "config 4 resident tensors after the first tick")[1]))
    launches = rf.launches
    if launches < ticks:
        raise AssertionError(f"config 4: {launches} launches for {ticks} ticks")

    fresh = StreamingScorer(builder.store, settings).rescore()
    n_live = same_verdicts(inc_res, fresh, "config 4")
    log(f"config 4: {len(stream)} events, {ticks} ticks, rebuilds="
        f"{scorer.rebuilds}, final state == fresh rebuild on {n_live} "
        f"incidents")

    # the pipelined serving path on the card: tick_async every 50 events
    # (bounded in-flight queue, CUDA events), then serve(newest=True)
    # fetches the newest in-flight tick without a fresh dispatch
    more = list(churn_events(
        cluster, 500, seed=seed + 2,
        incident_ids=tuple(builder.store.incident_ids())))
    for i, ev in enumerate(more):
        stream_step(cluster, builder.store, scorer, ev)
        if (i + 1) % 50 == 0:
            scorer.tick_async()
    scorer.sync()
    scorer.tick_async()
    served = scorer.serve(newest=True)
    if not served["newest_fetch"]:
        raise AssertionError("serve(newest=True) dispatched a fresh tick")
    same_verdicts(served, StreamingScorer(builder.store, settings).rescore(),
                  "config 4 pipelined")
    log(f"config 4: pipelined ticks + serve(newest=True) == fresh rebuild "
        f"(coalesced {scorer.coalesced_ticks}, deferred "
        f"{scorer.deferred_fetches})")

    # kernel against its plain version, then both timed, on a copy of the
    # resident tensors at the end of the churn
    args, err = resident_kernel_check(
        scorer, "config 4 resident tensors after the churn")
    shape = {"Pn": int(args[0].shape[0]), "Pi": int(args[1].shape[0]),
             "W": scorer.width, "Wr": scorer.pair_width,
             "live_slots": int(args[2].sum())}
    timing = kernel_timing(args, scorer.pair_width)
    log(f"config 4 timing: {timing}")
    return (eps, tick_ms, launches, ticks, shape, timing,
            max(errs + [err]))


# -- fused_tick: the learned path's serving tick ----------------------------

# the scorer's tiers under test (settings overrides) and the entry point
# each one serves through
LEARNED_TIERS = {
    "composed": {},
    "fused": {"gnn_fused_tick": True},
    "dma": {"gnn_tick_dma": True},
    "dma_int8": {"gnn_tick_dma": True, "gnn_feature_quant": "int8"},
}
# kernel checks: entry point, compute dtype, node block, feature table
CHECKS = {
    "fused": ("fused", None, 64, ""),
    "fused_bf16_compute": ("fused", "bfloat16", 64, ""),
    "dma_nb64": ("dma", None, 64, ""),
    "dma_nb2048": ("dma", None, 2048, ""),
    "dma_bf16_table": ("dma", None, 2048, "bfloat16"),
    "dma_int8_table": ("dma", None, 2048, "int8"),
}
QUANT_TOL = {"bfloat16": 0.05, "int8": 0.1}


def shipped_params(dev):
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.gnn_backend import (
        GnnRcaBackend)
    return GnnRcaBackend(device=dev).params


def params_to(params, dev):
    from kubernetes_aiops_evidence_graph_tpu_torch.rca import gnn
    return gnn.unflat_params({k: v.to(dev) for k, v in
                              gnn.flat_params(params).items()})


def make_delta(rng, pn: int, offs, pk: int, ek: int, inc_nodes, inc_mask,
               empty: bool = False) -> np.ndarray:
    """A packed GNN delta (the layout of rca/gnn_streaming._gnn_tick):
    live aux and edge entries with a repeated index (the later entry must
    win) and an out-of-range index between them (dropped), then padding;
    ``empty``: padding only."""
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.gnn import NUM_KINDS
    pe, pi = int(offs[-1]), len(inc_nodes)
    ints = np.zeros(3 * pk + 5 * ek + 2 * pi, np.int32)
    ints[:pk] = pn
    o = 3 * pk
    ints[o:o + ek] = pe
    if not empty:
        na, ne = 9, 8
        ints[:na] = rng.choice(pn, na, replace=False)
        ints[5], ints[3] = ints[1], pn + 7
        ints[pk:pk + na] = rng.integers(0, NUM_KINDS, na)
        ints[2 * pk:2 * pk + na] = rng.integers(0, 2, na)
        ints[2 * pk + 5] = 1 - ints[2 * pk + 1]
        slots = rng.choice(pe, ne, replace=False)
        ints[o:o + ne] = slots
        ints[o + 6], ints[o + 4] = ints[o + 2], pe + 3
        ints[o + ek:o + ek + ne] = rng.integers(0, pn, ne)
        ints[o + 2 * ek:o + 2 * ek + ne] = rng.integers(0, pn, ne)
        ints[o + 3 * ek:o + 3 * ek + ne] = np.searchsorted(
            np.asarray(offs), slots, side="right") - 1
        ints[o + 4 * ek:o + 4 * ek + ne] = rng.integers(0, 2, ne)
        ints[o + 4 * ek + 6] = 1
    io = 3 * pk + 5 * ek
    ints[io:io + pi] = inc_nodes
    ints[io + pi:io + 2 * pi] = inc_mask
    return ints


def tick_state(rng, params, pn: int, caps, live, pi: int = 64,
               empty: bool = False) -> dict:
    """A synthetic tick at the shipped widths: a relation-bucketed mirror
    (per slice a dst-sorted live prefix, then padding with dst pinned to
    the last row and mask 0) and a packed delta, on the CPU."""
    import torch
    from kubernetes_aiops_evidence_graph_tpu_torch.graph.schema import DIM
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.gnn import NUM_KINDS
    offs = (0,) + tuple(int(c) for c in np.cumsum(caps))
    pe = offs[-1]
    esrc = rng.integers(0, pn, pe).astype(np.int32)
    edst = np.full(pe, pn - 1, np.int32)
    erel = np.full(pe, -1, np.int32)
    emask = np.zeros(pe, np.float32)
    for r, c in enumerate(live):
        edst[offs[r]:offs[r] + c] = np.sort(rng.integers(0, pn, c))
        erel[offs[r]:offs[r] + c] = r
        emask[offs[r]:offs[r] + c] = 1.0
    mirrors = (rng.integers(0, NUM_KINDS, pn).astype(np.int32),
               (rng.random(pn) > 0.1).astype(np.float32), esrc, edst, erel,
               emask)
    ints = make_delta(rng, pn, offs, 64, 64, rng.integers(0, pn, pi),
                      rng.random(pi) > 0.25, empty)
    t = torch.from_numpy
    return {"params": params_to(params, "cpu"),
            "features": t(rng.standard_normal((pn, DIM)).astype(np.float32)),
            "mirrors": [t(m) for m in mirrors], "ints": t(ints),
            "offs": offs, "pk": 64, "ek": 64, "pi": pi}


def resident_state(scorer, rng, empty: bool = False) -> dict:
    """A CPU copy of the GNN scorer's resident state as it stands after
    its last tick, with a packed delta of the scorer's incident tables."""
    import torch
    torch.cuda.synchronize()
    snap = scorer.snapshot
    ints = make_delta(rng, snap.padded_nodes, scorer._rel_offsets, 64, 64,
                      snap.incident_nodes, snap.incident_mask, empty)
    return {"params": params_to(scorer._params, "cpu"),
            "features": scorer._features_dev.cpu(),
            "mirrors": [t.cpu() for t in (
                scorer._kind_dev, scorer._nmask_dev, scorer._esrc_dev,
                scorer._edst_dev, scorer._erel_dev, scorer._emask_dev)],
            "ints": torch.from_numpy(ints), "offs": tuple(scorer._rel_offsets),
            "pk": 64, "ek": 64, "pi": snap.padded_incidents}


def tick_operands(state: dict, check: str, dev) -> tuple:
    """(callable, arguments) of one tick of ``check`` on a fresh copy of
    ``state`` on ``dev``: the wrapper (kernel on the card, plain version on
    the CPU), or with ``plain=True`` the plain version on any device."""
    import torch
    from kubernetes_aiops_evidence_graph_tpu_torch.ops.fused_tick import (
        quantize_features)
    entry, cdt, nb, quant = CHECKS[check]
    p = params_to(state["params"], dev)
    m = [t.clone().to(dev) for t in state["mirrors"]]
    ints = state["ints"].to(dev)
    kw = dict(pk=state["pk"], ek=state["ek"], pi=state["pi"],
              rel_offsets=state["offs"], compute_dtype=cdt)
    if entry == "fused":
        return (p, state["features"].to(dev), *m, ints), kw
    pn = state["features"].shape[0]
    hid = p["embed_b"].shape[0]
    h = [torch.zeros((pn, hid), device=dev) for _ in range(2)]
    kw["node_block"] = nb
    if not quant:
        return (p, state["features"].to(dev), *m, ints, *h), kw
    table, scale = quantize_features(state["features"], quant)
    f_idx = state["ints"][:state["pk"]].long()
    fq = torch.zeros((state["pk"], table.shape[1]), dtype=table.dtype)
    ok = f_idx < pn
    fq[ok] = table[f_idx[ok]]
    kw.update(feat_quant=quant, fq_rows=fq.to(dev),
              feat_scale=None if scale is None else scale.to(dev))
    return (p, table.to(dev), *m, ints, *h), kw


def run_check(state: dict, check: str, dev, plain: bool = False) -> list:
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import fused_tick as fk
    from kubernetes_aiops_evidence_graph_tpu_torch.ops import fused_tick as ft
    args, kw = tick_operands(state, check, dev)
    if CHECKS[check][0] == "fused":
        fn = ft.fused_gnn_tick_plain if plain else fk.fused_gnn_tick
    else:
        fn = ft.fused_gnn_tick_dma_plain if plain else fk.fused_gnn_tick_dma
    return [t.cpu() for t in fn(*args, **kw)]


def composed_on(state: dict, out: list, table=None, scale=None):
    """The composed forward (rca/gnn.forward, the plain message pass) on the
    CPU over a tick's scattered mirrors ``out[:6]`` and a float32 feature
    table: (logits, probs)."""
    import torch
    from kubernetes_aiops_evidence_graph_tpu_torch.ops.fused_tick import (
        dequantize)
    from kubernetes_aiops_evidence_graph_tpu_torch.rca import gnn
    pk, ek, pi = state["pk"], state["ek"], state["pi"]
    io = 3 * pk + 5 * ek
    x = state["features"] if table is None else dequantize(table, scale)
    logits = gnn.forward(state["params"], x, *out[:6],
                         state["ints"][io:io + pi], rel_offsets=state["offs"])
    mask = state["ints"][io + pi:io + 2 * pi].float()
    return logits, torch.softmax(logits, dim=-1) * mask[:, None]


def fused_check(state: dict, check: str, what: str, dev) -> float:
    """Hold one entry point of fused_tick against its plain version on a CPU
    copy of the same state: two launches equal bit for bit; the mirrors
    (and a quant table) equal; logits, probs and the activation buffers
    within rtol 1e-5 / atol 1e-5 (bf16 operands: 0.05) with equal argmax.
    A quant table also within 1e-5 of the composed forward on the
    dequantized table, and its probs within 0.05 (bf16) / 0.1 (int8) of
    the float32 table's. Returns the largest logits/probs difference."""
    import torch
    from kubernetes_aiops_evidence_graph_tpu_torch.ops.fused_tick import (
        quantize_features)
    with kept_counts():
        got = run_check(state, check, dev)
        again = run_check(state, check, dev)
        torch.cuda.synchronize()
        want = run_check(state, check, "cpu")
    for a, b in zip(got, again):
        if not torch.equal(a, b):
            raise AssertionError(f"fused_tick {check} {what}: two launches "
                                 "differ")
    tol = 0.05 if CHECKS[check][1] else 1e-5
    names = ("kind", "nmask", "esrc", "edst", "erel", "emask", "logits",
             "probs", "h_a", "h_b", "table")
    err = 0.0
    for name, a, b in zip(names, got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"fused_tick {check} {what}: {name} is "
                                 f"{a.dtype}{list(a.shape)}, the plain "
                                 f"version's {b.dtype}{list(b.shape)}")
        if name in names[:6] or name == "table":
            ok = torch.equal(a, b)
        else:
            ok = torch.allclose(a, b, rtol=tol, atol=tol)
            if name in ("logits", "probs"):
                err = max(err, float((a - b).abs().max()))
        if not ok:
            raise AssertionError(f"fused_tick {check} {what}: {name} differs "
                                 "from the plain version (max |d| "
                                 f"{float((a.float() - b.float()).abs().max())})")
    if not torch.equal(got[6].argmax(-1), want[6].argmax(-1)):
        raise AssertionError(f"fused_tick {check} {what}: argmax differs")
    quant = CHECKS[check][3]
    note = ""
    if quant:
        scale = quantize_features(state["features"], quant)[1]
        with kept_counts():
            logits, probs = composed_on(state, want, got[10], scale)
            f32 = composed_on(state, want)[1]
        d = max(float((got[6] - logits).abs().max()),
                float((got[7] - probs).abs().max()))
        if not (torch.allclose(got[6], logits, rtol=1e-5, atol=1e-5)
                and torch.allclose(got[7], probs, rtol=1e-5, atol=1e-5)):
            raise AssertionError(f"fused_tick {check} {what}: differs from "
                                 f"the composed tick on the dequantized table "
                                 f"by {d}")
        dq = float((got[7] - f32).abs().max())
        if dq >= QUANT_TOL[quant]:
            raise AssertionError(f"fused_tick {check} {what}: probs {dq} "
                                 f"from the float32 table's")
        note = f"; {d:.3g} from composed(dequantized), {dq:.3g} from f32 probs"
    log(f"fused_tick == plain: {check}, {what} (Pn={state['features'].shape[0]} "
        f"Pe={state['offs'][-1]} live={int(state['mirrors'][5].sum())}; "
        f"max |d| {err:.3g}{note})")
    return err


def fused_edge_cases(dev) -> float:
    """Both entry points at edge shapes, with the shipped weights: repeated
    and out-of-range delta entries with zero-width and all-padding slices,
    every slice padding, an empty delta; node blocks 64 and 2048 equal bit
    for bit."""
    import torch
    rng = np.random.default_rng(3)
    params = shipped_params("cpu")
    caps = (256, 128, 64, 0, 192, 64, 128, 0, 64)
    states = {
        "repeated and out-of-range delta entries, zero-width and "
        "all-padding slices": tick_state(
            rng, params, 4096, caps, (200, 128, 10, 0, 150, 0, 100, 0, 64)),
        "every slice padding": tick_state(rng, params, 4096, caps, (0,) * 9),
        "empty delta": tick_state(rng, params, 4096, caps,
                                  (90, 60, 64, 0, 100, 1, 7, 0, 33),
                                  empty=True),
    }
    err = 0.0
    for what, state in states.items():
        for check in CHECKS:
            err = max(err, fused_check(state, check, what, dev))
        with kept_counts():
            a = run_check(state, "dma_nb64", dev)
            b = run_check(state, "dma_nb2048", dev)
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"fused_tick_dma {what}: node blocks 64 and "
                                 "2048 differ")
    return err


def resident_fused_checks(scorer, tier: str, what: str) -> float:
    """Both entry points against their plain versions on a copy of the
    scorer's resident state (config 4's resident shape), with a delta of
    repeated and out-of-range entries: float32 always, the run's quant
    table in its run; after the churn of the int8 run also the bf16 table
    and bf16 operands."""
    rng = np.random.default_rng(7)
    state = resident_state(scorer, rng)
    checks = ["fused", "dma_nb2048"]
    if tier == "dma_int8":
        checks.append("dma_int8_table")
        if "churn" in what:
            checks += ["dma_bf16_table", "fused_bf16_compute"]
    return max(fused_check(state, c, f"config 4 {tier} run, {what}", scorer.device)
               for c in checks)


def tick_timing(scorer, check: str) -> dict:
    """One tick of ``check`` (an empty delta, so ticks repeat on the same
    state) on the scorer's resident state: the kernel chain, its plain
    version on the card, and the composed tick at the same shape (the
    yardstick: no single PyTorch call computes the tick); the bound."""
    from kubernetes_aiops_evidence_graph_tpu_torch.graph.schema import DIM
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import fused_tick as fk
    from kubernetes_aiops_evidence_graph_tpu_torch.ops import fused_tick as ft
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.gnn_streaming import (
        _gnn_tick)
    state = resident_state(scorer, np.random.default_rng(0), empty=True)
    dev = scorer.device
    entry, _, _, quant = CHECKS[check]
    k_args, kw = tick_operands(state, check, dev)
    p_args, _ = tick_operands(state, check, dev)
    c_args, _ = tick_operands(state, "fused", dev)
    kernel = fk.fused_gnn_tick if entry == "fused" else fk.fused_gnn_tick_dma
    plain = (ft.fused_gnn_tick_plain if entry == "fused"
             else ft.fused_gnn_tick_dma_plain)
    pk, ek, pi, offs = state["pk"], state["ek"], state["pi"], state["offs"]
    with kept_counts():
        t = timed(lambda: kernel(*k_args, **kw), lambda: plain(*p_args, **kw))
        t["composed_ms"] = device_ms(lambda: _gnn_tick(
            *c_args, pk, ek, pi, 0, 0, offs, None))
        t["ms_by_kernel"] = {
            (re.findall(r"\w+_kernel", name) or [name])[0]: ms
            for name, ms in device_ms(lambda: kernel(*k_args, **kw),
                                      by_kernel=True).items()}
    p = state["params"]
    live = int((state["mirrors"][5] != 0).sum())
    b = fk.bound(pn=state["features"].shape[0], pe=int(offs[-1]), live=live,
                 dim=DIM, hidden=int(p["embed_b"].shape[0]),
                 classes=int(p["head_b"].shape[0]),
                 num_layers=len(p["layers"]),
                 num_rels=int(p["layers"][0]["w_rel"].shape[0]), pk=pk,
                 ek=ek, pi=pi, feat_quant=quant, dma=entry == "dma")
    t.update(bound_of(b["bytes"], b["ops"]))
    t["floor_bytes"] = b["floor_bytes"]
    t["floor_ms"] = b["floor_bytes"] / HBM_BYTES_PER_S * 1e3
    t["live_edges"] = live
    return t


def run_streaming_learned(tier: str = "composed", num_pods: int = 10_000,
                          num_incidents: int = 100, events: int = 2000,
                          batch_size: int = 100, seed: int = 0) -> dict:
    """Config 4, learned (bench.py's streaming loop with backend="gnn"),
    under one of the scorer's tiers: GnnStreamingScorer with the shipped
    weights; the tier's kernel launched once a tick (composed: gms L times
    a tick); final state == a fresh rebuild; the kernels == plain on the
    resident state after the first tick and after the churn, then timed
    there."""
    import torch
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.gnn_streaming import (
        GnnStreamingScorer)
    from kubernetes_aiops_evidence_graph_tpu_torch.simulator.stream import (
        churn_events)

    settings, cluster, builder = streaming_world(num_pods, num_incidents, seed)
    settings = dataclasses.replace(settings, **LEARNED_TIERS[tier])
    # the replay clock: deploy recency is a feature the GNN reads, so the
    # fresh rebuild must extract it against the same epoch
    now_s = cluster.now.timestamp()
    scorer = GnnStreamingScorer(builder.store, settings, now_s=now_s)
    layers = len(scorer._params["layers"])
    scorer.rescore()
    stream = list(churn_events(
        cluster, events, seed=seed + 1,
        incident_ids=tuple(builder.store.incident_ids())))

    errs = []
    if tier == "composed":
        def check(s):
            errs.append(resident_gms_check(
                s, "config 4 resident mirror after the first tick")[1])
    else:
        def check(s):
            errs.append(resident_fused_checks(s, tier, "after the first tick"))
    reset_counts()
    inc_res, eps, tick_ms, ticks = churn_ticks(
        scorer, cluster, builder, stream, batch_size, check)
    counts = read_counts()
    want = {"composed": {"gms": layers * ticks, "fused_tick": 0,
                         "fused_tick_dma": 0},
            "fused": {"gms": 0, "fused_tick": ticks, "fused_tick_dma": 0}
            }.get(tier, {"gms": 0, "fused_tick": 0, "fused_tick_dma": ticks})
    if any(counts[k] != n for k, n in want.items()) or counts["rules_fold"] < ticks:
        raise AssertionError(f"config 4 learned {tier}: launches {counts} for "
                             f"{ticks} ticks of {layers} layers, expected {want}")
    if not np.isfinite(inc_res["probs"]).all():
        raise AssertionError(f"config 4 learned {tier}: non-finite probs")
    fresh = GnnStreamingScorer(builder.store, settings, now_s=now_s).rescore()
    quant = settings.gnn_feature_quant
    n_live, near = same_learned_verdicts(inc_res, fresh,
                                         f"config 4 learned {tier}",
                                         QUANT_TOL.get(quant))
    if quant:
        # the incremental quant table == the host features quantized
        # against the table's frozen scale, row for row
        pn = scorer.snapshot.padded_nodes
        table = scorer._features_q_dev.cpu()
        want = torch.from_numpy(scorer._quant_rows(list(range(pn)), pn))
        if not torch.equal(table, want.to(table.dtype)):
            raise AssertionError(f"config 4 learned {tier}: the quant table "
                                 "differs from the host features quantized "
                                 "against its scale")
    log(f"config 4 learned {tier}: {len(stream)} events, {ticks} ticks, "
        f"launches {counts}, rebuilds={scorer.rebuilds}, final state == "
        f"fresh rebuild on {n_live} incidents ({near} near-ties of the "
        f"quant tier not held); {eps:.1f} events/s, dispatch p50 "
        f"{tick_ms:.3f} ms")
    offs, pn = scorer._rel_offsets, scorer.snapshot.padded_nodes
    out = {"events_per_s": eps, "dispatch_p50_ms": tick_ms, "ticks": ticks,
           "counts": counts, "launches": counts["gms"],
           "rules_fold_launches": counts["rules_fold"],
           "shape": {"Pn": pn, "Pe": int(offs[-1]), "rel_offsets": list(offs)}}
    if tier == "composed":
        args, err = resident_gms_check(
            scorer, "config 4 resident mirror after the churn")
        timing = gms_timing(args, offs, pn)
        log(f"config 4 gms timing: {timing}")
        out.update(timing=timing, max_abs_err=max(errs + [err]))
        out["shape"]["live_edges"] = timing["live_edges"]
        return out
    err = resident_fused_checks(scorer, tier, "after the churn")
    check = {"fused": "fused", "dma": "dma_nb2048",
             "dma_int8": "dma_int8_table"}[tier]
    timing = tick_timing(scorer, check)
    log(f"config 4 learned {tier} tick timing: {timing}")
    out.update(timing=timing, max_abs_err=max(errs + [err]))
    out["shape"]["live_edges"] = timing["live_edges"]
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; this script needs a GPU")
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import kubernetes_aiops_evidence_graph_tpu_torch  # noqa: F401
    except ImportError as exc:
        log(f"chip_smoke: the port's package is not beside this script ({exc})")
        return 2
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import _build
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import gms
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import rules_fold as rf
    from kubernetes_aiops_evidence_graph_tpu_torch.rca import RULES
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.cpu_backend import (
        CpuRcaBackend)
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.cuda_backend import (
        CudaRcaBackend)

    t_start = time.perf_counter()
    # plain versions and the embed/self/head products in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    # -- 2. build --------------------------------------------------------
    report = _build.build_all()
    for name, r in report.items():
        log(f"build {name}: {r['seconds']:.1f} s (cached={r['cached']})")
        if r["log"].strip():
            log(r["log"].strip())

    # -- 3. rules_fold vs plain at edge shapes -----------------------------
    rng = np.random.default_rng(0)
    max_err = 0.0
    cases = {
        "config-3 widths": (65536, 512, 64, 16),
        "W > 256 (fold chunks)": (4096, 128, 512, 8),
        "pair width > 64 (pair chunks)": (4096, 128, 128, 256),
    }
    for what, (pn, pi, width, pw) in cases.items():
        args = random_batch(rng, pn, pi, width, pw, dev)
        got = rf.rules_fold(*args, pw)
        torch.cuda.synchronize()
        max_err = max(max_err, assert_equal_outputs(
            got, rf.rules_fold_reference(*args, pw), what))
        log(f"kernel == plain: {what} (Pn={pn} Pi={pi} W={width} Wr={pw})")
    args, pw = edge_batch(dev)
    got = rf.rules_fold(*args, pw)
    torch.cuda.synchronize()
    max_err = max(max_err, assert_equal_outputs(
        got, rf.rules_fold_reference(*args, pw), "Pi=8 edges"))
    idx = {r.id: i for i, r in enumerate(RULES)}
    top = got[3].cpu().tolist()
    if (top[0] != idx["crashloop_recent_deploy"]
            or top[1] != idx["crashloop_no_change"]
            or bool(got[4][2]) or not bool(got[1][6, idx["node_failure_isolated"]])
            or bool(got[1][5, idx["node_failure_isolated"]])
            or bool(got[1][3, idx["network_error"]])
            or not bool(got[1][4, idx["network_error"]])):
        raise AssertionError(f"threshold edges scored wrong: top={top}")
    log("kernel == plain: Pi=8 threshold edges, verdicts as expected")

    # -- 4. config 3 end to end, rules -------------------------------------
    t0 = time.perf_counter()
    incidents, evidence, snapshot = build_world(35_000, 500, seed=0)
    log(f"config 3 world: {snapshot.num_nodes} nodes, {snapshot.num_incidents} "
        f"incidents, Pn={snapshot.padded_nodes} Pi={snapshot.padded_incidents} "
        f"Pe={snapshot.padded_edges} ({time.perf_counter() - t0:.1f} s)")
    backend = CudaRcaBackend()
    reset_counts()
    raw = backend.score_snapshot(snapshot)
    results = backend.results(raw=raw)
    launches_c3 = rf.launches
    if launches_c3 < 1:
        raise AssertionError("config 3 scored without launching the kernel")
    if len(results) != snapshot.num_incidents:
        raise AssertionError("results() lost incidents")
    plain = CudaRcaBackend("cpu").score_snapshot(snapshot)
    for k in CudaRcaBackend._FETCH_FIELDS["full"]:
        if not np.array_equal(raw[k], plain[k]) or raw[k].dtype != plain[k].dtype:
            raise AssertionError(f"config 3: {k} differs from the plain version")
        if raw[k].dtype.kind == "f" and raw[k].size:
            max_err = max(max_err, float(np.abs(raw[k] - plain[k]).max()))
    # top-1 against the CPU rules oracle: on the sample bench.py checks
    # (every tenth incident), and counted over all 500 for the record
    cpu = CpuRcaBackend()
    row_of = {nid: i for i, nid in enumerate(raw["incident_ids"])}
    sample = {inc.id for inc in incidents[::max(1, len(incidents) // 50)][:50]}
    disagree: dict[str, int] = {}
    oracle: dict[str, str] = {}
    for inc in incidents:
        want = cpu.score_incident(inc.id, evidence[inc.id]).top_hypothesis.rule_id
        oracle[f"incident:{inc.id}"] = want
        got_rule = results[row_of[f"incident:{inc.id}"]].top_hypothesis.rule_id
        if got_rule != want:
            if inc.id in sample:
                raise AssertionError(
                    f"config 3 top-1 {got_rule} != CPU oracle {want}")
            key = f"{inc.labels.get('scenario')}: oracle {want}, graph {got_rule}"
            disagree[key] = disagree.get(key, 0) + 1
    log(f"config 3: top-1 == CPU oracle on the {len(sample)}-incident sample; "
        f"over all {len(incidents)}: {sum(disagree.values())} differ {disagree}")
    batch = backend.prepared(snapshot)
    log(f"config 3: {launches_c3} launch(es), verdicts == plain; "
        f"W={batch.ev_idx.shape[1]} "
        f"Wr={batch.pair_width} live slots={int(batch.ev_cnt.sum())}; "
        f"dispatch {raw['dispatch_seconds'] * 1e3:.3f} ms, fetch "
        f"{raw['fetch_seconds'] * 1e3:.3f} ms")
    c3_args = (*backend.device_arrays(snapshot),
               torch.zeros(batch.padded_incidents, device=dev))
    t3 = kernel_timing(c3_args, batch.pair_width)
    log(f"config 3 timing: {t3}")

    # -- 5. gms vs plain at edge shapes ------------------------------------
    gms_err = gms_edge_cases(dev)

    # -- 6. config 3, learned ----------------------------------------------
    learned3 = run_learned_config3(snapshot, oracle, dev)
    gms_err = max(gms_err, learned3["max_abs_err"])

    # -- 7. fused_tick vs plain at edge shapes ------------------------------
    fused_err = fused_edge_cases(dev)

    # -- 8. config 4 streaming, both backends, the learned one per tier ----
    eps, tick_ms, launches_c4, ticks, c4_shape, c4_timing, c4_err = \
        run_streaming()
    max_err = max(max_err, c4_err)
    learned4 = run_streaming_learned()
    gms_err = max(gms_err, learned4["max_abs_err"])
    tiers = {t: run_streaming_learned(t) for t in ("fused", "dma", "dma_int8")}
    fused_err = max([fused_err] + [r["max_abs_err"] for r in tiers.values()])
    rules_learned = {f"config4_learned_{t}": r["rules_fold_launches"]
                     for t, r in {"composed": learned4, **tiers}.items()}

    kernels = [{
        "name": "rules_fold", "route": "cuda",
        "source": "kubernetes_aiops_evidence_graph_tpu_torch/kernels/rules_fold.cu",
        "replaces": "kubernetes_aiops_evidence_graph_tpu/experiments/"
                    "pallas_rules.py:113 (_rules_kernel) + "
                    "kubernetes_aiops_evidence_graph_tpu/rca/tpu_backend.py:258"
                    " (_aggregate)",
        "launches": launches_c3 + launches_c4 + sum(rules_learned.values()),
        "launches_by_path": {
            "config3_rules": launches_c3, "config4_rules": launches_c4,
            **rules_learned},
        "config4_ticks": ticks,
        "max_abs_err": max_err,
        "ms": t3["ms"], "plain_ms": t3["plain_ms"], "bound_ms": t3["bound_ms"],
        "bound_by": t3["bound_by"], "library_ms": None,
        "library_note": "no single PyTorch call does the evidence fold and "
                        "the rules tail",
        "timed_by": t3["timed_by"],
        "ms_per_call": t3["ms_per_call"],
        "plain_ms_per_call": t3["plain_ms_per_call"],
        "config4_shape": c4_shape,
        "bound_bytes": t3["bound_bytes"],
        "config4": {k: c4_timing[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_bytes", "ms_per_call",
                                             "timed_by")},
    }, {
        "name": "gms", "route": "cuda",
        "source": "kubernetes_aiops_evidence_graph_tpu_torch/kernels/gms.cu",
        "replaces": "kubernetes_aiops_evidence_graph_tpu/ops/"
                    "pallas_segment.py:152 (_gms_kernel)",
        "launches": learned3["launches"] + learned4["launches"],
        "launches_by_path": {"config3_learned": learned3["launches"],
                             "config4_learned": learned4["launches"]},
        "config4_ticks": learned4["ticks"],
        "max_abs_err": gms_err,
        "ms": learned3["timing"]["ms"],
        "plain_ms": learned3["timing"]["plain_ms"],
        "bound_ms": learned3["timing"]["bound_ms"],
        "bound_by": learned3["timing"]["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call does gather -> per-relation "
                        "matmul -> ordered segment sum",
        "timed_by": learned3["timing"]["timed_by"],
        "ms_per_call": learned3["timing"]["ms_per_call"],
        "plain_ms_per_call": learned3["timing"]["plain_ms_per_call"],
        "plan_ms": learned3["timing"]["plan_ms"],
        "ms_by_kernel": learned3["timing"]["ms_by_kernel"],
        "bound_bytes": learned3["timing"]["bound_bytes"],
        "bound_ops": learned3["timing"]["bound_ops"],
        "config3_shape": {"Pn": snapshot.padded_nodes,
                          "Pe": snapshot.padded_edges,
                          "live_edges": learned3["timing"]["live_edges"]},
        "config4_shape": learned4["shape"],
        "config4": {k: learned4["timing"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "bound_bytes",
            "ms_per_call", "plan_ms", "ms_by_kernel", "timed_by")},
    }]
    for name, runs, line in (
            ("fused_tick", ("fused",),
             "406 (_fused_kernel_factory; pallas_call :565)"),
            ("fused_tick_dma", ("dma", "dma_int8"),
             "785 (_dma_kernel_factory; pallas_call :1095)")):
        t = tiers[runs[0]]["timing"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "kubernetes_aiops_evidence_graph_tpu_torch/kernels/"
                      "fused_tick.cu",
            "replaces": "kubernetes_aiops_evidence_graph_tpu/ops/"
                        f"pallas_segment.py:{line}",
            "launches": sum(tiers[r]["counts"][name] for r in runs),
            "launches_by_path": {f"config4_learned_{r}": tiers[r]["counts"][name]
                                 for r in runs},
            "config4_ticks": tiers[runs[0]]["ticks"],
            "max_abs_err": fused_err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            "library_note": "no single PyTorch call computes the tick; "
                            "composed_ms is the composed tick (scatter, "
                            "gnn.forward with the gms kernel, softmax) at "
                            "the same shape",
            "composed_ms": t["composed_ms"],
            "timed_by": t["timed_by"], "ms_per_call": t["ms_per_call"],
            "plain_ms_per_call": t["plain_ms_per_call"],
            "ms_by_kernel": t["ms_by_kernel"],
            "bound_bytes": t["bound_bytes"], "bound_ops": t["bound_ops"],
            "floor_bytes": t["floor_bytes"], "floor_ms": t["floor_ms"],
            "config4_shape": tiers[runs[0]]["shape"],
            "by_tier": {r: {k: tiers[r]["timing"][k] for k in (
                "ms", "plain_ms", "composed_ms", "bound_ms", "bound_by")}
                for r in runs},
        })
    log(f"config 4: rules {eps:.1f} events/s, dispatch p50 {tick_ms:.3f} ms; "
        f"learned {learned4['events_per_s']:.1f} events/s, dispatch p50 "
        f"{learned4['dispatch_p50_ms']:.3f} ms; total "
        f"{time.perf_counter() - t_start:.1f} s")
    for t, r in tiers.items():
        log(f"config 4 learned {t}: {r['events_per_s']:.1f} events/s, "
            f"dispatch p50 {r['dispatch_p50_ms']:.3f} ms, tick "
            f"{r['timing']['ms']:.4f} ms device vs composed "
            f"{r['timing']['composed_ms']:.4f} ms at the same shape")
    print(json.dumps({
        "config3_verdicts": snapshot.num_incidents,
        "config3_top1_differs_from_cpu_oracle": sum(disagree.values()),
        "config3_learned_verdicts": snapshot.num_incidents,
        "config3_learned_top1_equals_cpu_oracle": learned3["oracle_agree"],
        "config3_learned_top1_counts": learned3["top1_counts"],
        "config3_learned_near_ties": learned3["near_ties"],
        "config3_learned_logit_max_abs_err": learned3["logit_max_abs_err"],
        "config3_learned_forward_ms": learned3["timing"]["forward_ms"],
        "config3_learned_forward_plain_ms":
            learned3["timing"]["forward_plain_ms"],
        "config3_learned_wall_ms": learned3["wall_ms"],
        "config4_events_per_s": eps,
        "config4_dispatch_p50_ms": tick_ms,
        "config4_learned_events_per_s": learned4["events_per_s"],
        "config4_learned_dispatch_p50_ms": learned4["dispatch_p50_ms"],
        **{f"config4_learned_{t}_{k}": r[k] for t, r in tiers.items()
           for k in ("events_per_s", "dispatch_p50_ms")},
        **{f"config4_learned_{t}_tick_ms": r["timing"]["ms"]
           for t, r in tiers.items()},
        "config4_learned_composed_tick_ms":
            tiers["fused"]["timing"]["composed_ms"]}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
