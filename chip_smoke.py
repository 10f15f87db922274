#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``kubernetes_aiops_evidence_graph_tpu_torch`` on the card, both RCA
paths: the rules path (``rca_backend="tpu"``, kernel ``rules_fold``) and
the learned path (``rca_backend="gnn"``, kernel ``gms``):

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
7. config 4, both backends: 2,000 full-mix churn events on a
   10,000-pod cluster with 100 incidents, one ``dispatch()`` per 100-event
   tick and one ``rescore()`` at the end (bench.py's streaming loop); the
   incremental state must equal a fresh scorer rebuilt from the same
   store (rules: every output exactly; learned: top-1, probs within
   rtol 1e-4 / atol 1e-5), and each kernel must equal its plain version
   on the resident tensors after the first tick and after the churn; the
   rules run then adds 500 events through ``tick_async`` +
   ``serve(newest=True)``;
8. prints one ``{"kernels": [...]}`` line with each kernel's launches on
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
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import gms
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import rules_fold as rf
    saved = gms.launches, rf.launches
    try:
        yield
    finally:
        gms.launches, rf.launches = saved


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
    gms.launches = rf.launches = 0
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


def same_learned_verdicts(mine: dict, ref: dict, what: str) -> int:
    """Top-1 equal and probs within rtol 1e-4 / atol 1e-5 (slot reuse
    orders a destination's sum unlike a fresh layout), by incident id."""
    a = {iid: i for i, iid in enumerate(mine["incident_ids"])}
    b = {iid: i for i, iid in enumerate(ref["incident_ids"])}
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: live incident sets differ")
    ia, ib = [a[i] for i in a], [b[i] for i in a]
    if not np.array_equal(mine["top_rule_index"][ia],
                          ref["top_rule_index"][ib]):
        raise AssertionError(f"{what}: top-1 differs from a fresh rebuild")
    if not np.allclose(mine["probs"][ia], ref["probs"][ib],
                       rtol=1e-4, atol=1e-5):
        d = float(np.abs(mine["probs"][ia] - ref["probs"][ib]).max())
        raise AssertionError(f"{what}: probs differ from a fresh rebuild "
                             f"(max |d| {d})")
    return len(a)


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
    rf.launches = gms.launches = 0
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


def run_streaming_learned(num_pods: int = 10_000, num_incidents: int = 100,
                          events: int = 2000, batch_size: int = 100,
                          seed: int = 0) -> dict:
    """Config 4, learned (bench.py's streaming loop with backend="gnn"):
    GnnStreamingScorer with the shipped weights; gms launched L times a
    tick; final state == a fresh rebuild; gms == plain on the resident
    mirror after the first tick and after the churn, then timed there."""
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import gms
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import rules_fold as rf
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.gnn_streaming import (
        GnnStreamingScorer)
    from kubernetes_aiops_evidence_graph_tpu_torch.simulator.stream import (
        churn_events)

    settings, cluster, builder = streaming_world(num_pods, num_incidents, seed)
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
    gms.launches = rf.launches = 0
    inc_res, eps, tick_ms, ticks = churn_ticks(
        scorer, cluster, builder, stream, batch_size,
        lambda s: errs.append(resident_gms_check(
            s, "config 4 resident mirror after the first tick")[1]))
    launches, rules_launches = gms.launches, rf.launches
    if launches != layers * ticks:
        raise AssertionError(f"config 4 learned: {launches} gms launches "
                             f"for {ticks} ticks of {layers} layers")
    if not np.isfinite(inc_res["probs"]).all():
        raise AssertionError("config 4 learned: non-finite probs")
    fresh = GnnStreamingScorer(builder.store, settings, now_s=now_s).rescore()
    n_live = same_learned_verdicts(inc_res, fresh, "config 4 learned")
    log(f"config 4 learned: {len(stream)} events, {ticks} ticks, "
        f"{launches} gms launches, rebuilds={scorer.rebuilds}, final "
        f"state == fresh rebuild on {n_live} incidents; {eps:.1f} events/s, "
        f"dispatch p50 {tick_ms:.3f} ms")
    args, err = resident_gms_check(
        scorer, "config 4 resident mirror after the churn")
    offs, pn = scorer._rel_offsets, scorer.snapshot.padded_nodes
    timing = gms_timing(args, offs, pn)
    log(f"config 4 gms timing: {timing}")
    return {"events_per_s": eps, "dispatch_p50_ms": tick_ms,
            "launches": launches, "rules_fold_launches": rules_launches,
            "ticks": ticks, "timing": timing, "max_abs_err": max(errs + [err]),
            "shape": {"Pn": pn, "Pe": int(offs[-1]),
                      "live_edges": timing["live_edges"],
                      "rel_offsets": list(offs)}}


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
    rf.launches = gms.launches = 0
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

    # -- 7. config 4 streaming, both backends ------------------------------
    eps, tick_ms, launches_c4, ticks, c4_shape, c4_timing, c4_err = \
        run_streaming()
    max_err = max(max_err, c4_err)
    learned4 = run_streaming_learned()
    gms_err = max(gms_err, learned4["max_abs_err"])

    kernels = [{
        "name": "rules_fold", "route": "cuda",
        "source": "kubernetes_aiops_evidence_graph_tpu_torch/kernels/rules_fold.cu",
        "replaces": "kubernetes_aiops_evidence_graph_tpu/experiments/"
                    "pallas_rules.py:113 (_rules_kernel) + "
                    "kubernetes_aiops_evidence_graph_tpu/rca/tpu_backend.py:258"
                    " (_aggregate)",
        "launches": launches_c3 + launches_c4 + learned4["rules_fold_launches"],
        "launches_by_path": {
            "config3_rules": launches_c3, "config4_rules": launches_c4,
            "config4_learned": learned4["rules_fold_launches"]},
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
    log(f"config 4: rules {eps:.1f} events/s, dispatch p50 {tick_ms:.3f} ms; "
        f"learned {learned4['events_per_s']:.1f} events/s, dispatch p50 "
        f"{learned4['dispatch_p50_ms']:.3f} ms; total "
        f"{time.perf_counter() - t_start:.1f} s")
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
        "config4_learned_dispatch_p50_ms": learned4["dispatch_p50_ms"]}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
