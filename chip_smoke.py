#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``kubernetes_aiops_evidence_graph_tpu_torch`` on the card:

1. requires CUDA (exits non-zero without it) and prints the card's name
   and power limit as nvidia-smi reports them;
2. builds every kernel of the rules path from the sources in this
   checkout (one nvcc per source, started together);
3. holds each kernel against its plain PyTorch version on the card, with
   exact equality of every output, at edge shapes (W > 256, pair width
   > 64, empty rows, an 8-row batch of threshold edges);
4. config 3: builds a 35,000-pod cluster with 500 concurrent incidents
   (seed 0), scores it with ``CudaRcaBackend.score_snapshot`` and
   materializes ``results()``; the kernel must have launched, the verdicts
   must equal the plain version run on a CPU copy, and top-1 must equal
   the CPU rules oracle on the 50-incident sample bench.py checks (the
   count of disagreements over all 500 is printed);
5. config 4: 2,000 full-mix churn events on a 10,000-pod cluster with
   100 incidents, one ``dispatch()`` per 100-event tick and one
   ``rescore()`` at the end; the incremental state must equal a fresh
   ``StreamingScorer`` rebuilt from the same store, and the kernel must
   equal its plain version on the resident tensors (Pn, Pi, W and pair
   width of this run) after the first tick and after the churn;
6. prints one ``{"kernels": [...]}`` line with each kernel's launches on
   the main path, its time, the plain version's time and its bound, then
   the nvidia-smi line, then ``{"ok": true, "device": {...}}`` last.

Any failed phase raises and the script exits non-zero. A kernel's ``ms``
is its device time per call from the profiler's CUDA activity;
``ms_per_call`` is CUDA-event time over back-to-back calls, host launch
cost included.
"""
from __future__ import annotations

import json
import os
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


def device_ms(fn, iters: int = 20) -> float:
    """Mean device-busy time of ``fn`` in ms, from the profiler's CUDA
    activity (CUPTI): the sum of the kernels' and copies' own device time
    over ``iters`` calls. 0.0 when the profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    return us / iters / 1e3


def kernel_timing(args, pair_width: int) -> dict:
    """rules_fold and its plain version on these inputs: device time per
    call (profiler; CUDA events over back-to-back calls where the profiler
    saw nothing), time per call as the stream sees it (CUDA events, host
    launch cost included), and the bytes bound of these inputs."""
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import rules_fold as rf
    kernel = lambda: rf.rules_fold(*args, pair_width)              # noqa: E731
    plain = lambda: rf.rules_fold_reference(*args, pair_width)     # noqa: E731
    t = {"ms_per_call": cuda_ms(kernel),
         "plain_ms_per_call": cuda_ms(plain, iters=10, warmup=2)}
    t["ms"], t["plain_ms"] = device_ms(kernel), device_ms(plain, iters=10)
    t["timed_by"] = "profiler"
    if t["ms"] <= 0.0 or t["plain_ms"] <= 0.0:
        t["ms"], t["plain_ms"] = t["ms_per_call"], t["plain_ms_per_call"]
        t["timed_by"] = "cuda events"
    ev_idx, ev_cnt = args[1].cpu().numpy(), args[2].cpu().numpy()
    bound = rf.bound_bytes(ev_idx, ev_cnt)
    # one add per gathered value, and one per live slot into the histogram
    live = int(np.minimum(ev_cnt, ev_idx.shape[1]).clip(0).sum())
    bytes_ms = bound / HBM_BYTES_PER_S * 1e3
    ops_ms = live * (args[0].shape[1] + 1) / F32_FLOP_PER_S * 1e3
    t["bound_bytes"] = bound
    t["bound_ms"] = max(bytes_ms, ops_ms)
    t["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    return t


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
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import rules_fold as rf
    from kubernetes_aiops_evidence_graph_tpu_torch.rca import RULES
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.cpu_backend import (
        CpuRcaBackend)
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.cuda_backend import (
        CudaRcaBackend)

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in f32
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

    # -- 3. kernel vs plain at edge shapes --------------------------------
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

    # -- 4. config 3 end to end ------------------------------------------
    t0 = time.perf_counter()
    incidents, evidence, snapshot = build_world(35_000, 500, seed=0)
    log(f"config 3 world: {snapshot.num_nodes} nodes, {snapshot.num_incidents} "
        f"incidents, Pn={snapshot.padded_nodes} Pi={snapshot.padded_incidents} "
        f"({time.perf_counter() - t0:.1f} s)")
    backend = CudaRcaBackend()
    rf.launches = 0
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
    for inc in incidents:
        want = cpu.score_incident(inc.id, evidence[inc.id]).top_hypothesis.rule_id
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

    # -- 5. config 4 streaming -------------------------------------------
    eps, tick_ms, launches_c4, ticks, c4_shape, c4_timing, c4_err = \
        run_streaming()
    max_err = max(max_err, c4_err)

    kernel = {
        "name": "rules_fold", "route": "cuda",
        "source": "kubernetes_aiops_evidence_graph_tpu_torch/kernels/rules_fold.cu",
        "replaces": "kubernetes_aiops_evidence_graph_tpu/experiments/"
                    "pallas_rules.py:113 (_rules_kernel) + "
                    "kubernetes_aiops_evidence_graph_tpu/rca/tpu_backend.py:258"
                    " (_aggregate)",
        "launches": launches_c3 + launches_c4,
        "launches_config3": launches_c3, "launches_config4": launches_c4,
        "config4_ticks": ticks,
        "max_abs_err": max_err,
        "ms": t3["ms"], "plain_ms": t3["plain_ms"], "bound_ms": t3["bound_ms"],
        "bound_by": t3["bound_by"], "library_ms": None, "timed_by": t3["timed_by"],
        "ms_per_call": t3["ms_per_call"],
        "plain_ms_per_call": t3["plain_ms_per_call"],
        "config4_shape": c4_shape,
        "bound_bytes": t3["bound_bytes"],
        "config4": {k: c4_timing[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_bytes", "ms_per_call",
                                             "timed_by")},
    }
    log(f"config 4: {eps:.1f} events/s, dispatch p50 {tick_ms:.3f} ms; "
        f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"config3_verdicts": snapshot.num_incidents,
                      "config3_top1_differs_from_cpu_oracle":
                          sum(disagree.values()),
                      "config4_events_per_s": eps,
                      "config4_dispatch_p50_ms": tick_ms}))
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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


def resident_kernel_check(scorer, what: str) -> tuple[tuple, float]:
    """Hold the kernel against its plain version on a copy of the scorer's
    resident tensors, as they stand after its last tick. These launches
    are a comparison, not the path's: the launch count is left as it was.
    Returns (the copied arguments, the largest float difference)."""
    import torch
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import rules_fold as rf
    torch.cuda.synchronize()
    args = tuple(t.clone() for t in (
        scorer._features_dev, scorer._ev_idx_dev, scorer._ev_cnt_dev,
        scorer._pair_dev, scorer._chain0))
    saved = rf.launches
    got = rf.rules_fold(*args, scorer.pair_width)
    torch.cuda.synchronize()
    rf.launches = saved
    err = assert_equal_outputs(
        got, rf.rules_fold_reference(*args, scorer.pair_width), what)
    log(f"kernel == plain: {what} (Pn={args[0].shape[0]} "
        f"Pi={args[1].shape[0]} W={scorer.width} Wr={scorer.pair_width})")
    return args, err


def run_streaming(num_pods: int = 10_000, num_incidents: int = 100,
                  events: int = 2000, batch_size: int = 100, seed: int = 0):
    """Config 4 as the JAX package's streaming benchmark runs it: returns
    (events/s, median dispatch ms, kernel launches, ticks, resident shape,
    kernel_timing at the resident shape, the largest float difference of
    the kernel from its plain version on the resident tensors)."""
    from kubernetes_aiops_evidence_graph_tpu_torch.collectors import (
        collect_all, default_collectors)
    from kubernetes_aiops_evidence_graph_tpu_torch.config import load_settings
    from kubernetes_aiops_evidence_graph_tpu_torch.graph import GraphBuilder
    from kubernetes_aiops_evidence_graph_tpu_torch.graph.topology_sync import (
        sync_topology)
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import rules_fold as rf
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.streaming import (
        StreamingScorer)
    from kubernetes_aiops_evidence_graph_tpu_torch.simulator import (
        SCENARIOS, generate_cluster, inject)
    from kubernetes_aiops_evidence_graph_tpu_torch.simulator.stream import (
        churn_events, stream_step)

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
    scorer = StreamingScorer(builder.store, settings)
    scorer.rescore()
    stream = list(churn_events(
        cluster, events, seed=seed + 1,
        incident_ids=tuple(builder.store.incident_ids())))

    rf.launches = 0
    t0 = time.perf_counter()
    tick_times = []
    check_s, max_err = 0.0, 0.0
    for tick_start in range(0, len(stream), batch_size):
        for ev in stream[tick_start:tick_start + batch_size]:
            stream_step(cluster, builder.store, scorer, ev)
        t1 = time.perf_counter()
        scorer.dispatch()
        tick_times.append(time.perf_counter() - t1)
        if tick_start == 0:     # once mid-churn, off the clock
            t1 = time.perf_counter()
            max_err = resident_kernel_check(
                scorer, "config 4 resident tensors after the first tick")[1]
            check_s = time.perf_counter() - t1
    inc_res = scorer.rescore()
    wall = time.perf_counter() - t0 - check_s
    launches = rf.launches
    ticks = len(tick_times) + 1
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
    return (len(stream) / wall, statistics.median(tick_times) * 1e3,
            launches, ticks, shape, timing, max(max_err, err))


if __name__ == "__main__":
    sys.exit(main())
