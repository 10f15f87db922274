"""The telemetry overhead contract of tests/test_scope.py, held on the
port's scorer on the CPU: the complete per-tick scope path, microbenched
over the exact operations the port's serving loop runs, costs under 1% of
the measured depth-2 steady-state tick wall on the same world."""
import time

import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu_torch.observability import scope as t_scope
from tests.test_torch_scope_tick import _mod, _setup
from tests.test_torch_streaming import PORT_PKG

torch.set_num_threads(1)


@pytest.mark.perf_contract
def test_telemetry_overhead_under_1pct_of_depth2_tick():
    """Every tick pays begin + the pending/coalesced/generation stamps, the
    pack/staging/dispatch marks, the shape key and the roofline's cache
    hit, the batch stamps, the in-flight shadow queue and the unfetched
    retirement (execute mark, ring append); the caller-boundary tick (one
    in ten, the serving cadence) instead pays the execute and fetch
    marks, the fetched retirement (stage histograms) and the roofline
    observation. The amortized mix must cost <1% of the depth-2
    steady-state tick wall from the same world. Both are timed in this
    thread's CPU time: on the CPU the plain tick runs on the calling
    thread (one intra-op thread), and the suite's workers share the
    host's cores, so a descheduled worker charges neither side."""
    batch = 5        # events per tick: a floor (serving batches are
    #                  50-100); a smaller batch shrinks the tick wall,
    #                  never the telemetry cost
    cluster, builder, incidents, scorer = _setup(PORT_PKG, 2)
    del scorer._tick_ready            # real completion observation
    stream = _mod(PORT_PKG, "simulator.stream")
    events = list(stream.churn_events(
        cluster, 300, seed=21, structural=False,
        incident_ids=tuple(f"incident:{i.id}" for i in incidents)))
    t0 = time.thread_time()
    n_ticks = 0
    for i in range(0, len(events), batch):
        for ev in events[i:i + batch]:
            stream.stream_step(cluster, builder.store, scorer, ev)
        scorer.tick_async()
        n_ticks += 1
        if n_ticks % 10 == 0:
            scorer.rescore()
    tick_wall = (time.thread_time() - t0) / n_ticks

    scope = scorer.scope
    assert scope.enabled and scorer._scope_key
    roof = t_scope.ROOFLINE
    snap = scorer.snapshot
    meta = scorer._inflight_meta
    reps = 2000

    def one_tick(fetched: bool):
        sp = scope.begin(scorer)
        sp.pending = 3
        sp.coalesced = scorer._scope_coalesced_since
        sp.params_gen = scorer.params_generation
        sp.mark("pack")
        sp.mark("staging")
        key = (snap.padded_nodes, snap.padded_incidents, scorer.width,
               scorer.pair_width, 16, 8)
        roof.model(scorer._scope_entry, scorer._scope_key,
                   lambda: {"pn": snap.padded_nodes,
                            "pi": snap.padded_incidents,
                            "width": scorer.width, "pk": 16, "rk": 8,
                            "dim": 48},
                   pack=scorer._scope_pack)   # cache hit
        sp.batch_incidents = len(key)
        sp.tenants = 1
        sp.mark("dispatch")
        sp.mark("execute")
        if fetched:
            scorer._scope_fetched(sp)
        else:
            meta.append(sp)
            scorer._retire_meta()

    t0 = time.thread_time()
    for i in range(reps):
        one_tick(fetched=(i % 10 == 9))   # the 1-in-10 caller boundary
    scope_cost = (time.thread_time() - t0) / reps

    assert scope_cost < 0.01 * tick_wall, (
        f"telemetry cost {scope_cost*1e6:.1f} µs/tick is ≥1% of the "
        f"{tick_wall*1e3:.3f} ms depth-2 steady-state tick")
