"""The port's per-tick scope (``rca/streaming.py``, ``rca/gnn_streaming.py``
through ``observability/scope.py``) against the JAX package's, on the same
seeded world and churn in both packages: the trace anatomy of a
webhook → verdict (``serve.tick`` and its ``tick.*`` children) at pipeline
depths 1 and 2, every tick and every coalesce in the flight ring, the
queue-wait split, scope off being off the path, the roofline gauges over
the live tick, and the learned tiers' entry points. Records and spans are
compared field by field with their times left out; a tick's completion is
made observable at once (``_tick_ready``) in both packages so that the
same ticks dispatch. The pattern is tests/test_scope.py."""
import importlib
import time

import numpy as np
import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu_torch.rca import device_metrics as dm
from tests.test_torch_gnn_streaming import _scorer as _gnn_scorer
from tests.test_torch_streaming import JAX_PKG, PORT_PKG, SMALL, _world

torch.set_num_threads(1)

STAGES = ["pack", "staging", "dispatch", "execute", "fetch"]
TIERS = {
    "composed": ({}, "streaming.gnn_tick.bucketed"),
    "fused": ({"gnn_fused_tick": True}, "streaming.gnn_tick.fused"),
    "fused_bf16": ({"gnn_fused_tick": True, "gnn_compute_dtype": "bfloat16"},
                   "streaming.gnn_tick.fused.bf16"),
    # the JAX package streams a float32 table only past its VMEM budget
    # (a TPU figure the port does not carry): a zero budget there
    "dma": ({"gnn_tick_dma": True}, "streaming.gnn_tick.dma"),
    "dma_bf16": ({"gnn_tick_dma": True, "gnn_feature_quant": "bfloat16"},
                 "streaming.gnn_tick.dma.bf16"),
    "dma_int8": ({"gnn_tick_dma": True, "gnn_feature_quant": "int8"},
                 "streaming.gnn_tick.dma.int8"),
}


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _setup(pkg, depth=2, tier=None, params=None, ready=True, **extra):
    """(cluster, builder, incidents, scorer) on the seeded world, warmed
    with one rescore(). ``ready`` pins whether a queued tick's completion
    is observable (True: every tick retires at the next submission)."""
    if pkg == JAX_PKG and tier == "dma":
        extra = {**extra, "vmem_budget_bytes": 0}
    cfg = _mod(pkg, "config").load_settings(
        serve_pipeline_depth=depth, **SMALL,
        **(TIERS[tier][0] if tier else {}), **extra)
    cluster, builder, incidents = _world(pkg, cfg, seed=13, num_pods=150)
    now = cluster.now.timestamp()
    if tier is None:
        kw = {"device": "cpu"} if pkg == PORT_PKG else {}
        scorer = _mod(pkg, "rca.streaming").StreamingScorer(
            builder.store, cfg, now_s=now, **kw)
    else:
        scorer = _gnn_scorer(pkg, builder.store, cfg, params, now)
    scorer._tick_ready = lambda handles: ready
    scorer.rescore()
    return cluster, builder, incidents, scorer


def _churn(pkg, cluster, builder, incidents, scorer, n, seed, submit=True):
    stream = _mod(pkg, "simulator.stream")
    out = 0
    for ev in stream.churn_events(
            cluster, n, seed=seed, structural=False,
            incident_ids=tuple(f"incident:{i.id}" for i in incidents)):
        stream.stream_step(cluster, builder.store, scorer, ev)
        if submit:
            out += int(scorer.tick_async()["coalesced"])
    return out


def _fence(pkg):
    marker = f"fence-{pkg}-{time.monotonic_ns()}"
    _mod(pkg, "observability.scope").FLIGHT_RECORDER.note_event(
        "test_fence", tag=marker)
    return marker


def _records(pkg, marker):
    """The flight records after ``marker``, times left out (the stage
    splits keep their names, in order)."""
    snap = _mod(pkg, "observability.scope").FLIGHT_RECORDER.snapshot()
    fence = max(i for i, r in enumerate(snap) if r.get("tag") == marker)
    out = []
    for r in snap[fence + 1:]:
        r = dict(r)
        r.pop("t_epoch_s", None)
        if "stages_ms" in r:
            r["stages_ms"] = list(r["stages_ms"])
        out.append(r)
    return out


def _both(fn):
    return {pkg: fn(pkg) for pkg in (JAX_PKG, PORT_PKG)}


@pytest.mark.parametrize("depth", [1, 2])
def test_trace_anatomy_webhook_to_verdict(depth):
    """webhook span → workflow step span → ``serve.tick`` → contiguous
    ``tick.*`` children whose splits sum to the tick span within 5%, one
    trace id; the same span tree and tick attributes as the JAX scorer's."""
    def run(pkg):
        obs = _mod(pkg, "observability")
        scope = _mod(pkg, "observability.scope")
        cluster, builder, incidents, scorer = _setup(pkg, depth)
        obs.TRACER.clear()
        scope.SCOPE.clear()
        with obs.TRACER.span("webhook.alertmanager", alerts=1) as webhook:
            scope.SCOPE.webhook_received("slo-trace-1", tenant="payments")
        _churn(pkg, cluster, builder, incidents, scorer, 40, seed=7)
        with obs.TRACER.span(
                "workflow.generate_hypotheses",
                parent=scope.SCOPE.trace_parent("incident-slo-trace-1")) as wf:
            out = scorer.rescore()
            lat = scope.SCOPE.verdict_served("slo-trace-1", backend="rules")
        assert out["incident_ids"] and lat is not None and lat > 0.0
        spans = obs.TRACER.export(trace_id=webhook.trace_id)
        by_id = {s["span_id"]: s for s in spans}
        tick = [s for s in spans if s["name"] == "serve.tick"][-1]
        assert tick["parent_id"] == wf.span_id
        assert by_id[wf.span_id]["parent_id"] == webhook.span_id
        children = [s for s in spans if s["parent_id"] == tick["span_id"]]
        assert sum(c["duration_ms"] for c in children) == pytest.approx(
            tick["duration_ms"], rel=0.05)
        return (sorted(s["name"] for s in spans), tick["attributes"],
                [c["name"] for c in children])

    got = _both(run)
    assert got[PORT_PKG] == got[JAX_PKG]
    names, attrs, children = got[PORT_PKG]
    assert [c for c in children if c != "tick.queue_wait"] == [
        f"tick.{s}" for s in STAGES]
    assert attrs["backend"] == "rules" and attrs["depth"] == depth


def test_flight_recorder_records_every_tick_and_coalesce():
    """With a full queue every submission coalesces and is recorded as a
    ``coalesced`` event; each dispatched tick leaves exactly one record,
    the fetched one with its stages in order; the records equal the JAX
    scorer's field by field."""
    def run(pkg):
        cluster, builder, incidents, scorer = _setup(pkg, 2, ready=False)
        marker = _fence(pkg)
        d0 = scorer.dispatches
        coalesced = _churn(pkg, cluster, builder, incidents, scorer, 30,
                           seed=5)
        scorer.rescore()
        recs = _records(pkg, marker)
        ticks = [r for r in recs if "tick" in r]
        assert coalesced > 0
        assert len(ticks) == len({r["tick"] for r in ticks}) == \
            scorer.dispatches - d0
        assert sum(r.get("event") == "coalesced" for r in recs) == coalesced
        return recs

    got = _both(run)
    assert got[PORT_PKG] == got[JAX_PKG]
    fetched = [r for r in got[PORT_PKG] if r.get("fetched")]
    assert fetched[-1]["stages_ms"] == ["queue_wait"] + STAGES
    assert fetched[-1]["tier"] == "steady" and fetched[-1]["backend"] == "rules"


def test_queue_wait_split_is_a_back_compatible_sum():
    """With the pipeline full, rescore() reports the slot wait in
    ``queue_wait_seconds``, ``device_seconds`` stays the sum of the three
    windows, and the fetched tick's record leads with ``queue_wait``."""
    def run(pkg):
        cluster, builder, incidents, scorer = _setup(pkg, 2, ready=False)
        _churn(pkg, cluster, builder, incidents, scorer, 10, seed=12)
        assert len(scorer._inflight) == scorer.pipeline_depth
        marker = _fence(pkg)
        out = scorer.rescore()
        assert out["queue_wait_seconds"] > 0.0
        assert out["device_seconds"] == pytest.approx(
            out["queue_wait_seconds"] + out["dispatch_seconds"]
            + out["fetch_seconds"])
        return _records(pkg, marker)

    got = _both(run)
    assert got[PORT_PKG] == got[JAX_PKG]
    assert got[PORT_PKG][-1]["stages_ms"][0] == "queue_wait"


def test_scope_disabled_is_off_path():
    """scope_telemetry=False: no flight records, no priced tick, no span
    parked; the split fields still report."""
    def run(pkg):
        scope = _mod(pkg, "observability.scope")
        cluster, builder, incidents, scorer = _setup(
            pkg, 2, scope_telemetry=False)
        assert scorer.scope.enabled is False
        n0 = len(scope.FLIGHT_RECORDER.snapshot())
        _churn(pkg, cluster, builder, incidents, scorer, 20, seed=2)
        out = scorer.rescore()
        assert len(scope.FLIGHT_RECORDER.snapshot()) == n0
        assert scorer._last_tick_span is None
        assert scorer._scope_key == ()
        assert out["device_seconds"] == pytest.approx(
            out["queue_wait_seconds"] + out["dispatch_seconds"]
            + out["fetch_seconds"])
        return sorted(out)

    got = _both(run)
    assert got[PORT_PKG] == got[JAX_PKG]


def test_roofline_gauges_track_the_live_tick():
    """The live tick's price lands in the modeled gauge (it is
    ``device_metrics.tick_cost`` at the tick's padded shapes), no halo
    bytes on one device, achieved bytes/s above 0 and drift in (0, 1], as
    in the JAX package."""
    from kubernetes_aiops_evidence_graph_tpu_torch.observability import (
        metrics as t_metrics, scope as t_scope)
    cluster, builder, incidents, scorer = _setup(PORT_PKG, 2)
    _churn(PORT_PKG, cluster, builder, incidents, scorer, 20, seed=9,
           submit=False)
    scorer.rescore()
    t_scope.ROOFLINE.join()
    scorer.rescore()
    entry = "streaming.rules_tick"
    assert scorer._scope_entry == entry
    priced = t_scope.ROOFLINE.priced(entry)
    rec = priced[scorer._scope_key]
    pn, pi, width, pair_width, pk, rk = scorer._scope_key
    want = dm.tick_cost(entry, pn=pn, pi=pi, width=width, pk=pk, rk=rk)
    assert rec["hbm_bytes"] == want["bytes"] > 0
    assert rec["flops"] == want["flops"]
    modeled = t_metrics.ROOFLINE_MODELED_BYTES.value(entrypoint=entry,
                                                     pack="0")
    assert modeled in {r["hbm_bytes"] for r in priced.values()}
    assert t_metrics.ROOFLINE_HALO_BYTES.value(entrypoint=entry,
                                               pack="0") == 0.0
    achieved = t_metrics.ROOFLINE_ACHIEVED_BPS.value(entrypoint=entry,
                                                     pack="0")
    drift = t_metrics.ROOFLINE_DRIFT.value(entrypoint=entry, pack="0")
    assert achieved > 0.0 and 0.0 < drift <= 1.0
    assert t_scope.ROOFLINE.best(entry) >= t_scope.ROOFLINE.achieved(entry)


@pytest.fixture(scope="module")
def params():
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.gnn_backend import (
        SHIPPED_CHECKPOINT, load_validated_checkpoint)
    return load_validated_checkpoint(SHIPPED_CHECKPOINT)


@pytest.mark.parametrize("tier", list(TIERS))
def test_learned_tier_entry_point_records_and_price(params, tier):
    """Each learned tier names the entry point the JAX scorer names for
    it, leaves the same tick records (``gnn_dispatch`` after the base
    ``dispatch``), and its modeled bytes are ``tick_cost`` at the tick's
    padded shapes with every edge slot counted live."""
    def run(pkg):
        cluster, builder, incidents, scorer = _setup(pkg, 2, tier=tier,
                                                     params=params)
        marker = _fence(pkg)
        _churn(pkg, cluster, builder, incidents, scorer, 6, seed=4)
        scorer.rescore()
        return scorer, _records(pkg, marker)

    (jax_scorer, jax_recs), (scorer, recs) = (run(JAX_PKG), run(PORT_PKG))
    entry = TIERS[tier][1]
    assert scorer._scope_entry == jax_scorer._scope_entry == entry
    assert recs == jax_recs
    fetched = [r for r in recs if r.get("fetched")]
    assert fetched[-1]["stages_ms"] == ["pack", "staging", "dispatch",
                                        "gnn_dispatch", "execute", "fetch"]
    assert fetched[-1]["backend"] == "gnn"
    from kubernetes_aiops_evidence_graph_tpu_torch.observability import (
        scope as t_scope)
    pn, pi, pe, pk, ek = scorer._scope_key
    assert pe == int(scorer._rel_offsets[-1])
    p = scorer._params
    want = dm.tick_cost(entry, pn=pn, pi=pi, pe=pe, pk=pk, ek=ek,
                        hidden=int(p["embed_b"].shape[0]),
                        layers=len(p["layers"]),
                        compute_dtype=scorer._compute_dtype)
    rec = t_scope.ROOFLINE.priced(entry)[scorer._scope_key]
    assert rec["hbm_bytes"] == want["bytes"] > 0
    assert rec["flops"] == want["flops"]
    assert np.isfinite(t_scope.ROOFLINE.achieved(entry))
