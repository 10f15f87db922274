"""The port's resident StreamingScorer (on the CPU: the kernel's plain
version) against the JAX package's StreamingScorer on the same seeded
churn script, and against itself: bit-identical at pipeline depths 1/2/4
and equal to a fresh rebuild after full-mix churn, growth and rebuilds."""
import importlib
import uuid

import numpy as np
import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu_torch.config import load_settings
from kubernetes_aiops_evidence_graph_tpu_torch.graph import ids as gids
from kubernetes_aiops_evidence_graph_tpu_torch.models import GraphRelation
from kubernetes_aiops_evidence_graph_tpu_torch.rca import streaming as st
from kubernetes_aiops_evidence_graph_tpu_torch.rca.cuda_backend import (
    CudaRcaBackend)
from kubernetes_aiops_evidence_graph_tpu_torch.simulator.stream import (
    churn_events, stream_step)

# one intra-op thread: these tensors are small, and the suite runs
# several pytest workers side by side on the host's cores
torch.set_num_threads(1)

JAX_PKG = "kubernetes_aiops_evidence_graph_tpu"
PORT_PKG = "kubernetes_aiops_evidence_graph_tpu_torch"
RESULT_KEYS = ("conditions", "matched", "scores", "top_rule_index",
               "any_match", "top_confidence", "top_score")
# tight buckets so the churn script forces a mid-script rebuild
TIGHT = dict(node_bucket_sizes=(256, 512, 1024, 2048),
             incident_bucket_sizes=(4, 8, 32))
SMALL = dict(node_bucket_sizes=(512, 2048),
             incident_bucket_sizes=(8, 32))


def _world(pkg, settings, seed=13, num_pods=150,
           scenarios=("crashloop_deploy", "oom", "network")):
    """A seeded world with its injected incidents' ids fixed from the seed:
    a GNN mirror's free-list order after a node-removal cascade follows the
    iteration order of a set of edge keys, which name incidents, so both
    packages must see the same ids."""
    col = importlib.import_module(pkg + ".collectors")
    gr = importlib.import_module(pkg + ".graph")
    ts = importlib.import_module(pkg + ".graph.topology_sync")
    sim = importlib.import_module(pkg + ".simulator")
    cluster = sim.generate_cluster(num_pods=num_pods, seed=seed)
    rng = np.random.default_rng(seed)
    builder = gr.GraphBuilder()
    ts.sync_topology(cluster, builder.store)
    keys = sorted(cluster.deployments)
    incidents = [sim.inject(cluster, name, keys[i * 5 % len(keys)], rng)
                 for i, name in enumerate(scenarios)]
    for i, inc in enumerate(incidents):
        inc.id = uuid.UUID(int=seed * 1000 + i + 1)
        builder.ingest(inc, col.collect_all(
            inc, col.default_collectors(cluster, settings), parallel=False))
    return cluster, builder, incidents


def _run_script(pkg, depth, events=400, seed=13, checkpoint_every=80,
                buckets=TIGHT):
    """Replay one seeded full-mix churn script with tick_async after every
    event and rescore() at fixed checkpoints (the caller boundary)."""
    cfg = importlib.import_module(pkg + ".config").load_settings(
        serve_pipeline_depth=depth, **buckets)
    stream_mod = importlib.import_module(pkg + ".simulator.stream")
    scorer_cls = importlib.import_module(pkg + ".rca.streaming").StreamingScorer
    cluster, builder, incidents = _world(pkg, cfg, seed=seed)
    kw = {"device": "cpu"} if pkg == PORT_PKG else {}
    scorer = scorer_cls(builder.store, cfg, now_s=cluster.now.timestamp(), **kw)
    outs = [scorer.rescore()]
    # incident ids in injection order: uuids are minted per run, and the
    # churn script picks incidents by position
    stream = list(stream_mod.churn_events(
        cluster, events, seed=seed + 1,
        incident_ids=tuple(f"incident:{i.id}" for i in incidents)))
    for i, ev in enumerate(stream):
        stream_mod.stream_step(cluster, builder.store, scorer, ev)
        scorer.tick_async()
        if (i + 1) % checkpoint_every == 0:
            outs.append(scorer.rescore())
    outs.append(scorer.rescore())
    fresh = scorer_cls(builder.store, cfg, now_s=cluster.now.timestamp(), **kw)
    return outs, scorer, fresh.rescore()


def _assert_positional(a_outs, b_outs, what):
    assert len(a_outs) == len(b_outs)
    for gen, (a, b) in enumerate(zip(a_outs, b_outs)):
        assert len(a["incident_ids"]) == len(b["incident_ids"]), (what, gen)
        for key in RESULT_KEYS:
            np.testing.assert_array_equal(
                np.asarray(a[key]), np.asarray(b[key]),
                err_msg=f"{key} diverged ({what}, gen {gen})")


def _assert_same_by_id(mine, ref):
    a = {iid: i for i, iid in enumerate(mine["incident_ids"])}
    b = {iid: i for i, iid in enumerate(ref["incident_ids"])}
    assert a.keys() == b.keys()
    for key in RESULT_KEYS:
        np.testing.assert_array_equal(
            np.asarray(mine[key])[[a[i] for i in a]],
            np.asarray(ref[key])[[b[i] for i in a]], err_msg=key)


def test_verdicts_equal_jax_streaming_scorer_over_churn():
    """Same seed, same churn script, a mid-script rebuild: the port's
    verdicts equal the JAX StreamingScorer's at every caller boundary."""
    jax_outs, jax_scorer, _ = _run_script(JAX_PKG, depth=2)
    outs, scorer, fresh = _run_script(PORT_PKG, depth=2)
    assert scorer.rebuilds == jax_scorer.rebuilds >= 1
    assert (scorer.width, scorer.pair_width) == (jax_scorer.width,
                                                 jax_scorer.pair_width)
    _assert_positional(outs, jax_outs, "port vs JAX")
    _assert_same_by_id(outs[-1], fresh)


def test_depth_parity_bit_identical_1_2_4():
    base, s1, _ = _run_script(PORT_PKG, depth=1)
    assert s1.rebuilds > 0, "script never forced a mid-script rebuild"
    for depth in (2, 4):
        outs, scorer, _ = _run_script(PORT_PKG, depth=depth)
        assert scorer.rebuilds == s1.rebuilds
        _assert_positional(base, outs, f"depth {depth}")


def test_dispatch_ticks_equal_fresh_rebuild_and_snapshot_pass():
    """The benchmark's loop — one dispatch() per batch of events, one
    rescore() at the end — ends equal to a fresh scorer and to a batched
    pass over the snapshot it would build."""
    cfg = load_settings(**SMALL)
    cluster, builder, _ = _world(PORT_PKG, cfg)
    scorer = st.StreamingScorer(builder.store, cfg, device="cpu")
    first = scorer.rescore()
    batch = CudaRcaBackend("cpu").score_snapshot(scorer.snapshot)
    for key in RESULT_KEYS:
        np.testing.assert_array_equal(first[key], batch[key], err_msg=key)
    stream = list(churn_events(cluster, 300, seed=99,
                               incident_ids=tuple(builder.store.incident_ids())))
    kinds = {e.kind for e in stream}
    assert {"pod_create", "pod_delete", "incident_arrival",
            "incident_close"} <= kinds
    for i in range(0, len(stream), 50):
        for ev in stream[i:i + 50]:
            stream_step(cluster, builder.store, scorer, ev)
        out = scorer.dispatch()
        assert len(out) == 7
    assert scorer.dispatches == 1 + len(stream) // 50
    _assert_same_by_id(scorer.rescore(),
                       st.StreamingScorer(builder.store, cfg,
                                          device="cpu").rescore())


def test_backpressure_coalesces_and_serve_newest_fetches_inflight(monkeypatch):
    cfg = load_settings(serve_pipeline_depth=2, **SMALL)
    cluster, builder, _ = _world(PORT_PKG, cfg)
    scorer = st.StreamingScorer(builder.store, cfg, device="cpu")
    scorer.rescore()
    monkeypatch.setattr(scorer, "_tick_ready", lambda handles: False)
    stream = list(churn_events(cluster, 120, seed=3,
                               incident_ids=tuple(builder.store.incident_ids())))
    dispatched = coalesced = 0
    for ev in stream:
        stream_step(cluster, builder.store, scorer, ev)
        r = scorer.tick_async()
        dispatched += r["dispatched"]
        coalesced += r["coalesced"]
        assert r["inflight"] <= 2
    assert (dispatched, coalesced) == (2, len(stream) - 2)
    assert scorer.coalesced_ticks == coalesced
    monkeypatch.undo()

    # no delta was dropped: the caller boundary equals a fresh rebuild
    fresh = st.StreamingScorer(builder.store, cfg, device="cpu").rescore()
    out = scorer.serve()
    assert not out["newest_fetch"]
    _assert_same_by_id(out, fresh)
    # nothing pending + a tick in flight: serve(newest=True) fetches it
    scorer.tick_async()
    d0 = scorer.dispatches
    newest = scorer.serve(newest=True)
    assert newest["newest_fetch"] and scorer.dispatches == d0
    _assert_same_by_id(newest, fresh)


def test_width_growth_and_ladder_exhaustion_stay_correct(monkeypatch):
    cfg = load_settings(**SMALL)
    cluster, builder, incidents = _world(PORT_PKG, cfg)
    store = builder.store
    scorer = st.StreamingScorer(store, cfg, device="cpu")
    scorer.rescore()
    w0 = scorer.width
    inc_nid = f"incident:{incidents[0].id}"

    def pump(limit):
        added = 0
        for key in sorted(cluster.pods):
            if added > limit:
                break
            ns, name = key.split("/", 1)
            pid = gids.pod_id(ns, name)
            if store.get_node(pid) is None:
                continue
            if store.upsert_relations([GraphRelation(
                    source_id=inc_nid, target_id=pid,
                    relation_type="AFFECTS")]):
                if scorer.add_evidence(inc_nid, pid):
                    added += 1

    pump(w0)
    assert scorer.width > w0 and scorer.rebuilds == 0
    _assert_same_by_id(scorer.rescore(),
                       st.StreamingScorer(store, cfg, device="cpu").rescore())

    # a ladder whose top is the current width: growth escalates to rebuild
    monkeypatch.setattr(st, "_WIDTH_BUCKETS", (scorer.width,))
    with pytest.raises(st.NeedsRebuild):
        scorer._grow_width()
    pump(scorer.width)
    assert scorer.rebuilds >= 1
    _assert_same_by_id(scorer.rescore(),
                       st.StreamingScorer(store, cfg, device="cpu").rescore())
    monkeypatch.setattr(st, "_PAIR_WIDTH_BUCKETS", (scorer.pair_width,))
    with pytest.raises(st.NeedsRebuild):
        scorer._grow_pair_width()


def _journal_only(pkg):
    """A scorer that sees churn only by draining the store journal (sync),
    beside the scorer that stream_step mirrors directly."""
    cfg = importlib.import_module(pkg + ".config").load_settings(**SMALL)
    stream_mod = importlib.import_module(pkg + ".simulator.stream")
    scorer_cls = importlib.import_module(pkg + ".rca.streaming").StreamingScorer
    cluster, builder, incidents = _world(pkg, cfg)
    kw = {"device": "cpu"} if pkg == PORT_PKG else {}
    now = cluster.now.timestamp()
    direct = scorer_cls(builder.store, cfg, now_s=now, **kw)
    journal = scorer_cls(builder.store, cfg, now_s=now, **kw)
    for ev in stream_mod.churn_events(
            cluster, 200, seed=7,
            incident_ids=tuple(f"incident:{i.id}" for i in incidents)):
        stream_mod.stream_step(cluster, builder.store, direct, ev)
    res = journal.sync()
    assert res["applied"] > 0 and not res["rebuilt"] and journal.syncs == 1
    return journal.rescore(), direct.rescore()


def test_journal_sync_matches_jax_journal_sync():
    """sync() drains the store journal through the mutation API exactly as
    the JAX package's does (both the journal-fed and the directly
    mirrored scorer equal their JAX counterparts)."""
    port_journal, port_direct = _journal_only(PORT_PKG)
    jax_journal, jax_direct = _journal_only(JAX_PKG)
    _assert_positional([port_journal, port_direct], [jax_journal, jax_direct],
                       "journal sync")


def test_nonfinite_delta_is_refused_before_it_lands():
    cfg = load_settings(**SMALL)
    _, builder, _ = _world(PORT_PKG, cfg)
    scorer = st.StreamingScorer(builder.store, cfg, device="cpu")
    scorer.finite_delta_guard = True
    row = next(iter(scorer._id_to_idx.values()))
    before = scorer._features_dev[row].clone()
    bad = np.full(scorer.snapshot.features.shape[1], np.nan, np.float32)
    scorer._pending_feat[row] = bad
    with pytest.raises(st.NonFiniteDelta):
        scorer.dispatch()
    assert scorer._features_dev[row].equal(before)


def test_feature_stage_latest_wins_and_drains_with_sentinels():
    stage = st.FeatureStage(dim=3, capacity=1)
    stage[5] = [1, 2, 3]
    stage[2] = [4, 5, 6]
    stage[5] = [7, 8, 9]          # overwrites in place, keeps its slot
    assert len(stage) == 2
    idx = np.empty(4, np.int32)
    rows = np.empty((4, 3), np.float32)
    assert stage.drain_into(idx, rows, sentinel=99) == 2
    assert idx.tolist() == [5, 2, 99, 99]
    assert rows.tolist() == [[7, 8, 9], [4, 5, 6], [0, 0, 0], [0, 0, 0]]
    assert len(stage) == 0
