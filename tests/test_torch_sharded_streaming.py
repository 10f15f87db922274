"""The port's mesh-resident rules scorer (``rca/streaming.py`` on a
``parallel/`` mesh of repeated ``cpu`` positions, the kernels' plain
versions) against the JAX package's on its 8-device virtual mesh and
against the port at D = 1, on ``tests/test_sharded_streaming.py``'s
contracts: bit-identical verdicts at every ``rescore()`` of a seeded
full-mix churn with a mid-script rebuild, at D ∈ {2, 4} × depth ∈ {1, 2};
the placement surviving the rebuild; the delta router's journal order
and per-shard ladder; the pool and its logged fallback; the pack at
D = 2; the worker's mesh."""
import importlib
import logging

import numpy as np
import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu_torch.config import load_settings
from kubernetes_aiops_evidence_graph_tpu_torch.ladders import DELTA_BUCKETS
from kubernetes_aiops_evidence_graph_tpu_torch.parallel import mesh as pmesh
from kubernetes_aiops_evidence_graph_tpu_torch.parallel.compat import Sharded
from kubernetes_aiops_evidence_graph_tpu_torch.rca.streaming import (
    StreamingScorer)
from tests.test_torch_streaming import (
    JAX_PKG, PORT_PKG, RESULT_KEYS, TIGHT, _assert_positional, _world)

# one intra-op thread: these tensors are small, and the suite runs
# several pytest workers side by side on the host's cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def host_pool(monkeypatch):
    """A fresh CPU pool of 8 positions (the counterpart of the JAX
    conftest's 8 forced host devices), committed by the first mesh."""
    monkeypatch.setattr(pmesh, "_HOST_POOL",
                        {"devices": 8, "committed": False})


def _run_script(pkg, shards, depth, events=400, seed=13,
                checkpoint_every=100):
    """tests/test_sharded_streaming.py::_run_script in ``pkg``: one seeded
    full-mix churn, tick_async after every event, rescore() at fixed
    checkpoints."""
    cfg = importlib.import_module(pkg + ".config").load_settings(
        serve_graph_shards=shards, serve_pipeline_depth=depth, **TIGHT)
    stream_mod = importlib.import_module(pkg + ".simulator.stream")
    cls = importlib.import_module(pkg + ".rca.streaming").StreamingScorer
    cluster, builder, incidents = _world(pkg, cfg, seed=seed)
    kw = {"device": "cpu"} if pkg == PORT_PKG else {}
    scorer = cls(builder.store, cfg, now_s=cluster.now.timestamp(), **kw)
    if shards > 1:
        assert scorer._graph_sharded(scorer.snapshot.padded_nodes,
                                     scorer.snapshot.padded_incidents)
    outs = [scorer.rescore()]
    stream = list(stream_mod.churn_events(
        cluster, events, seed=seed + 1,
        incident_ids=tuple(f"incident:{i.id}" for i in incidents)))
    for i, ev in enumerate(stream):
        stream_mod.stream_step(cluster, builder.store, scorer, ev)
        scorer.tick_async()
        if (i + 1) % checkpoint_every == 0:
            outs.append(scorer.rescore())
    outs.append(scorer.rescore())
    return outs, scorer


@pytest.fixture(scope="module")
def single():
    """The port at D = 1 (the reference every mesh run is held to)."""
    outs, scorer = _run_script(PORT_PKG, 1, 1)
    assert scorer.rebuilds > 0, "no mid-script rebuild: premise broken"
    return outs, scorer.rebuilds


@pytest.mark.parametrize("shards,depth", [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_sharded_rules_bit_parity_with_d1_and_jax(single, shards, depth):
    """THE contract: the graph-sharded scorer's verdicts equal the D = 1
    scorer's and the JAX sharded scorer's at every rescore(), across a
    mid-script rebuild."""
    base, rebuilds = single
    outs, scorer = _run_script(PORT_PKG, shards, depth)
    assert scorer.rebuilds == rebuilds
    assert isinstance(scorer._features_dev, Sharded)
    _assert_positional(outs, base, f"D={shards} depth={depth} vs D=1")
    jax_outs, jax_scorer = _run_script(JAX_PKG, shards, depth)
    assert jax_scorer.rebuilds == rebuilds
    _assert_positional(outs, jax_outs, f"D={shards} depth={depth} vs JAX")


def test_placement_survives_rebuild():
    """The resident features stay D node blocks on their positions (and
    the tables dp row blocks) across a bucket-overflow rebuild."""
    from kubernetes_aiops_evidence_graph_tpu_torch.collectors import (
        collect_all, default_collectors)
    from kubernetes_aiops_evidence_graph_tpu_torch.simulator import inject
    cfg = load_settings(serve_graph_shards=4, **TIGHT)
    cluster, builder, _ = _world(PORT_PKG, cfg)
    scorer = StreamingScorer(builder.store, cfg, device="cpu")
    scorer.rescore()

    def placed():
        f = scorer._features_dev
        assert f.placement.axis == "graph"
        assert f.blocks.shape == (1, 4)
        nps = scorer.snapshot.padded_nodes // 4
        assert all(b.shape[0] == nps for b in f.blocks.ravel())
        for name in ("_ev_idx_dev", "_ev_cnt_dev", "_pair_dev", "_chain0"):
            assert getattr(scorer, name).placement.axis == "dp", name
        # the blocks ARE the feature table, split
        np.testing.assert_array_equal(
            torch.cat(list(f.blocks[0])).numpy(), scorer.snapshot.features)

    placed()
    assert scorer.mesh.shape == {"dp": 1, "graph": 4}
    rng = np.random.default_rng(31)
    keys = sorted(cluster.deployments)
    k = 0
    while scorer.rebuilds == 0:
        k += 1
        assert k < 40, "no rebuild after 40 ingests (premise broken)"
        inc = inject(cluster, ("oom", "network")[k % 2],
                     keys[(k * 3) % len(keys)], rng)
        builder.ingest(inc, collect_all(
            inc, default_collectors(cluster, cfg), parallel=False))
        scorer.serve()
    placed()
    fresh = StreamingScorer(builder.store, load_settings(**TIGHT),
                            device="cpu").rescore()
    got = scorer.rescore()
    assert got["incident_ids"] == fresh["incident_ids"]
    for key in RESULT_KEYS:
        np.testing.assert_array_equal(got[key], fresh[key], err_msg=key)


def test_route_node_delta_journal_order_and_per_shard_ladder():
    """The sort contract and the per-shard sub-bucket
    (tests/test_sharded_streaming.py:209), equal to the JAX router."""
    from kubernetes_aiops_evidence_graph_tpu.parallel.sharded_streaming \
        import route_node_delta as jroute
    from kubernetes_aiops_evidence_graph_tpu_torch.observability import (
        scope)
    from kubernetes_aiops_evidence_graph_tpu_torch.parallel.sharded_streaming \
        import owner_of, route_node_delta
    nps, shards = 100, 4
    rows = [201, 5, 210, 399, 202, 207, 6, 250, 299]
    entries = [(r, f"payload-{i}") for i, r in enumerate(rows)]
    idx, per_shard, pk = route_node_delta(entries, nps, shards, DELTA_BUCKETS)
    jidx, jper, jpk = jroute(entries, nps, shards, DELTA_BUCKETS)
    np.testing.assert_array_equal(idx, jidx)
    assert (per_shard, pk) == (jper, jpk)
    assert scope.take_route() == (2, 0, 6, 1)
    assert pk == DELTA_BUCKETS[0]
    assert list(idx[2, :6]) == [1, 10, 2, 7, 50, 99]
    assert [e[1] for e in per_shard[2]] == [
        "payload-0", "payload-2", "payload-4", "payload-5", "payload-7",
        "payload-8"]
    assert list(idx[0, :2]) == [5, 6] and idx[3, 0] == 99
    assert (idx[1, 1:] == nps).all()
    assert owner_of(rows, nps).tolist() == [2, 0, 2, 3, 2, 2, 0, 2, 2]
    many = [(200 + i % 100, i) for i in range(80)]
    assert route_node_delta(many, nps, shards, DELTA_BUCKETS)[2] == 256
    spread = [(100 * (i % 4) + i // 4, i) for i in range(80)]
    assert route_node_delta(spread, nps, shards, DELTA_BUCKETS)[2] == 64


def test_coalescing_ladder_bounds_per_shard():
    """The coalescing bound reads the per-shard delta width
    (tests/test_sharded_streaming.py:246)."""
    cfg = load_settings(serve_graph_shards=4, **TIGHT)
    _cluster, builder, _ = _world(PORT_PKG, cfg)
    scorer = StreamingScorer(builder.store, cfg, device="cpu")
    scorer.rescore()
    nps = scorer.snapshot.padded_nodes // 4
    row = np.zeros(scorer.snapshot.features.shape[1], np.float32)
    for r in range(12):
        scorer._pending_feat[r] = row
    assert scorer._pending_feat_bound() == 12
    scorer._pending_feat.take()
    for g in range(4):
        for r in range(3):
            scorer._pending_feat[g * nps + r] = row
    assert scorer._pending_feat_bound() == 3
    assert scorer._pending_delta_count() == 3
    scorer.rescore()                       # the routed tick drains them
    assert len(scorer._pending_feat) == 0


def test_ensure_host_devices_and_serving_mesh():
    """tests/test_sharded_streaming.py:302 on the port's CPU pool; the
    strict path raises MeshUnavailable where the default returns None."""
    assert pmesh.ensure_host_devices(1) and pmesh.ensure_host_devices(8)
    mesh = pmesh.serving_mesh(4, device="cpu")    # commits the pool at 8
    assert mesh is not None and mesh.shape == {"dp": 1, "graph": 4}
    assert [d.type for d in mesh.devices.ravel()] == ["cpu"] * 4
    assert not pmesh.ensure_host_devices(16), \
        "the pool cannot grow after a mesh was built from it"
    assert pmesh.serving_mesh(1, device="cpu") is None
    assert pmesh.serving_mesh(16, device="cpu") is None
    with pytest.raises(pmesh.MeshUnavailable, match="16"):
        pmesh.serving_mesh(16, device="cpu", strict=True)
    with pytest.raises(pmesh.MeshUnavailable, match="3"):
        pmesh.serving_mesh(3, devices=["cpu"] * 2, strict=True)
    explicit = pmesh.serving_mesh(2, devices=["cpu", "cpu"], strict=True)
    assert explicit.shape == {"dp": 1, "graph": 2}
    assert pmesh.make_mesh(devices=["cpu"] * 8).shape == {"dp": 4,
                                                         "graph": 2}
    with pytest.raises(ValueError):
        pmesh.make_mesh(3, 3, ["cpu"] * 8)
    # positions may repeat one card or span two: both builders make a
    # (1 x 2) mesh over cuda:0 and cuda:1 (nothing touches a device)
    cards = [torch.device("cuda", i) for i in (0, 1)]
    one = pmesh.make_mesh(1, 2, [cards[0]] * 2)
    assert list(one.devices.ravel()) == [cards[0]] * 2
    for two in (pmesh.make_mesh(1, 2, cards),
                pmesh.serving_mesh(2, devices=cards, strict=True)):
        assert two.shape == {"dp": 1, "graph": 2}
        assert list(two.devices.ravel()) == cards
        assert two.pool_index.ravel().tolist() == [0, 1]


def test_serve_graph_shards_unavailable_falls_back_single_device(caplog):
    """An impossible shard count degrades to single-device serving,
    logged, never a crash or a half-sharded state
    (tests/test_sharded_streaming.py:316)."""
    cfg = load_settings(serve_graph_shards=16, **TIGHT)
    _cluster, builder, _ = _world(PORT_PKG, cfg)
    with caplog.at_level(logging.WARNING):
        pmesh.host_devices()              # the pool is committed at 8
        scorer = StreamingScorer(builder.store, cfg, device="cpu")
    assert scorer.mesh is None
    assert "serve_graph_shards_unavailable" in caplog.text
    assert isinstance(scorer._features_dev, torch.Tensor)
    assert len(scorer.rescore()["incident_ids"]) > 0


def test_pack_at_two_shards_bit_parity_with_singles_and_jax():
    """tests/test_surge.py:104: two tenants' pack on a (1 x 2) mesh, its
    delta routed by shard, bit-identical to per-tenant snapshot scoring,
    to the pack at D = 1 and to the JAX pack at D = 2."""
    from tests import torch_surge_world as W
    out = {}
    for pkg, shards in ((PORT_PKG, 2), (PORT_PKG, 1), (JAX_PKG, 2)):
        cfg = W.settings(pkg, serve_graph_shards=shards)
        worlds = {f"t{t}": W.world(pkg, seed=t + 4, incidents=2, cfg=cfg)
                  for t in range(2)}
        stores = {t: w[1].store for t, w in worlds.items()}
        mt = W.pack(pkg, stores, cfg)
        if shards > 1:
            assert mt.mesh is not None and mt._graph_size() == 2
            assert mt._graph_sharded(mt.snapshot.padded_nodes,
                                     mt.snapshot.padded_incidents)
        if pkg == PORT_PKG and shards > 1:
            assert isinstance(mt._features_dev, Sharded)
            W.assert_snapshot_parity(mt, stores, cfg)
        # one more incident a tenant through the routed delta
        for t, (cluster, builder, _incs) in worlds.items():
            W.inject_more(pkg, cluster, builder, cfg, seed=int(t[1:]) + 4,
                          count=1)
        out[(pkg, shards)] = W.tenant_verdicts(mt, values=True)
    assert out[(PORT_PKG, 2)] == out[(PORT_PKG, 1)] == out[(JAX_PKG, 2)]


def test_worker_serves_rules_on_a_mesh_and_refuses_what_waits():
    """The worker builds its mesh from the pool for the rules backend
    (JAX workflow/worker.py:184) and for the learned scorer (:161), with
    the shield and the elastic controller too; the settings' mesh over a
    pool of two cards spans both (JAX builds it from ``jax.devices()``)."""
    from kubernetes_aiops_evidence_graph_tpu_torch.simulator import (
        generate_cluster)
    from kubernetes_aiops_evidence_graph_tpu_torch.storage import Database
    from kubernetes_aiops_evidence_graph_tpu_torch.workflow.worker import (
        IncidentWorker)
    cluster = generate_cluster(num_pods=40, seed=1)
    for over, shape in ((dict(mesh_dp=2), {"dp": 2}),
                        (dict(serve_graph_shards=2), {"dp": 1, "graph": 2}),
                        (dict(mesh_dp=2, serve_graph_shards=2),
                         {"dp": 2, "graph": 2})):
        worker = IncidentWorker(cluster, Database(":memory:"),
                                settings=load_settings(**over),
                                device="cpu")
        scorer = worker.serving_scorer()
        assert scorer.mesh is not None and scorer.mesh.shape == shape
        assert scorer._sharded(scorer.snapshot.padded_incidents)
    # the learned scorer serves on the worker's (1 x 2) mesh
    gnn_cfg = load_settings(rca_backend="gnn", serve_graph_shards=2)
    scorer = IncidentWorker(cluster, Database(":memory:"), settings=gnn_cfg,
                            device="cpu").serving_scorer()
    assert scorer.mesh is not None and scorer.mesh.shape == {"dp": 1,
                                                             "graph": 2}
    assert scorer._mirror_sharded
    assert isinstance(scorer._esrc_dev, Sharded)
    assert len(scorer.rescore()["incident_ids"]) == len(
        scorer.live_incidents()[0])
    import tempfile
    for over in (dict(shield_enabled=True, mesh_dp=2),
                 dict(elastic_enabled=True, serve_graph_shards=2),
                 dict(rca_backend="gnn", shield_enabled=True,
                      serve_graph_shards=2)):
        cfg = load_settings(shield_dir=tempfile.mkdtemp(
            prefix="kaeg-mesh-shield-"), **over)
        worker = IncidentWorker(cluster, Database(":memory:"), settings=cfg,
                                device="cpu")
        scorer = worker.serving_scorer()
        try:
            assert scorer.mesh is not None and scorer.mesh.size == 2
            assert (type(scorer).__name__ == "ShieldedScorer") == bool(
                cfg.shield_enabled)
            assert len(scorer.rescore()["incident_ids"]) == len(
                scorer.live_incidents()[0])
        finally:
            worker.close()
    # the default CUDA pool over two cards: the settings' mesh spans both
    # (built without touching a device), and a shape the pool cannot
    # carry falls back to one device, logged
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: True)
        mp.setattr(torch.cuda, "device_count", lambda: 2)
        mesh = pmesh.settings_mesh(load_settings(serve_graph_shards=2),
                                   "cuda")
        assert mesh.shape == {"dp": 1, "graph": 2}
        assert list(mesh.devices.ravel()) == [torch.device("cuda", i)
                                              for i in (0, 1)]
        dp = pmesh.settings_mesh(load_settings(mesh_dp=2), "cuda")
        assert list(dp.devices.ravel()) == [torch.device("cuda", i)
                                            for i in (0, 1)]
        assert pmesh.settings_mesh(load_settings(serve_graph_shards=4),
                                   "cuda") is None


def test_sharded_tick_priced_with_its_sum_and_routing_recorded():
    """The graph-sharded tick prices under its own entry point
    (``device_metrics.tick_cost("streaming.rules_tick.sharded")``: D
    partial folds, the sum over the graph axis as collective bytes, the
    tail), and its delta router feeds ``SHARD_DELTA_ROWS`` and the tick's
    flight record."""
    from kubernetes_aiops_evidence_graph_tpu_torch.observability import (
        metrics as t_metrics, scope as t_scope)
    from kubernetes_aiops_evidence_graph_tpu_torch.rca import (
        device_metrics as dm)
    cfg = load_settings(serve_graph_shards=2, scope_telemetry=True, **TIGHT)
    cluster, builder, _ = _world(PORT_PKG, cfg)
    scorer = StreamingScorer(builder.store, cfg, device="cpu")
    scorer.rescore()
    nps = scorer.snapshot.padded_nodes // 2
    row = np.ones(scorer.snapshot.features.shape[1], np.float32)
    for r in (1, nps + 1, nps + 2):
        scorer._pending_feat[r] = row
    scorer.rescore()
    entry = "streaming.rules_tick.sharded"
    assert scorer._scope_entry == entry
    pn, pi, width, pair_width, pk, rk, shards = scorer._scope_key
    rec = t_scope.ROOFLINE.priced(entry)[scorer._scope_key]
    want = dm.tick_cost(entry, pn=pn, pi=pi, width=width, pk=pk, rk=rk,
                        shards=shards, pair_width=pair_width)
    assert rec["hbm_bytes"] == want["bytes"] > 0
    assert rec["collective_bytes"] == want["collective_bytes"] == (
        (shards - 1) * pi * (48 + pair_width) * 4)
    assert set(want["terms"]) == {"delta", "B1.partial", "psum", "B1.tail"}
    assert t_metrics.ROOFLINE_HALO_BYTES.value(entrypoint=entry, pack="0") \
        in {r["collective_bytes"] for r in t_scope.ROOFLINE.priced(
            entry).values()}
    assert t_scope.SHARD_DELTA_ROWS.value(shard="0") == 1.0
    assert t_scope.SHARD_DELTA_ROWS.value(shard="1") == 2.0
    assert scorer._features_dev.blocks[0, 1][1].tolist() == row.tolist()
