"""The port's learned scorer on a mesh (``rca/gnn_streaming.py`` with a
graph-sharded mirror, ``parallel/sharded_streaming.sharded_gnn_tick`` on
repeated ``cpu`` positions, the kernels' plain versions) against the port
at D = 1 and the JAX package's sharded scorer on its 8-device virtual
mesh, on ``tests/test_sharded_streaming.py``'s contracts: a fresh mirror
bit-identical to D = 1 (and its layout equal to JAX's); under churn the
verdicts equal D = 1's and JAX's, probs at float tolerance; bit-identical
across pipeline depths; the ladder-overflow re-mirror; the dp-only mesh's
logged single-device fallback; the tiers on a sharded mirror; the ring's
census and the kernels a tick launches; the sharded tick's price."""
import importlib
import logging

import numpy as np
import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu_torch.config import load_settings
from kubernetes_aiops_evidence_graph_tpu_torch.kernels import fused_tick
from kubernetes_aiops_evidence_graph_tpu_torch.kernels import gms
from kubernetes_aiops_evidence_graph_tpu_torch.parallel import compat
from kubernetes_aiops_evidence_graph_tpu_torch.parallel import mesh as pmesh
from kubernetes_aiops_evidence_graph_tpu_torch.parallel import (
    sharded_streaming as tss)
from kubernetes_aiops_evidence_graph_tpu_torch.parallel.compat import Sharded
from kubernetes_aiops_evidence_graph_tpu_torch.rca import gnn_streaming as tgs
from kubernetes_aiops_evidence_graph_tpu_torch.rca.gnn_backend import (
    SHIPPED_CHECKPOINT, load_validated_checkpoint)
from tests.test_torch_streaming import JAX_PKG, PORT_PKG, SMALL, _world

torch.set_num_threads(1)

LAYERS = 3   # the shipped checkpoint's


@pytest.fixture(autouse=True)
def host_pool(monkeypatch):
    """A fresh CPU pool of 8 positions (the JAX conftest's 8 host
    devices), committed by the first mesh."""
    monkeypatch.setattr(pmesh, "_HOST_POOL",
                        {"devices": 8, "committed": False})


@pytest.fixture(scope="module")
def params():
    """The shipped weights as numpy (both packages take them)."""
    return load_validated_checkpoint(SHIPPED_CHECKPOINT)


def _scorer(pkg, params, shards, depth=2, num_pods=120, **over):
    cfg = importlib.import_module(pkg + ".config").load_settings(
        serve_graph_shards=shards, serve_pipeline_depth=depth, **SMALL,
        **over)
    cluster, builder, incidents = _world(pkg, cfg, num_pods=num_pods)
    cls = importlib.import_module(pkg + ".rca.gnn_streaming"
                                  ).GnnStreamingScorer
    kw = {"device": "cpu"} if pkg == PORT_PKG else {}
    scorer = cls(builder.store, cfg, params=params,
                 now_s=cluster.now.timestamp(), **kw)
    return scorer, cluster, builder, incidents


def _churn(pkg, scorer, cluster, builder, incidents, events=120, seed=29,
           every=None):
    """A seeded full-mix churn: tick_async after every event, or (with
    ``every``) a rescore() every ``every`` events. Returns the rescores."""
    stream = importlib.import_module(pkg + ".simulator.stream")
    outs = []
    for i, ev in enumerate(stream.churn_events(
            cluster, events, seed=seed,
            incident_ids=tuple(f"incident:{i.id}" for i in incidents))):
        stream.stream_step(cluster, builder.store, scorer, ev)
        if every is None:
            scorer.tick_async()
        elif (i + 1) % every == 0:
            outs.append(scorer.rescore())
    return outs + [scorer.rescore()]


def _host(t):
    if isinstance(t, Sharded):
        return np.concatenate([b.numpy() for b in t.blocks[0]])
    return np.array(t.cpu() if isinstance(t, torch.Tensor) else t, copy=True)


def _mirror(scorer):
    return {"arrays": [_host(getattr(scorer, a)) for a in (
                "_esrc_dev", "_edst_dev", "_erel_dev", "_emask_dev",
                "_kind_dev", "_nmask_dev")],
            "rel_offsets": tuple(scorer._rel_offsets),
            "pe_shard": scorer._pe_shard,
            "free": [list(f) for f in scorer._free_edge_slots],
            "slots": dict(scorer._edge_slot)}


def _assert_same_mirror(mine, ref, what):
    for key in ("rel_offsets", "pe_shard", "free", "slots"):
        assert mine[key] == ref[key], (key, what)
    for a, b in zip(mine["arrays"], ref["arrays"]):
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=what)


def _by_id(out, key):
    rows = {iid: i for i, iid in enumerate(out["incident_ids"])}
    return np.asarray(out[key])[[rows[i] for i in sorted(rows)]]


def _assert_verdicts(mine, ref, what, rtol=2e-4, atol=1e-6):
    assert sorted(mine["incident_ids"]) == sorted(ref["incident_ids"]), what
    for key in ("top_rule_index", "any_match"):
        np.testing.assert_array_equal(_by_id(mine, key), _by_id(ref, key),
                                      err_msg=f"{key} ({what})")
    np.testing.assert_allclose(_by_id(mine, "probs"), _by_id(ref, "probs"),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("shards", [2, 4])
def test_fresh_mirror_bit_identical_to_d1_and_its_layout_equal_to_jax(
        params, shards):
    """Each region keeps its destinations' edges in store order, so a
    freshly mirrored sharded tick's probs equal D = 1's bit for bit; the
    sharded mirror (arrays, offsets, free lists, slots) equals the JAX
    sharded scorer's, and the probs agree within 1e-5."""
    sharded, *_ = _scorer(PORT_PKG, params, shards)
    assert sharded._mirror_sharded
    assert sharded.mesh.shape == {"dp": 1, "graph": shards}
    assert isinstance(sharded._esrc_dev, Sharded)
    assert sharded._esrc_dev.blocks.shape == (1, shards)
    single, *_ = _scorer(PORT_PKG, params, 1)
    got = sharded.rescore()
    assert np.array_equal(got["probs"], single.rescore()["probs"])
    ref_scorer, *_ = _scorer(JAX_PKG, params, shards)
    _assert_same_mirror(_mirror(sharded), _mirror(ref_scorer), "fresh")
    _assert_verdicts(got, ref_scorer.rescore(), "vs JAX", rtol=1e-5,
                     atol=1e-5)


def test_an_axis_that_does_not_divide_the_nodes_keeps_one_mirror(params):
    """serve_graph_shards=3 over a 512-row node bucket: the base scorer
    serves its (1 x 3) mesh with the feature table whole at each position,
    the learned mirror stays single-device (its delta uploads on its own)
    and serves D = 1's bits, through churn."""
    scorer, cluster, builder, incidents = _scorer(PORT_PKG, params, 3)
    assert scorer.mesh.shape == {"dp": 1, "graph": 3}
    assert not scorer._mirror_sharded
    assert isinstance(scorer._features_dev, Sharded)
    assert scorer._features_dev.placement.axis is None
    single = _scorer(PORT_PKG, params, 1)
    assert np.array_equal(scorer.rescore()["probs"],
                          single[0].rescore()["probs"])
    got = _churn(PORT_PKG, scorer, cluster, builder, incidents, events=40)
    ref = _churn(PORT_PKG, *single, events=40)
    assert np.array_equal(_by_id(got[-1], "probs"), _by_id(ref[-1], "probs"))


def test_churn_verdicts_equal_d1_and_depths_bit_equal(params):
    """Under pipelined churn (tick_async after every event) D = 2 at
    depths 1 and 2 is bit-identical; against D = 1 the verdicts are equal
    and the probs within rtol 2e-4 / atol 1e-6."""
    runs = {}
    for shards, depth in ((2, 1), (2, 2), (1, 1)):
        world = _scorer(PORT_PKG, params, shards, depth)
        world[0].rescore()
        runs[shards, depth] = _churn(PORT_PKG, *world)[-1]
    assert runs[2, 1]["incident_ids"] == runs[2, 2]["incident_ids"]
    assert np.array_equal(runs[2, 1]["probs"], runs[2, 2]["probs"])
    _assert_verdicts(runs[2, 1], runs[1, 1], "D=2 vs D=1")


def test_churn_mirror_and_verdicts_equal_jax_sharded_scorer(params):
    """The same churn through both packages' D = 2 scorers, rescored every
    30 events (ticks at fixed events): at every rescore the sharded
    mirror (arrays, free lists, slots) is equal, the verdicts are equal
    and the probs within 1e-5."""
    outs, mirrors = {}, {}
    for pkg in (PORT_PKG, JAX_PKG):
        scorer, cluster, builder, incidents = _scorer(pkg, params, 2)
        outs[pkg] = [scorer.rescore()] + _churn(
            pkg, scorer, cluster, builder, incidents, every=30)
        mirrors[pkg] = _mirror(scorer)
    assert len(outs[PORT_PKG]) == len(outs[JAX_PKG]) == 6
    _assert_same_mirror(mirrors[PORT_PKG], mirrors[JAX_PKG], "after churn")
    for k, (mine, ref) in enumerate(zip(outs[PORT_PKG], outs[JAX_PKG])):
        _assert_verdicts(mine, ref, f"rescore {k}", rtol=1e-5, atol=1e-5)


def test_a_shard_delta_past_the_ladder_re_mirrors(params, monkeypatch):
    """A per-shard edge delta beyond the top of the delta ladder resets
    the mirror (one re-mirror, nothing pending) and the verdicts equal a
    fresh scorer's on the same store."""
    scorer, cluster, builder, incidents = _scorer(PORT_PKG, params, 2)
    scorer.rescore()
    monkeypatch.setattr(tgs, "_DELTA_BUCKETS", (4, 8))
    builds = scorer.mirror_builds
    stream = importlib.import_module(PORT_PKG + ".simulator.stream")
    for ev in stream.churn_events(
            cluster, 60, seed=31,
            incident_ids=tuple(f"incident:{i.id}" for i in incidents)):
        stream.stream_step(cluster, builder.store, scorer, ev)
    scorer._drain_edges()           # the store journal onto the mirror
    assert scorer.mirror_builds == builds
    per_shard = np.bincount([slot // scorer._pe_shard
                             for slot in scorer._pending_edges], minlength=2)
    assert per_shard.max() > 8, per_shard
    got = scorer.rescore()
    assert scorer.mirror_builds == builds + 1
    assert scorer._pending_edges == {}
    monkeypatch.undo()
    fresh = tgs.GnnStreamingScorer(
        builder.store, scorer.settings, params=params,
        now_s=cluster.now.timestamp(), device="cpu").rescore()
    _assert_verdicts(got, fresh, "after the re-mirror", rtol=1e-5, atol=1e-5)


def test_dp_only_mesh_warns_and_serves_one_device(params, caplog):
    """A mesh without a real graph axis has no sharded learned mapping:
    logged, served on one device with D = 1's bits. A live reshard
    (adopt_mesh) onto a (1 x 2) mesh re-buckets the mirror into two
    shards and serves a fresh D = 2 build's bits (which are D = 1's); a
    dp-only mesh adopted is one device again."""
    _, cluster, builder, _ = _scorer(PORT_PKG, params, 1)
    mesh = pmesh.make_mesh(2, 1, ["cpu"] * 2)
    with caplog.at_level(logging.WARNING):
        scorer = tgs.GnnStreamingScorer(
            builder.store, load_settings(**SMALL), params=params,
            now_s=cluster.now.timestamp(), mesh=mesh)
    assert "gnn_streaming_mesh_unsupported" in caplog.text
    assert scorer.mesh is None and not scorer._mirror_sharded
    single = tgs.GnnStreamingScorer(
        builder.store, load_settings(**SMALL), params=params,
        now_s=cluster.now.timestamp(), device="cpu")
    assert np.array_equal(scorer.rescore()["probs"],
                          single.rescore()["probs"])
    builds = scorer.mirror_builds
    with scorer.serve_lock:
        scorer.adopt_mesh(pmesh.make_mesh(1, 2, ["cpu"] * 2))
    assert scorer._graph_size() == 2 and scorer._mirror_sharded
    assert isinstance(scorer._esrc_dev, Sharded)
    assert scorer.mirror_builds == builds + 1
    fresh = tgs.GnnStreamingScorer(
        builder.store, load_settings(**SMALL), params=params,
        now_s=cluster.now.timestamp(),
        mesh=pmesh.make_mesh(1, 2, ["cpu"] * 2))
    want = single.rescore()["probs"]
    assert np.array_equal(fresh.rescore()["probs"], want)
    assert np.array_equal(scorer.rescore()["probs"], want)
    with scorer.serve_lock:
        scorer.adopt_mesh(mesh)
    assert scorer.mesh is None and not scorer._mirror_sharded
    assert np.array_equal(scorer.rescore()["probs"], want)


def test_tiers_on_a_sharded_mirror_serve_the_sharded_tick(params,
                                                          monkeypatch):
    """The fused, streamed and int8 tiers are single-device layouts: on a
    sharded mirror they all serve the sharded composed tick (no fused or
    streamed kernel call, no quantized table), with its bits."""
    def refuse(*a, **k):
        raise AssertionError("a single-device tier ran on a sharded mirror")
    monkeypatch.setattr(fused_tick, "fused_gnn_tick", refuse)
    monkeypatch.setattr(fused_tick, "fused_gnn_tick_dma", refuse)
    base, *_ = _scorer(PORT_PKG, params, 2)
    want = base.rescore()["probs"]
    for over in (dict(gnn_fused_tick=True), dict(gnn_tick_dma=True),
                 dict(gnn_tick_dma=True, gnn_feature_quant="int8")):
        scorer, *_ = _scorer(PORT_PKG, params, 2, **over)
        assert not scorer._fused_ok() and not scorer._dma_ok()
        assert scorer._features_q_dev is None
        assert scorer._tick_entrypoint() == "streaming.gnn_tick.sharded"
        assert np.array_equal(scorer.rescore()["probs"], want), over


@pytest.mark.parametrize("shards", [2, 4])
def test_ring_census_and_kernels_a_tick(params, monkeypatch, shards):
    """A tick makes (LAYERS + 1) * D ring hops and no all-gather, and runs
    the message pass 3 * D times (LAYERS a position), B1's partial fold D
    times and its tail once, the D = 1 path's kernels never."""
    calls = {"gms": 0, "partial": 0, "tail": 0, "fold": 0}

    def counted(name, fn):
        def wrap(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrap
    monkeypatch.setattr(gms, "gather_matmul_segment",
                        counted("gms", gms.gather_matmul_segment))
    monkeypatch.setattr(tss, "rules_fold_partial_packed",
                        counted("partial", tss.rules_fold_partial_packed))
    monkeypatch.setattr(tss, "rules_tail", counted("tail", tss.rules_tail))
    monkeypatch.setattr(tss, "rules_fold", counted("fold", tss.rules_fold))
    scorer, cluster, builder, incidents = _scorer(PORT_PKG, params, shards)
    scorer.rescore()
    hops, gathers = compat.ring_hops, compat.all_gathers
    calls.update(gms=0, partial=0, tail=0, fold=0)
    d0 = scorer.dispatches
    _churn(PORT_PKG, scorer, cluster, builder, incidents, events=20)
    n = scorer.dispatches - d0
    assert n > 0
    assert compat.ring_hops - hops == (LAYERS + 1) * shards * n
    assert compat.all_gathers == gathers
    assert calls == {"gms": LAYERS * shards * n, "partial": shards * n,
                     "tail": n, "fold": 0}


def test_sharded_tick_priced_under_its_entry_point(params):
    """The learned tick on a mesh prices as ``streaming.gnn_tick.sharded``
    (``device_metrics.tick_cost``): D positions of B2 at (Pn/D, Pe_shard),
    the ring's (LAYERS + 1) * D block copies as collective bytes, the
    embed, the update and one readout."""
    from kubernetes_aiops_evidence_graph_tpu_torch.observability import (
        scope as t_scope)
    from kubernetes_aiops_evidence_graph_tpu_torch.rca import (
        device_metrics as dm)
    scorer, *_ = _scorer(PORT_PKG, params, 2, scope_telemetry=True)
    scorer.rescore()
    entry = "streaming.gnn_tick.sharded"
    assert scorer._scope_entry == entry
    pn, pi, pe, pk, ek, shards = scorer._scope_key
    assert (shards, pe) == (2, scorer._pe_shard)
    want = dm.tick_cost(entry, pn=pn, pi=pi, pe=pe, pk=pk, ek=ek,
                        hidden=64, layers=LAYERS, shards=shards)
    rec = t_scope.ROOFLINE.priced(entry)[scorer._scope_key]
    assert rec["hbm_bytes"] == want["bytes"] > 0
    assert rec["collective_bytes"] == want["collective_bytes"] == (
        (LAYERS + 1) * shards * (pn // shards) * 64 * 4)
    assert set(want["terms"]) == {"delta", "degree", "embed", "assemble",
                                  "B2", "update", "ring", "readout"}
    nps = pn // shards
    b2 = (pe * 64 * 4 + pe * 12 + dm.NUM_RELS * 64 * 64 * 4 + nps * 64 * 4,
          2 * pe * 64 * 64)
    assert want["terms"]["B2"] == (LAYERS * shards * b2[0],
                                   LAYERS * shards * b2[1])
    assert want["flops"] >= LAYERS * shards * b2[1]
