"""The port's GnnStreamingScorer (on the CPU: the message-pass kernel's
plain version) against the JAX package's GnnStreamingScorer under the same
seeded churn, and against itself: the same mirror (device arrays, slice
offsets, free lists), probs within 1e-5, the same top-1; bit-identical at
pipeline depths 1/2/4; equal to a fresh rebuild after churn; hot swap and
rollback of the params."""
import importlib

import numpy as np
import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu_torch.config import load_settings
from kubernetes_aiops_evidence_graph_tpu_torch.rca import gnn as tgnn
from kubernetes_aiops_evidence_graph_tpu_torch.rca.gnn_backend import (
    GnnRcaBackend, SHIPPED_CHECKPOINT, load_validated_checkpoint)
from kubernetes_aiops_evidence_graph_tpu_torch.rca.gnn_streaming import (
    GnnStreamingScorer)
from kubernetes_aiops_evidence_graph_tpu_torch.simulator.stream import (
    churn_events, stream_step)
from tests.test_torch_streaming import (
    JAX_PKG, PORT_PKG, SMALL, TIGHT, _world)

# one intra-op thread: these tensors are small, and the suite runs
# several pytest workers side by side on the host's cores
torch.set_num_threads(1)

PROB_KEYS = ("probs", "top_confidence")


@pytest.fixture(scope="module")
def params():
    """The shipped weights as numpy (both packages take them)."""
    return load_validated_checkpoint(SHIPPED_CHECKPOINT)


def _scorer(pkg, store, cfg, params, now_s):
    cls = importlib.import_module(pkg + ".rca.gnn_streaming").GnnStreamingScorer
    kw = {"device": "cpu"} if pkg == PORT_PKG else {}
    return cls(store, cfg, params=params, now_s=now_s, **kw)


def _mirror(scorer):
    def host(t):   # a copy: both packages reuse the mirror's memory
        return np.array(t.cpu() if isinstance(t, torch.Tensor) else t,
                        copy=True)
    return {
        "arrays": [host(getattr(scorer, a)) for a in (
            "_esrc_dev", "_edst_dev", "_erel_dev", "_emask_dev",
            "_kind_dev", "_nmask_dev")],
        "rel_offsets": tuple(scorer._rel_offsets),
        "free": [list(f) for f in scorer._free_edge_slots],
        "slots": dict(scorer._edge_slot),
    }


def _run_script(pkg, params, depth=2, events=300, seed=21, tick=50,
                buckets=SMALL, every_event=True, num_pods=120):
    """One seeded full-mix churn script: tick_async after every event (or
    only dispatch() at the checkpoints, ``every_event=False``), rescore()
    and a mirror capture at every ``tick`` events."""
    cfg = importlib.import_module(pkg + ".config").load_settings(
        serve_pipeline_depth=depth, **buckets)
    stream_mod = importlib.import_module(pkg + ".simulator.stream")
    cluster, builder, incidents = _world(pkg, cfg, seed=seed,
                                         num_pods=num_pods)
    now = cluster.now.timestamp()
    scorer = _scorer(pkg, builder.store, cfg, params, now)
    outs, mirrors = [scorer.rescore()], [_mirror(scorer)]
    stream = list(stream_mod.churn_events(
        cluster, events, seed=seed + 1,
        incident_ids=tuple(f"incident:{i.id}" for i in incidents)))
    for i, ev in enumerate(stream):
        stream_mod.stream_step(cluster, builder.store, scorer, ev)
        if every_event:
            scorer.tick_async()
        if (i + 1) % tick == 0:
            outs.append(scorer.rescore())
            mirrors.append(_mirror(scorer))
    fresh = _scorer(pkg, builder.store, cfg, params, now)
    return outs, mirrors, scorer, fresh.rescore()


def _assert_probs(mine, ref, what, exact=False, rtol=1e-5, atol=1e-5):
    a = {iid: i for i, iid in enumerate(mine["incident_ids"])}
    b = {iid: i for i, iid in enumerate(ref["incident_ids"])}
    assert a.keys() == b.keys(), what
    ia, ib = [a[i] for i in a], [b[i] for i in a]
    for key in PROB_KEYS:
        x, y = np.asarray(mine[key])[ia], np.asarray(ref[key])[ib]
        if exact:
            np.testing.assert_array_equal(x, y, err_msg=f"{key} ({what})")
        else:
            np.testing.assert_allclose(x, y, rtol=rtol, atol=atol,
                                       err_msg=f"{key} ({what})")
    np.testing.assert_array_equal(np.asarray(mine["top_rule_index"])[ia],
                                  np.asarray(ref["top_rule_index"])[ib],
                                  err_msg=f"top-1 ({what})")


def test_port_equals_jax_gnn_streaming_scorer_under_churn(params):
    """Same world, same churn, same tick boundaries: the mirror (device
    arrays, offsets, free lists, edge slots) is equal to the JAX scorer's at
    every caller boundary, probs agree within 1e-5 and top-1 is equal.
    Ticks land at fixed events (no pipelining): when the mirror drains the
    journal decides which adds of since-removed endpoints it skips, and so
    the order of its free lists."""
    jax_outs, jax_mirrors, jax_scorer, _ = _run_script(
        JAX_PKG, params, every_event=False)
    outs, mirrors, scorer, fresh = _run_script(PORT_PKG, params,
                                               every_event=False)
    assert len(outs) == len(jax_outs) == 7
    for gen, (m, jm) in enumerate(zip(mirrors, jax_mirrors)):
        assert m["rel_offsets"] == jm["rel_offsets"], gen
        assert m["free"] == jm["free"], gen
        assert m["slots"] == jm["slots"], gen
        for a, b in zip(m["arrays"], jm["arrays"]):
            np.testing.assert_array_equal(a, b.astype(a.dtype),
                                          err_msg=f"mirror (gen {gen})")
    for gen, (mine, ref) in enumerate(zip(outs, jax_outs)):
        _assert_probs(mine, ref, f"port vs JAX, gen {gen}")
    assert scorer.mirror_edge_rows() == jax_scorer.mirror_edge_rows()
    # the churned state serves what a fresh scorer of the final store does
    # (slot reuse orders a destination's sum unlike a fresh layout)
    _assert_probs(outs[-1], fresh, "final vs fresh rebuild", rtol=1e-4)


def test_depth_parity_bit_identical_and_rebuild_parity(params):
    """Pipeline depths 1/2/4 give the same probs bit for bit at every caller
    boundary, through a mid-script rebuild (tight buckets); the final
    state equals a fresh rebuild (rtol 1e-4 / atol 1e-5: slot reuse orders
    a destination's sum differently from a fresh layout)."""
    script = dict(events=400, seed=13, tick=80, buckets=TIGHT, num_pods=150)
    base, _, s1, fresh = _run_script(PORT_PKG, params, depth=1, **script)
    assert s1.rebuilds >= 1, "tight buckets should force a rebuild"
    for depth in (2, 4):
        outs, _, scorer, _ = _run_script(PORT_PKG, params, depth=depth,
                                         **script)
        assert scorer.rebuilds == s1.rebuilds
        for gen, (a, b) in enumerate(zip(base, outs)):
            _assert_probs(b, a, f"depth {depth}, gen {gen}", exact=True)
    _assert_probs(base[-1], fresh, "final vs fresh rebuild", rtol=1e-4)


def test_dispatch_loop_mirror_tracks_store_and_snapshot_backend(params):
    """The benchmark's loop (one dispatch() per 50 events): the mirror's
    directed edge set equals the store's, and the final verdicts equal a
    GnnRcaBackend pass over a fresh snapshot of the same store."""
    from kubernetes_aiops_evidence_graph_tpu_torch.graph import build_snapshot
    cfg = load_settings(**SMALL)
    cluster, builder, _ = _world(PORT_PKG, cfg, seed=11, num_pods=100)
    now = cluster.now.timestamp()
    scorer = GnnStreamingScorer(builder.store, cfg, params=params, now_s=now,
                                device="cpu")
    scorer.rescore()
    stream = list(churn_events(cluster, 200, seed=12,
                               incident_ids=tuple(builder.store.incident_ids())))
    for i in range(0, len(stream), 50):
        for ev in stream[i:i + 50]:
            stream_step(cluster, builder.store, scorer, ev)
        scorer.dispatch()
    _, edges = builder.store._raw()
    want = set()
    for e in edges:
        s, d = scorer._id_to_idx[e.src], scorer._id_to_idx[e.dst]
        want |= {(s, d), (d, s)}
    assert scorer.mirror_edge_rows() == want
    live = scorer._emask_dev.numpy() > 0
    got = set(zip(scorer._esrc_dev.numpy()[live].tolist(),
                  scorer._edst_dev.numpy()[live].tolist()))
    assert got == want
    out = scorer.rescore()
    snap = build_snapshot(builder.store, cfg, now_s=now)
    cold = GnnRcaBackend(params=params, settings=cfg,
                         device="cpu").score_snapshot(snap)
    _assert_probs(out, cold, "streaming vs snapshot backend", rtol=1e-4)


def test_swap_and_rollback_params(params):
    cfg = load_settings(**SMALL)
    cluster, builder, _ = _world(PORT_PKG, cfg, seed=5, num_pods=100)
    now = cluster.now.timestamp()
    scorer = GnnStreamingScorer(builder.store, cfg, params=params, now_s=now,
                                device="cpu")
    first = scorer.rescore()
    assert first["params_generation"] == 0
    other = tgnn.init_params(torch.Generator().manual_seed(3))
    scorer.tick_async()                     # in flight on generation 0
    assert scorer.swap_params(other, source="candidate") == 1
    swapped = scorer.rescore()
    assert swapped["params_generation"] == 1
    want = GnnStreamingScorer(builder.store, cfg, params=other, now_s=now,
                              device="cpu").rescore()
    _assert_probs(swapped, want, "swapped", exact=True)
    assert scorer.rollback_params() == 2
    assert scorer.rollback_params() is None
    _assert_probs(scorer.rescore(), first, "rolled back", exact=True)
    wrong = tgnn.init_params(torch.Generator().manual_seed(3), hidden=32)
    with pytest.raises(ValueError, match="hot swap rejected"):
        scorer.swap_params(wrong)
    assert scorer.params_generation == 2


def test_gnn_delta_rides_the_base_slab(params, monkeypatch):
    """One staged slab per tick carries the base delta AND the GNN delta:
    the split hands the GNN tick exactly the ints _packed_gnn_delta
    packed, and the verdicts equal a fresh scorer's."""
    from kubernetes_aiops_evidence_graph_tpu_torch.rca import streaming as st
    cfg = load_settings(**SMALL)
    cluster, builder, _ = _world(PORT_PKG, cfg, seed=7, num_pods=100)
    now = cluster.now.timestamp()
    scorer = GnnStreamingScorer(builder.store, cfg, params=params, now_s=now,
                                device="cpu")
    scorer.rescore()
    packed, split = [], []
    pack = scorer._packed_gnn_delta
    monkeypatch.setattr(scorer, "_packed_gnn_delta",
                        lambda rows: packed.append(pack(rows)) or packed[-1])
    real = st._delta_pack

    def recorder(slab, li, pk, dim, gi=0):
        out = real(slab, li, pk, dim, gi)
        split.append((slab.numel(), li + pk * dim, gi,
                      None if out[2] is None else out[2].clone()))
        return out
    monkeypatch.setattr(st, "_delta_pack", recorder)
    for ev in churn_events(cluster, 60, seed=8,
                           incident_ids=tuple(builder.store.incident_ids())):
        stream_step(cluster, builder.store, scorer, ev)
    out = scorer.rescore()
    assert len(packed) == len(split) == 1
    ints = packed[0][0]
    n, head, gi, extra = split[0]
    assert gi == ints.size and n == head + gi
    np.testing.assert_array_equal(extra.numpy(), ints)
    assert scorer._staged_gnn_dev is None
    fresh = GnnStreamingScorer(builder.store, cfg, params=params, now_s=now,
                               device="cpu").rescore()
    _assert_probs(out, fresh, "slab tick vs fresh", rtol=1e-4)


def test_storm_tier_coalesces_while_a_tick_is_in_flight(params):
    """JAX tests/test_storm.py:317-334 on the learned scorer, which
    inherits the storm tier (see test_torch_streaming.storm_contract)."""
    from tests.test_torch_streaming import storm_contract
    storm_contract(lambda store, cfg, now_s: GnnStreamingScorer(
        store, cfg, params=params, now_s=now_s, device="cpu"))
