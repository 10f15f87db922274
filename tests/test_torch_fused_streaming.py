"""The resident GNN scorer's kernel tiers (``settings.gnn_fused_tick``,
``gnn_tick_dma``, ``gnn_tick_dma`` + ``gnn_feature_quant``): on the CPU
each runs its kernel's plain version. Each tier against the JAX package's
GnnStreamingScorer under the same settings and seeded churn (mirror
equal, probs within 1e-5 at float32 and within the tier's tolerance for
the quantized tables, top-1 equal); bit-identical across pipeline depths
through a rebuild and equal to a fresh rebuild; the float32 tiers equal
to the composed tick bit for bit; and the tier ``_call_gnn_tick`` picks."""
import importlib

import numpy as np
import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu_torch.config import load_settings
from kubernetes_aiops_evidence_graph_tpu_torch.rca import gnn_streaming as gs
from kubernetes_aiops_evidence_graph_tpu_torch.rca.gnn_backend import (
    SHIPPED_CHECKPOINT, load_validated_checkpoint)
from tests.test_torch_gnn_streaming import _assert_probs, _mirror, _scorer
from tests.test_torch_streaming import JAX_PKG, PORT_PKG, SMALL, TIGHT, _world

# one intra-op thread: these tensors are small, and the suite runs
# several pytest workers side by side on the host's cores
torch.set_num_threads(1)

TIERS = {
    "composed": {},
    "fused": {"gnn_fused_tick": True},
    "dma": {"gnn_tick_dma": True},
    "dma_bf16": {"gnn_tick_dma": True, "gnn_feature_quant": "bfloat16"},
    "dma_int8": {"gnn_tick_dma": True, "gnn_feature_quant": "int8"},
}
TIER_TOL = {"dma_bf16": 0.05, "dma_int8": 0.1}


@pytest.fixture(scope="module")
def params():
    """The shipped weights as numpy (both packages take them)."""
    return load_validated_checkpoint(SHIPPED_CHECKPOINT)


def _run(pkg, params, tier, depth=2, events=150, seed=21, tick=50,
         buckets=SMALL, every_event=False, num_pods=120):
    """One seeded full-mix churn script under a tier's settings: rescore()
    and a mirror capture every ``tick`` events (tick_async after every
    event when ``every_event``). Returns (outputs, mirrors, scorer, a
    fresh scorer's rescore() of the final store)."""
    cfg = importlib.import_module(pkg + ".config").load_settings(
        serve_pipeline_depth=depth, **buckets, **TIERS[tier])
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


@pytest.mark.parametrize("tier", ["fused", "dma", "dma_bf16", "dma_int8"])
def test_tier_equals_jax_scorer_under_churn(params, tier):
    """Same world, settings and churn in both packages: the mirror (device
    arrays, offsets, free lists, edge slots) equal at every caller
    boundary, probs within 1e-5 (float32 tiers) or the tier's tolerance
    (bf16 0.05, int8 0.1), top-1 equal; the churned state serves what a
    fresh scorer of the final store does."""
    jax_outs, jax_mirrors, _, _ = _run(JAX_PKG, params, tier)
    outs, mirrors, scorer, fresh = _run(PORT_PKG, params, tier)
    assert scorer._dma_ok() if tier.startswith("dma") else scorer._fused_ok()
    assert len(outs) == len(jax_outs) == 4
    for gen, (m, jm) in enumerate(zip(mirrors, jax_mirrors)):
        assert m["rel_offsets"] == jm["rel_offsets"], gen
        assert m["free"] == jm["free"], gen
        for a, b in zip(m["arrays"], jm["arrays"]):
            np.testing.assert_array_equal(a, b.astype(a.dtype),
                                          err_msg=f"mirror (gen {gen})")
    tol = TIER_TOL.get(tier, 1e-5)
    for gen, (mine, ref) in enumerate(zip(outs, jax_outs)):
        _assert_probs(mine, ref, f"{tier} port vs JAX, gen {gen}", rtol=tol,
                      atol=tol)
    _assert_probs(outs[-1], fresh, f"{tier} final vs fresh rebuild",
                  rtol=1e-4)


@pytest.mark.parametrize("tier", ["fused", "dma_int8"])
def test_tier_depth_parity_through_a_rebuild(params, tier):
    """Pipeline depths 1/2/4 give the same probs bit for bit at every caller
    boundary, through a mid-script rebuild (tight buckets: the quant table
    is re-derived there), and the final state equals a fresh rebuild."""
    script = dict(events=240, seed=13, tick=80, buckets=TIGHT, num_pods=150,
                  every_event=True)
    base, _, s1, fresh = _run(PORT_PKG, params, tier, depth=1, **script)
    assert s1.rebuilds >= 1, "tight buckets should force a rebuild"
    for depth in (2, 4):
        outs, _, scorer, _ = _run(PORT_PKG, params, tier, depth=depth,
                                  **script)
        assert scorer.rebuilds == s1.rebuilds
        for gen, (a, b) in enumerate(zip(base, outs)):
            _assert_probs(b, a, f"{tier} depth {depth}, gen {gen}",
                          exact=True)
    _assert_probs(base[-1], fresh, f"{tier} final vs fresh rebuild",
                  rtol=1e-4)


def test_float32_tiers_equal_the_composed_tick_bit_for_bit(params):
    """On the CPU the fused and streamed tiers run the same plain
    arithmetic as the composed tick: equal probs, bit for bit."""
    base = _run(PORT_PKG, params, "composed", events=100)[0]
    for tier in ("fused", "dma"):
        outs = _run(PORT_PKG, params, tier, events=100)[0]
        for gen, (a, b) in enumerate(zip(base, outs)):
            _assert_probs(b, a, f"{tier} vs composed, gen {gen}", exact=True)


def test_call_gnn_tick_picks_the_tier(params, monkeypatch):
    """Streamed when gnn_tick_dma is on and the layout passes (aligned,
    non-empty, the node block divides Pn), else fused when gnn_fused_tick
    is on and the layout passes, else composed; a quant tier alone, or a
    compute dtype other than float32/bfloat16, selects nothing."""
    called = []
    for name in ("_gnn_tick", "_gnn_fused_tick", "_gnn_dma_tick",
                 "_gnn_dma_tick_q"):
        real = getattr(gs, name)
        monkeypatch.setattr(gs, name, lambda *a, _n=name, _r=real, **kw:
                            called.append(_n) or _r(*a, **kw))
    cfg = load_settings(**SMALL)
    cluster, builder, _ = _world(PORT_PKG, cfg, seed=5, num_pods=100)
    cases = [
        ({}, "_gnn_tick"),
        ({"gnn_fused_tick": True}, "_gnn_fused_tick"),
        ({"gnn_fused_tick": True, "gnn_compute_dtype": "bfloat16"},
         "_gnn_fused_tick"),
        ({"gnn_tick_dma": True}, "_gnn_dma_tick"),
        ({"gnn_tick_dma": True, "gnn_fused_tick": True}, "_gnn_dma_tick"),
        ({"gnn_tick_dma": True, "gnn_feature_quant": "int8"},
         "_gnn_dma_tick_q"),
        ({"gnn_tick_dma": True, "gnn_feature_quant": "bfloat16"},
         "_gnn_dma_tick_q"),
        ({"gnn_feature_quant": "int8"}, "_gnn_tick"),
        ({"gnn_fused_tick": True, "gnn_compute_dtype": "float16"},
         "_gnn_tick"),
        ({"gnn_tick_dma": True, "gnn_dma_node_block": 384}, "_gnn_tick"),
        ({"gnn_tick_dma": True, "gnn_dma_node_block": 384,
          "gnn_fused_tick": True}, "_gnn_fused_tick"),
    ]
    for over, want in cases:
        called.clear()
        sc = gs.GnnStreamingScorer(builder.store, load_settings(**SMALL, **over),
                                   params=params,
                                   now_s=cluster.now.timestamp(), device="cpu")
        assert sc.snapshot.padded_nodes == 512
        sc.dispatch()
        assert called == [want], over
        for offs in ((0, 24, 88), (0, 0), ()):
            assert not sc._fused_ok(offs) and not sc._dma_ok(offs)
        assert (sc._features_q_dev is not None) == bool(
            over.get("gnn_feature_quant"))
