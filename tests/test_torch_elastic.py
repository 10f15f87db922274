"""The port's ``rca/elastic.py`` against the JAX package's: the hysteresis
gate, the divisor ladder and its single-rung steps, and ``observe()``'s
decisions, fed the same signals. The JAX ladder spans the eight virtual
CPU devices of the test session; the port's spans the shield's pool of
positions, so the comparisons that step give the fake shield eight. A
shield whose pool is one position (or that names none) has the ladder
``(1,)``: ``observe()`` decides and holds."""
from types import SimpleNamespace

import pytest

from kubernetes_aiops_evidence_graph_tpu_torch.rca import elastic as t_el
from kubernetes_aiops_evidence_graph_tpu_torch.rca.elastic import (
    ElasticController)
from tests import torch_surge_world as W


def _fake_shield(shards=2, pn=384, pool=8, **scorer_over):
    """A shield's seam over a fake scorer whose roofline series (a pack
    label no scorer uses) is empty in both packages, whatever other tests
    of the process observed: its drift reads 0."""
    scorer = SimpleNamespace(
        snapshot=SimpleNamespace(padded_nodes=pn),
        _graph_size=lambda: shards, pipeline_depth=2, _inflight=(1, 2),
        stall_seconds=0.0, _scope_entry="streaming.rules_tick",
        _scope_pack="elastic-test", **scorer_over)
    return SimpleNamespace(scorer=scorer, _mesh_excluded=(),
                           pool=["cpu"] * pool)


@pytest.mark.parametrize("pkg", [W.JAX_PKG, W.PORT_PKG])
def test_hysteresis_gate_dwell_and_flap_immunity(pkg):
    """Pressure must be SUSTAINED for dwell_s before the gate fires, and
    any calm sample restarts the clock: a flapping signal never fires."""
    gate_cls = W.mod(pkg, "rca.elastic")._HysteresisGate
    t = [0.0]
    gate = gate_cls(dwell_s=10.0, clock=lambda: t[0])
    seen = []
    for now, hot in ((0.0, True), (9.9, True), (10.0, True), (None, None),
                     (15.0, True), (24.0, False), (25.0, True),
                     (34.9, True), (35.0, True)):
        if now is None:
            gate.reset()
            continue
        t[0] = now
        seen.append(gate.update(hot))
    assert seen == [False, False, True, False, False, False, False, True]


def test_elastic_ladder_and_single_rung_steps():
    """Viable shard counts are the divisors of padded_nodes that fit the
    non-excluded positions, one rung a step either way; with a pool of
    eight the port's ladder equals the JAX package's on its eight
    devices."""
    jel = W.mod(W.JAX_PKG, "rca.elastic")
    for mod in (t_el, jel):
        shield = _fake_shield()
        ec = mod.ElasticController(shield, W.settings(
            W.PORT_PKG if mod is t_el else W.JAX_PKG))
        assert ec.ladder() == (1, 2, 3, 4, 6, 8)
        assert ec._step(+1) == 3 and ec._step(-1) == 1
        shield.scorer._graph_size = lambda: 8
        assert ec._step(+1) is None
        shield._mesh_excluded = (6, 7)
        assert ec.ladder() == (1, 2, 3, 4, 6)


def test_elastic_observe_scales_after_dwell_and_respects_cooldown():
    """With eight devices, observe() holds until the up-gate sustains past
    dwell, then pre-warms and scales exactly once, resets both gates, and
    the cooldown holds the next event off: the same decisions as the JAX
    controller on the same signals."""
    runs = {}
    for pkg in (W.JAX_PKG, W.PORT_PKG):
        t = [0.0]
        calls = []
        shield = _fake_shield(scale_mesh=None)
        shield.scale_mesh = lambda d: (calls.append(("scale", d)) or
                                       {"from_shards": 2, "shards": d,
                                        "direction": "up", "heal_gen": 1})
        cfg = W.settings(pkg, elastic_enabled=True, elastic_dwell_s=5.0,
                         elastic_cooldown_s=30.0)
        ec = W.mod(pkg, "rca.elastic").ElasticController(
            shield, cfg, clock=lambda: t[0])
        ec.prewarm = lambda d, **kw: calls.append(("prewarm", d))
        actions = []
        for now in (0.0, 4.9, 5.0, 20.0):
            t[0] = now
            actions.append(ec.observe())
        runs[pkg] = (actions, calls, ec.stats())
    actions, calls, stats = runs[W.PORT_PKG]
    assert [a["action"] for a in actions] == ["hold", "hold", "scale_up",
                                              "hold"]
    assert actions[2]["plan"]["shards"] == 3
    assert calls == [("prewarm", 3), ("scale", 3)]
    assert stats["scale_ups"] == 1 and stats["decisions"] == 4
    assert runs[W.PORT_PKG] == runs[W.JAX_PKG]


def test_elastic_disabled_never_scales():
    shield = _fake_shield(scale_mesh=None)
    shield.scale_mesh = lambda d: pytest.fail("scaled")
    t = [0.0]
    ec = ElasticController(shield, W.settings(elastic_dwell_s=0.0),
                           clock=lambda: t[0])
    for _ in range(3):
        t[0] += 10.0
        assert ec.observe()["action"] == "hold"


def test_on_one_card_the_ladder_is_one_rung_and_observe_holds():
    """A pool of one position (one card): the ladder is (1,), so a
    sustained hot signal decides and holds; the target mesh of one shard
    is None and a pool of one cannot carry two.
    A pool of four carries the step, and ``prewarm`` builds its mesh
    from the pool less the excluded positions."""
    shield = _fake_shield(shards=1, pool=1, scale_mesh=None)
    shield.scale_mesh = lambda d: pytest.fail("scaled")
    ec = ElasticController(shield, W.settings(elastic_enabled=True,
                                              elastic_dwell_s=0.0))
    assert ec.ladder() == (1,)
    for _ in range(3):
        dec = ec.observe()
        assert dec["action"] == "hold" and dec["occupancy"] == 1.0
    assert ec._step(+1) is None and ec._step(-1) is None
    assert ec.prewarm(1) is None
    with pytest.raises(RuntimeError, match="cannot carry"):
        ec.prewarm(2)
    shield = _fake_shield(shards=1, pool=4)
    shield._mesh_excluded = (1,)
    ec = ElasticController(shield, W.settings(elastic_enabled=True))
    assert ec.ladder() == (1, 2, 3) and ec._step(+1) == 2
    mesh = ec.prewarm(3)
    assert mesh.shape == {"dp": 1, "graph": 3}
    assert mesh.pool_index.ravel().tolist() == [0, 2, 3]


def test_signals_read_the_pack_roofline_under_its_own_label():
    """Over a SurgeServer pack, the controller's drift reads the roofline
    series of that pack's label, its shards the pack's graph size (1)."""
    from kubernetes_aiops_evidence_graph_tpu_torch.observability.scope import (
        ROOFLINE)
    srv, _stores = W.fleet3()
    srv.scorer("t0")
    pack = srv.scorer("t2")
    pack.serve()
    pack.serve()
    ec = ElasticController(SimpleNamespace(scorer=pack, _mesh_excluded=(),
                                           pool=[pack.device]),
                           W.settings(elastic_enabled=True))
    sig = ec.signals()
    entry = pack._scope_entry
    best = ROOFLINE.best(entry, "1")
    assert best > 0.0
    assert sig["roofline_drift"] == ROOFLINE.achieved(entry, "1") / best
    assert sig["shards"] == 1 and sig["occupancy"] == 0.0
    assert ec.observe()["action"] == "hold"
    srv.note_scale(1, ec.observe())
    assert srv.fleet()["history"] == []
