"""Online learning in the port (``learn/``, ``rca/surge.swap_tenants_atomically``,
``storage``) and the fused tick's backward, against the JAX package on the
CPU at a small size: identically seeded worlds and durable stores, the
same weak serving params, the same schedules."""
import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kubernetes_aiops_evidence_graph_tpu.learn import trainer as jtrainer
from kubernetes_aiops_evidence_graph_tpu.ops.pallas_segment import (
    pallas_fused_gnn_tick)
from kubernetes_aiops_evidence_graph_tpu.rca import gnn as jgnn
from kubernetes_aiops_evidence_graph_tpu_torch.config import load_settings
from kubernetes_aiops_evidence_graph_tpu_torch.kernels import fused_tick as fk
from kubernetes_aiops_evidence_graph_tpu_torch.learn import trainer as ttrainer
from kubernetes_aiops_evidence_graph_tpu_torch.kernels.fused_tick import (
    composed_tick)
from kubernetes_aiops_evidence_graph_tpu_torch.ops.fused_tick import (
    scatter_delta, split_ints)
from kubernetes_aiops_evidence_graph_tpu_torch.rca import gnn as tgnn
from kubernetes_aiops_evidence_graph_tpu_torch.rca.gnn_streaming import (
    GnnStreamingScorer)
from tests.test_fused_tick import _random_tick_operands
from tests.test_torch_streaming import JAX_PKG, PORT_PKG, _world

torch.set_num_threads(1)

BUCKETS = dict(node_bucket_sizes=(256, 512, 1024, 2048),
               incident_bucket_sizes=(8, 32))
SCENARIOS3 = ("crashloop_deploy", "oom", "network")


def _cfg(pkg, **over):
    extra = {} if pkg == PORT_PKG else {"edge_bucket_sizes": (1024, 4096,
                                                              16384)}
    return importlib.import_module(pkg + ".config").load_settings(
        **BUCKETS, **extra, **over)


def _learn_cfg(pkg, **over):
    base = dict(learn_enabled=True, learn_steps=60, learn_lr=2e-3,
                learn_min_episodes=1, learn_holdout_every=0,
                learn_sim_episodes=2, learn_sim_holdout=1,
                learn_sim_incidents=4)
    base.update(over)
    if pkg == JAX_PKG:
        base["rca_backend"] = "gnn"
    return _cfg(pkg, **base)


def _port_params(tree):
    return tgnn.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                  device="cpu")


def _flat_np(params):
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in tgnn.flat_params(params).items()}


def _assert_params_close(mine, ref, tol):
    a, b = _flat_np(mine), _flat_np(ref)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=tol, atol=tol, err_msg=k)


def _seed_db(pkg, db, incidents, rules, confidence=0.95, feedback_for=(),
             verified_for=(), wrong_truth=None):
    """Rules-tier hypotheses (weak labels) for every incident, plus operator
    feedback / verification rows, through ``pkg``'s models."""
    m = importlib.import_module(pkg + ".models")
    hyps = {}
    for inc, rule in zip(incidents, rules):
        db.create_incident(inc)
        h = m.Hypothesis(
            incident_id=inc.id,
            category=m.HypothesisCategory.RESOURCE_EXHAUSTION,
            title=rule, confidence=confidence, rank=1, rule_id=rule,
            backend="tpu", generated_by=m.HypothesisSource.RULES_ENGINE)
        db.insert_hypotheses([h])
        hyps[str(inc.id)] = h
    for inc in feedback_for:
        truth = (wrong_truth or {}).get(str(inc.id))
        db.insert_feedback(m.HypothesisFeedback(
            hypothesis_id=hyps[str(inc.id)].id, was_correct=truth is None,
            actual_root_cause=truth, submitted_by="operator"))
    for inc in verified_for:
        action = m.RemediationAction(
            incident_id=inc.id, hypothesis_id=hyps[str(inc.id)].id,
            idempotency_key=f"test-{inc.id}",
            action_type=m.ActionType("restart_pod"), target_resource="dep")
        db.upsert_action(action)
        db.insert_verification(m.VerificationResult(
            action_id=action.id, incident_id=inc.id, success=True,
            metrics_improved=True))
    return hyps


def _both(seed, scenarios=SCENARIOS3, **kw):
    """The same world, store and labeled db in each package:
    {pkg: (cfg, cluster, builder, incidents, db)}."""
    out = {}
    for pkg in (JAX_PKG, PORT_PKG):
        cfg = _cfg(pkg)
        cluster, builder, incidents = _world(pkg, cfg, seed=seed,
                                             scenarios=scenarios)
        sim = importlib.import_module(pkg + ".simulator")
        db = importlib.import_module(pkg + ".storage").Database(":memory:")
        rules = [sim.SCENARIOS[s].expected_rule for s in scenarios]
        ks = {k: incidents[i] for k, i in kw.items()}
        truth = None
        if "feedback" in kw:   # the operator names another rule
            truth = {str(ks["feedback"].id): next(
                r for r in sorted(rules + ["oom_killed", "network_error"])
                if r != rules[kw["feedback"]])}
        _seed_db(pkg, db, incidents, rules,
                 feedback_for=[ks["feedback"]] if "feedback" in ks else (),
                 verified_for=[ks["verified"]] if "verified" in ks else (),
                 wrong_truth=truth)
        out[pkg] = (cfg, cluster, builder, incidents, db)
    return out


def _same_episode(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert tuple(a["rel_offsets"]) == tuple(b["rel_offsets"])
    for k in tgnn.TRAIN_ARRAYS:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    for k in ("fingerprint", "label_sources", "tenant"):
        assert a[k] == b[k], k


# -- the durable store, labels and episodes ---------------------------------

def test_harvest_precedence_episode_masking_and_dedup_equal_jax():
    """feedback > verification > weak rule labels; only labeled rows are
    unmasked; the same labels, episode arrays and fingerprint as the JAX
    package; the replay buffer dedups by fingerprint."""
    worlds = _both(31, verified=1, feedback=2)
    eps, labels = {}, {}
    for pkg, (cfg, cluster, builder, incidents, db) in worlds.items():
        ep_mod = importlib.import_module(pkg + ".learn.episodes")
        labels[pkg] = ep_mod.harvest_labels(db)
        eps[pkg] = ep_mod.build_episode(builder.store, labels[pkg], cfg,
                                        now_s=cluster.now.timestamp())
    assert labels[PORT_PKG] == labels[JAX_PKG]
    assert sorted(s for _, s in labels[PORT_PKG].values()) == [
        "feedback", "verification", "weak_rule"]
    _same_episode(eps[PORT_PKG], eps[JAX_PKG])
    assert int(eps[PORT_PKG]["label_mask"].sum()) == 3
    from kubernetes_aiops_evidence_graph_tpu_torch.learn import (
        ReplayBuffer, build_episode)
    cfg, cluster, builder, _, _ = worlds[PORT_PKG]
    buf = ReplayBuffer(cap=1)
    assert buf.add(eps[PORT_PKG]) is True
    assert buf.add(build_episode(builder.store, labels[PORT_PKG], cfg,
                                 now_s=cluster.now.timestamp())) is False
    relabel = dict(labels[PORT_PKG])
    first = next(iter(relabel))
    relabel[first] = ((relabel[first][0] + 1) % tgnn.NUM_CLASSES, "feedback")
    assert buf.add(build_episode(builder.store, relabel, cfg,
                                 now_s=cluster.now.timestamp())) is True
    assert len(buf) == 1 and buf.duplicates == 1 and buf.evicted == 1


def test_closed_incidents_replay_from_persisted_evidence_equal_jax():
    """Labels that land after the incident left the live graph: the
    window is rebuilt from the persisted evidence rows, and the replay
    episode equals the JAX package's."""
    worlds = _both(81, scenarios=("crashloop_deploy", "oom"))
    eps = {}
    for pkg, (cfg, cluster, builder, incidents, db) in worlds.items():
        col = importlib.import_module(pkg + ".collectors")
        ep_mod = importlib.import_module(pkg + ".learn.episodes")
        m = importlib.import_module(pkg + ".models")
        for inc in incidents:
            db.insert_feedback(m.HypothesisFeedback(
                hypothesis_id=db.hypotheses_for(inc.id)[0]["id"],
                was_correct=True, submitted_by="operator"))
            results = col.collect_all(inc, col.default_collectors(cluster, cfg),
                                      parallel=False)
            db.insert_evidence([e for r in results for e in r.evidence])
            builder.store.remove_node(f"incident:{inc.id}")
        labels = ep_mod.harvest_labels(db)
        assert ep_mod.build_episode(builder.store, labels, cfg) is None
        eps[pkg] = ep_mod.build_replay_episode(db, labels, cfg,
                                               now_s=cluster.now.timestamp())
    _same_episode(eps[PORT_PKG], eps[JAX_PKG])
    assert int(eps[PORT_PKG]["label_mask"].sum()) == 2


def test_models_round_trip_through_the_durable_store():
    """The port's models read back from the store's rows as the JAX
    package's pydantic models do (model_validate converts the stored
    strings to enums, UUIDs and datetimes)."""
    from kubernetes_aiops_evidence_graph_tpu_torch.models import (
        Evidence, Incident, Runbook, RunbookStep)
    from kubernetes_aiops_evidence_graph_tpu_torch.storage import Database
    worlds = _both(5, scenarios=("oom",))
    cfg, cluster, builder, incidents, db = worlds[PORT_PKG]
    assert isinstance(db, Database)
    inc = incidents[0]
    row = db.get_incident(inc.id)
    back = Incident.model_validate({k: v for k, v in row.items()
                                    if k in Incident.model_fields})
    for f in ("id", "severity", "status", "source", "started_at", "labels"):
        assert getattr(back, f) == getattr(inc, f), f
    col = importlib.import_module(PORT_PKG + ".collectors")
    evs = [e for r in col.collect_all(inc, col.default_collectors(cluster, cfg),
                                      parallel=False) for e in r.evidence]
    db.insert_evidence(evs)
    got = [Evidence.model_validate({k: v for k, v in e.items()
                                    if k in Evidence.model_fields})
           for e in db.evidence_for(inc.id)]
    assert {(e.id, e.evidence_type, e.entity_name) for e in got} == {
        (e.id, e.evidence_type, e.entity_name) for e in evs}
    rb = Runbook(incident_id=inc.id, title="t",
                 steps=[RunbookStep(order=1, title="s", description="d")])
    db.insert_runbook(rb)
    assert db.runbook_for(inc.id)["title"] == "t"


# -- the fine-tune ------------------------------------------------------------

@pytest.fixture(scope="module")
def tune_episodes():
    """A production episode (labeled live window) and two simulator
    episodes, as numpy batches both packages read."""
    from kubernetes_aiops_evidence_graph_tpu.learn.episodes import (
        build_episode, harvest_labels)
    from kubernetes_aiops_evidence_graph_tpu.rca.train import make_dataset
    cfg, cluster, builder, _, db = _both(41, feedback=0)[JAX_PKG]
    prod = build_episode(builder.store, harvest_labels(db), cfg,
                         now_s=cluster.now.timestamp())
    return [prod], make_dataset(2, 96, 4, seed=1717, return_snapshot=True)


@pytest.mark.parametrize("pallas_grads", [False, True])
def test_finetune_equals_jax_finetune(tune_episodes, pallas_grads):
    """Two fine-tune steps from the same serving params against the JAX
    package's finetune (XLA, and the Pallas vjp tier after its parity
    check): params within 1e-3 (tests/test_fused_tick.py's tolerance),
    the serving tree untouched, the anchor pulling."""
    prod, sim = tune_episodes
    jp = jgnn.init_params(jax.random.PRNGKey(9))
    serving = _port_params(jp)
    before = _flat_np(serving)
    mine = ttrainer.finetune(serving, prod, sim, steps=2, lr=1e-3,
                             anchor_weight=1e-3, pallas_grads=pallas_grads)
    ref = jtrainer.finetune(jp, prod, sim, steps=2, lr=1e-3,
                            anchor_weight=1e-3, pallas_grads=pallas_grads)
    assert mine["steps"] == ref["steps"] == 2
    assert mine["pallas"] == ref["pallas"] == pallas_grads
    assert mine["sharded"] is False
    np.testing.assert_allclose(mine["final_loss"], ref["final_loss"],
                               rtol=1e-4, atol=1e-4)
    _assert_params_close(mine["params"], ref["params"], 1e-3)
    for k, v in _flat_np(serving).items():
        assert np.array_equal(v, before[k]), k
    assert ttrainer.params_finite(mine["params"])


def test_finetune_step_anchor_equals_jax(tune_episodes):
    """make_finetune_step with a strong anchor: loss (data + 0.5 w
    ||p - a||^2) and the updated params equal the JAX step's."""
    import optax
    prod, _ = tune_episodes
    ep = prod[0]
    offs = tuple(ep["rel_offsets"])
    jp = jgnn.init_params(jax.random.PRNGKey(2))
    anchor = jax.tree_util.tree_map(lambda x: x * 0.5, jp)
    tx = optax.adam(1e-2)
    jstep = jtrainer.make_finetune_step(tx)
    batch = {k: jnp.asarray(ep[k]) for k in tgnn.TRAIN_ARRAYS}
    jnew, _, jl = jstep(jax.tree_util.tree_map(jnp.array, jp), tx.init(jp),
                        anchor, jnp.float32(0.7), batch, rel_offsets=offs)
    tstep = ttrainer.make_finetune_step(tgnn.adam(1e-2))
    tanchor = _port_params(anchor)
    tnew, _, tl = tstep(_port_params(jp), None, tanchor, 0.7, ep,
                        rel_offsets=offs)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4, atol=1e-4)
    _assert_params_close(tnew, jnew, 1e-4)
    _assert_params_close(tanchor, anchor, 0.0)


def test_grads_parity_gate_raises_on_a_mismatch_and_never_falls_back(
        tune_episodes, monkeypatch):
    prod, sim = tune_episodes
    serving = _port_params(jgnn.init_params(jax.random.PRNGKey(9)))
    ttrainer.check_grads_parity(serving, prod[0])     # CPU vs CPU: equal
    real = ttrainer._loss_and_grads
    calls = []

    def planted(params, batch, offs):
        loss, grads = real(params, batch, offs)
        calls.append(1)
        if len(calls) == 1:          # the params' device tier
            grads[3] = grads[3] + 1e-2
        return loss, grads
    monkeypatch.setattr(ttrainer, "_loss_and_grads", planted)
    with pytest.raises(ttrainer.GradsParityError, match="grad"):
        ttrainer.finetune(serving, prod, sim, steps=2, lr=1e-3,
                          anchor_weight=1e-3, pallas_grads=True)
    flat = dict(prod[0])
    flat["rel_offsets"] = ()
    with pytest.raises(ValueError, match="relation-bucketed"):
        ttrainer.check_grads_parity(serving, flat)
    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        ttrainer.finetune(serving, prod, sim, steps=2, lr=1e-3,
                          anchor_weight=1e-3, mesh_shards=2)


# -- the loop -----------------------------------------------------------------

def _learner(pkg, seed, weak, **over):
    cfg = _learn_cfg(pkg, **over)
    cluster, builder, incidents = _world(pkg, cfg, seed=seed,
                                         scenarios=SCENARIOS3)
    sim = importlib.import_module(pkg + ".simulator")
    db = importlib.import_module(pkg + ".storage").Database(":memory:")
    _seed_db(pkg, db, incidents,
             [sim.SCENARIOS[s].expected_rule for s in SCENARIOS3],
             feedback_for=incidents)
    scorer_cls = importlib.import_module(
        pkg + ".rca.gnn_streaming").GnnStreamingScorer
    kw = {"device": "cpu"} if pkg == PORT_PKG else {}
    now = cluster.now.timestamp()
    scorer = scorer_cls(builder.store, cfg, params=weak, now_s=now, **kw)
    learner = importlib.import_module(pkg + ".learn").OnlineLearner(
        db, [scorer], settings=cfg, now_s=now)
    return learner, scorer, (cfg, builder, now)


def test_online_learner_run_once_equals_jax():
    """A weak serving checkpoint (random params at the shipped width)
    fine-tunes on the harvested production labels plus the simulator mix,
    passes the gate and hot-swaps — in both packages alike: the same
    harvest, steps, gate numbers, swap and generation, candidate params
    within 1e-3; the next tick serves generation 1 with the candidate's
    probs. A second cycle harvests nothing new."""
    weak = jgnn.init_params(jax.random.PRNGKey(123))
    outs, scorers = {}, {}
    for pkg in (JAX_PKG, PORT_PKG):
        learner, scorer, ctx = _learner(
            pkg, 41, weak if pkg == JAX_PKG else _port_params(weak))
        outs[pkg] = (learner.run_once(), learner, ctx)
        scorers[pkg] = scorer
    (mine, learner, (cfg, builder, now)), (ref, _, _) = \
        outs[PORT_PKG], outs[JAX_PKG]
    for k in ("harvested", "trained", "swapped", "generation",
              "train_steps", "buffer"):
        assert mine[k] == ref[k], k
    assert mine["swapped"] is True and mine["generation"] == 1
    assert mine["train_steps"] == 60
    for k in ("candidate_top1", "serving_top1", "holdout_episodes",
              "finite"):
        assert mine["gate"][k] == ref["gate"][k], k
    np.testing.assert_allclose(mine["final_loss"], ref["final_loss"],
                               rtol=1e-3, atol=1e-3)
    _assert_params_close(scorers[PORT_PKG]._params, scorers[JAX_PKG]._params,
                         1e-3)
    served = scorers[PORT_PKG].rescore()
    assert served["params_generation"] == 1
    fresh = GnnStreamingScorer(builder.store, cfg,
                               params=scorers[PORT_PKG]._params, now_s=now,
                               device="cpu").rescore()
    np.testing.assert_allclose(served["probs"], fresh["probs"], rtol=1e-5,
                               atol=1e-5)
    st = learner.status()
    assert st["swaps"] == 1 and st["generation"] == 1 and st["cycles"] == 1
    again = learner.run_once()
    assert again["harvested"] == 0 and learner.buffer.duplicates == 1


def test_gate_rejects_a_poisoned_finetune_and_rollback_restores():
    """Label noise (every label a wrong rule) must not pass the gate: no
    swap, the generation stays; after a forced swap, a quarantine on the
    target rolls it back on the next cycle."""
    from kubernetes_aiops_evidence_graph_tpu_torch.simulator import SCENARIOS
    cfg = _learn_cfg(PORT_PKG, learn_steps=40, learn_lr=2e-2,
                     learn_anchor_weight=0.0, learn_sim_episodes=0)
    cluster, builder, incidents = _world(PORT_PKG, cfg, seed=51,
                                         scenarios=SCENARIOS3)
    from kubernetes_aiops_evidence_graph_tpu_torch.learn import OnlineLearner
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.gnn_backend import (
        SHIPPED_CHECKPOINT, load_validated_checkpoint)
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.ruleset import (
        RULE_INDEX)
    from kubernetes_aiops_evidence_graph_tpu_torch.storage import Database
    db = Database(":memory:")
    wrong = [[r for r in sorted(RULE_INDEX)
              if r != SCENARIOS[s].expected_rule][i % (len(RULE_INDEX) - 1)]
             for i, s in enumerate(SCENARIOS3)]
    _seed_db(PORT_PKG, db, incidents, wrong)
    shipped = load_validated_checkpoint(SHIPPED_CHECKPOINT)
    scorer = GnnStreamingScorer(builder.store, cfg, params=shipped,
                                now_s=cluster.now.timestamp(), device="cpu")
    learner = OnlineLearner(db, [scorer], settings=cfg,
                            now_s=cluster.now.timestamp())
    out = learner.run_once()
    assert out["trained"] is True and out["swapped"] is False
    assert scorer.params_generation == 0 and learner.gate_rejects == 1
    assert out["gate"]["candidate_top1"] < out["gate"]["serving_top1"]
    assert learner.swap(tgnn.init_params(torch.Generator().manual_seed(1),
                                         device="cpu")) == 1
    scorer.quarantined_batches = 1
    assert learner.run_once()["rolled_back"] is True
    assert scorer.params_generation == 2 and learner.rollbacks == 1
    _assert_params_close(scorer._params, shipped, 0.0)


def test_swap_tenants_atomically_flips_every_scorer_to_one_generation():
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.surge import (
        swap_tenants_atomically)
    cfg = _cfg(PORT_PKG)
    a = tgnn.init_params(torch.Generator().manual_seed(3), device="cpu")
    b = tgnn.init_params(torch.Generator().manual_seed(4), device="cpu")
    worlds = [_world(PORT_PKG, cfg, seed=s, num_pods=100) for s in (21, 22)]
    scorers = [GnnStreamingScorer(w[1].store, cfg, params=a,
                                  now_s=w[0].now.timestamp(), device="cpu")
               for w in worlds]
    for s in scorers:
        s.rescore()
    scorers[1].swap_params(a)           # tenants at different generations
    assert swap_tenants_atomically(scorers, b, source="shared") == 2
    for (c, builder, _), s in zip(worlds, scorers):
        assert s.params_generation == 2
        fresh = GnnStreamingScorer(builder.store, cfg, params=b,
                                   now_s=c.now.timestamp(),
                                   device="cpu").rescore()
        np.testing.assert_array_equal(s.rescore()["probs"], fresh["probs"])
    with pytest.raises(ValueError):
        swap_tenants_atomically([], b)


# -- the fused tick's backward ------------------------------------------------

def _tick_inputs(seed):
    """JAX tick operands (tests/test_fused_tick.py) and a cotangent for
    each differentiable output."""
    p, features, mirrors, ints, offs, kw = _random_tick_operands(seed)
    rng = np.random.default_rng(seed + 50)
    cts = {"nmask": rng.standard_normal(mirrors[1].shape).astype(np.float32),
           "emask": rng.standard_normal(mirrors[5].shape).astype(np.float32),
           "logits": rng.standard_normal((kw["pi"], jgnn.NUM_CLASSES)
                                         ).astype(np.float32),
           "probs": rng.standard_normal((kw["pi"], jgnn.NUM_CLASSES)
                                        ).astype(np.float32)}
    return p, features, mirrors, ints, offs, kw, cts


def _tick_loss(out, cts, lib):
    return sum((out[i] * lib(cts[k])).sum()
               for i, k in ((1, "nmask"), (5, "emask"), (6, "logits"),
                            (7, "probs")))


@pytest.mark.parametrize("seed", [7, 8])
def test_fused_tick_grads_equal_jax_pallas_fused_tick(seed):
    """Grads through the port's fused_gnn_tick (its autograd Function: the
    plain forward on the CPU, the composed recompute as backward) for
    params, features, nmask and emask against jax.grad of
    pallas_fused_gnn_tick (interpret mode), rtol/atol 1e-4; the mirrors are
    still scattered in place."""
    p, features, mirrors, ints, offs, kw, cts = _tick_inputs(seed)
    jg = jax.grad(lambda pp, f, nm, em: _tick_loss(pallas_fused_gnn_tick(
        pp, f, jnp.asarray(mirrors[0]), nm, *[jnp.asarray(m) for m in
                                              mirrors[2:5]], em,
        jnp.asarray(ints), rel_offsets=offs, interpret=True, **kw), cts,
        jnp.asarray), argnums=(0, 1, 2, 3))(
        p, jnp.asarray(features), jnp.asarray(mirrors[1]),
        jnp.asarray(mirrors[5]))
    tp = tgnn.trainable(_port_params(p))
    feats = torch.from_numpy(features).requires_grad_()
    nm0 = torch.from_numpy(mirrors[1].copy()).requires_grad_()
    em0 = torch.from_numpy(mirrors[5].copy()).requires_grad_()
    m = [torch.from_numpy(x.copy()) for x in mirrors]
    m[1], m[5] = nm0 * 1.0, em0 * 1.0      # the scatter writes into these
    before = fk.launches
    out = fk.fused_gnn_tick(tp, feats, *m, torch.from_numpy(ints),
                            rel_offsets=offs, **kw)
    assert fk.launches == before, "the plain version must not count"
    assert out[1] is m[1] and out[0] is m[0]
    _tick_loss(out, cts, torch.from_numpy).backward()
    grads = {k: v.grad for k, v in tgnn.flat_params(tp).items()}
    _assert_params_close(grads, jg[0], 1e-4)
    for mine, ref in ((feats.grad, jg[1]), (nm0.grad, jg[2]),
                      (em0.grad, jg[3])):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)
    # the mirrors hold the scattered delta, as without a gradient
    plain = [torch.from_numpy(x.copy()) for x in mirrors]
    scatter_delta(split_ints(torch.from_numpy(ints), kw["pk"], kw["ek"],
                             kw["pi"]), *plain)
    for a, b in zip(out[:6], plain):
        assert torch.equal(a.detach(), b)


def test_recompute_from_post_tick_mirrors_equals_pre_tick():
    """The kernel scatters in place, so the backward recomputes from the
    POST-tick mirrors: the scatter applied to its own result changes
    nothing, and the grads equal those recomputed from the pre-tick
    mirrors bit for bit (overwritten nmask/emask positions get zero
    gradient either way)."""
    p, features, mirrors, ints, offs, kw, cts = _tick_inputs(9)
    tint = torch.from_numpy(ints)
    post = [torch.from_numpy(x.copy()) for x in mirrors]
    scatter_delta(split_ints(tint, kw["pk"], kw["ek"], kw["pi"]), *post)
    grads = []
    for base in ([torch.from_numpy(x.copy()) for x in mirrors], post):
        tp = tgnn.trainable(_port_params(p))
        nm = base[1].clone().requires_grad_()
        em = base[5].clone().requires_grad_()
        out = composed_tick(tp, torch.from_numpy(features), base[0], nm,
                            base[2], base[3], base[4], em, tint,
                            rel_offsets=offs, **kw)
        _tick_loss((None, *out[:1], None, None, None, *out[1:]), cts,
                   torch.from_numpy).backward()
        grads.append([nm.grad, em.grad] + [v.grad for v in tgnn.leaves(tp)])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    f_idx = ints[:kw["pk"]]
    hit = f_idx[(f_idx >= 0) & (f_idx < features.shape[0])]
    assert hit.size and not grads[0][0][torch.from_numpy(hit).long()].any()


def test_dma_tick_raises_when_a_gradient_is_wanted():
    """The streamed tick has no backward: with a param requiring grad it
    raises instead of returning a result autograd cannot see through;
    under no_grad it serves."""
    p, features, mirrors, ints, offs, kw, _ = _tick_inputs(3)
    tp = tgnn.trainable(_port_params(p))
    h = [torch.zeros((features.shape[0], 16)) for _ in range(2)]
    args = (torch.from_numpy(features), *[torch.from_numpy(x.copy())
                                          for x in mirrors],
            torch.from_numpy(ints), *h)
    with pytest.raises(RuntimeError, match="no backward"):
        fk.fused_gnn_tick_dma(tp, *args, rel_offsets=offs, node_block=64,
                              **kw)
    with torch.no_grad():
        out = fk.fused_gnn_tick_dma(tp, *args, rel_offsets=offs,
                                    node_block=64, **kw)
    assert torch.isfinite(out[7]).all()
