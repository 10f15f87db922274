"""Shared harness of the crash-shield tests (``tests/test_torch_shield_*.py``):
one shielded serving run over a fresh seeded world, in either package.

The contract is tests/test_shield.py's: for every injected fault class
(a fault at each stage of the tick, NaN poison, torn journal appends,
snapshot crashes, silent corruption), the shielded scorer recovers to
verdicts bit-identical to an unfaulted replay of the same churn script,
and here also to the same packed resident state. Each run builds its own
seeded world (``_world``: incident ids fixed from the seed), drives churn
through the STORE (``store_step``) and serves through the shield, so the
write-ahead journal covers every mutation. Not a test module: the test
files import it.
"""
from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu_torch.rca import shield as t_shield
from kubernetes_aiops_evidence_graph_tpu_torch.rca.gnn_backend import (
    SHIPPED_CHECKPOINT, load_validated_checkpoint)
from tests.test_torch_gnn_streaming import _assert_probs
from tests.test_torch_streaming import JAX_PKG, PORT_PKG, RESULT_KEYS, _world

# one intra-op thread: these tensors are small, and the suite runs
# several pytest workers side by side on the host's cores
torch.set_num_threads(1)

BUCKETS = dict(node_bucket_sizes=(512, 2048), incident_bucket_sizes=(8, 32))
EVENTS, BATCH = 120, 20
LEARNED_EVENTS = 60
# the scorer under the shield and its settings: the rules scorer, and the
# learned scorer's tiers (streamed on the float32, bf16 and int8 tables)
TIERS = {
    "rules": {},
    "composed": {},
    "fused": {"gnn_fused_tick": True},
    "dma": {"gnn_tick_dma": True},
    "dma_bf16": {"gnn_tick_dma": True, "gnn_feature_quant": "bfloat16"},
    "dma_int8": {"gnn_tick_dma": True, "gnn_feature_quant": "int8"},
    "walk": {"gnn_tick_dma": True, "gnn_fused_tick": True},
}
PROB_KEYS = ("probs", "top_rule_index", "any_match", "top_confidence")

# (fault spec, expects-recovery) per fault class of the rules matrix:
# ``at`` indexes the Nth visit of the stage. fetch only fires at the
# caller-boundary rescore (visit 0); snapshot_write visit 0 is the
# acquisition anchor.
FAULTS = {
    "staging_exception": ([dict(stage="staging", at=2)], False),
    "dispatch_failure": ([dict(stage="dispatch", at=2)], True),
    "pack_failure": ([dict(stage="pack", at=2)], True),
    "device_loss_mid_execute": (
        [dict(stage="execute", at=2, kind="device_loss")], True),
    "fetch_failure": ([dict(stage="fetch", at=0)], False),
    "journal_append_crash": ([dict(stage="journal_append", at=2)], False),
    "snapshot_write_crash": ([dict(stage="snapshot_write", at=1)], False),
    "nan_poisoned_delta": (
        [dict(stage="delta_values", at=1, kind="poison", repeats=3)], True),
    "shard_loss": ([dict(stage="shard_loss", at=2, kind="shard_loss")],
                   True),
}

# one fault a stage for the learned tiers' matrix
LEARNED_FAULTS = {
    "staging": dict(stage="staging", at=1),
    "dispatch": dict(stage="dispatch", at=1),
    "pack": dict(stage="pack", at=1),
    "execute": dict(stage="execute", at=1, kind="device_loss"),
    "fetch": dict(stage="fetch", at=0),
    "journal_append": dict(stage="journal_append", at=1),
    "snapshot_write": dict(stage="snapshot_write", at=1),
    "delta_values": dict(stage="delta_values", at=1, kind="poison"),
    "shard_loss": dict(stage="shard_loss", at=1, kind="shard_loss"),
}


@pytest.fixture(scope="module")
def params():
    """The shipped weights as numpy (both packages take them)."""
    return load_validated_checkpoint(SHIPPED_CHECKPOINT)


@dataclasses.dataclass
class Run:
    out: dict
    shield: object
    packed: "np.ndarray | None"
    world: tuple


def settings(pkg=PORT_PKG, tier="rules", depth=2, **over):
    cfg = importlib.import_module(pkg + ".config")
    kw = dict(serve_pipeline_depth=depth, shield_snapshot_every_ticks=3,
              shield_retry_backoff_s=0.001,
              rca_backend="tpu" if tier == "rules" else "gnn",
              **BUCKETS, **TIERS[tier])
    kw.update(over)
    return cfg.load_settings(**kw)


def journal_batches(directory) -> list:
    """The batches of a (closed) shield's write-ahead journal."""
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.journal import (
        DeltaJournal)
    journal = DeltaJournal(str(directory))
    try:
        return journal.read()[0]
    finally:
        journal.close()


def make_scorer(pkg, tier, store, cfg, now_s, params):
    kw = {"device": "cpu"} if pkg == PORT_PKG else {}
    if tier == "rules":
        cls = importlib.import_module(pkg + ".rca.streaming").StreamingScorer
        return cls(store, cfg, now_s=now_s, **kw)
    cls = importlib.import_module(pkg + ".rca.gnn_streaming"
                                  ).GnnStreamingScorer
    return cls(store, cfg, params=params, now_s=now_s, **kw)


def make_injector(pkg, faults=(), seeded=None):
    mod = importlib.import_module(pkg + ".rca.faults")
    if seeded is not None:
        return mod.FaultInjector.seeded(**seeded)
    if not faults:
        return None
    return mod.FaultInjector([mod.Fault(**f) for f in faults])


def packed(scorer) -> np.ndarray:
    arrays = scorer._resident_arrays()
    return t_shield._snapshot_pack(*arrays).numpy().copy()


def run(directory, tier="rules", depth=2, faults=(), seeded=None,
        pkg=PORT_PKG, params=None, cfg=None, events=None, during=None,
        num_pods=120) -> Run:
    """One full shielded serving run over a fresh seeded world: churn in
    batches through the store, ``tick()`` after each batch (``during(i,
    shield)`` after tick i), one ``rescore()`` at the end. The shield is
    closed (writer joined) before it returns."""
    cfg = cfg or settings(pkg, tier, depth)
    stream_mod = importlib.import_module(pkg + ".simulator.stream")
    shield_mod = importlib.import_module(pkg + ".rca.shield")
    cluster, builder, incidents = _world(pkg, cfg, num_pods=num_pods)
    scorer = make_scorer(pkg, tier, builder.store, cfg,
                         cluster.now.timestamp(), params)
    shield = shield_mod.ShieldedScorer(
        scorer, cfg, directory=str(directory),
        injector=make_injector(pkg, faults, seeded))
    try:
        shield.recover_or_snapshot()
        if events is None:
            events = EVENTS if tier == "rules" else LEARNED_EVENTS
        stream = list(stream_mod.churn_events(
            cluster, events, seed=99,
            incident_ids=tuple(f"incident:{i.id}" for i in incidents)))
        for i, s in enumerate(range(0, len(stream), BATCH)):
            for ev in stream[s:s + BATCH]:
                stream_mod.store_step(cluster, builder.store, ev)
            shield.tick()
            if during is not None:
                during(i, shield)
        out = shield.rescore()
    finally:
        shield.close()
    return Run(out, shield, packed(shield.scorer) if pkg == PORT_PKG
               else None, (cluster, builder, cfg))


def restart(directory, tier, run_: Run, params=None):
    """Kill and restart: a fresh scorer and shield on ``directory`` over
    the run's store, recovered from its snapshot and journal suffix, then
    one caller boundary. Returns ``(recover result, Run)``."""
    cluster, builder, cfg = run_.world
    fresh = make_scorer(PORT_PKG, tier, builder.store, cfg,
                        cluster.now.timestamp(), params)
    shield = t_shield.ShieldedScorer(fresh, cfg, directory=str(directory))
    try:
        res = shield.recover()
        out = shield.rescore()
    finally:
        shield.close()
    return res, Run(out, shield, packed(fresh), run_.world)


def by_id(out, keys):
    return {iid: tuple(np.asarray(out[k])[row].tobytes() for k in keys)
            for row, iid in enumerate(out["incident_ids"])}


def assert_same(run_: Run, ref: Run, what: str, with_packed=True) -> None:
    """Bit parity by incident id (a recovery rebuild may permute rows),
    and of the packed resident state."""
    keys = PROB_KEYS if "probs" in ref.out else RESULT_KEYS
    mine, want = by_id(run_.out, keys), by_id(ref.out, keys)
    assert mine.keys() == want.keys(), what
    for iid in want:
        assert mine[iid] == want[iid], f"verdict diverged for {iid} ({what})"
    if with_packed:
        np.testing.assert_array_equal(run_.packed, ref.packed,
                                      err_msg=f"packed state ({what})")


def assert_rules_equal_jax(run_: Run, jax_run: Run, what: str) -> None:
    a = {iid: i for i, iid in enumerate(run_.out["incident_ids"])}
    b = {iid: i for i, iid in enumerate(jax_run.out["incident_ids"])}
    assert a.keys() == b.keys(), what
    for key in RESULT_KEYS:
        np.testing.assert_array_equal(
            np.asarray(run_.out[key])[[a[i] for i in a]],
            np.asarray(jax_run.out[key])[[b[i] for i in a]],
            err_msg=f"{key} ({what})")


def unfaulted(tmp_path_factory, tier="rules", depth=2, params=None,
              **kw) -> Run:
    """An unfaulted shielded run: the reference the faulted ones are held
    to. It makes no tier transition and recovers nothing."""
    ref = run(tmp_path_factory.mktemp(f"{tier}{depth}"), tier, depth,
              params=params, **kw)
    assert ref.shield.tier == "steady" and ref.shield.tier_log == []
    assert ref.shield.recoveries == 0
    assert ref.shield.snapshots >= 2        # the cadence actually ran
    return ref



def learned_baseline(tmp_path_factory, tier, params) -> dict:
    """The unfaulted learned run of ``tier`` at depth 2 (depth parity is
    bit-identical), and the JAX shield's composed run on the same world
    under a device loss: what each fault class of that tier is held to,
    bit for bit and within 1e-5 of the JAX package respectively."""
    ref = unfaulted(tmp_path_factory, tier, params=params)
    jax_run = run(tmp_path_factory.mktemp("jax"), "composed",
                  faults=[LEARNED_FAULTS["execute"]], pkg=JAX_PKG,
                  params=params)
    assert jax_run.shield.recoveries >= 1
    _assert_probs(ref.out, jax_run.out, f"{tier} unfaulted vs the JAX shield")
    return {"ref": ref, "jax": jax_run}


def check_learned_fault(tier, stage, base, params, tmp_path) -> None:
    """One fault at ``stage`` in a ``tier`` run, at pipeline depths 1 and
    2: recovered bit-identical to the unfaulted run, finite, and within
    1e-5 of the JAX shield with the same top-1."""
    for depth in (1, 2):
        got = run(tmp_path / f"d{depth}", tier, depth=depth,
                  faults=[LEARNED_FAULTS[stage]], params=params)
        what = f"{tier} {stage} d{depth}"
        assert got.shield.injector.fired, f"{what}: fault never fired"
        assert np.isfinite(got.out["probs"]).all()
        assert_same(got, base["ref"], what,
                    with_packed=got.shield.scorer.rebuilds == 0)
        _assert_probs(got.out, base["jax"].out, f"{what} vs the JAX shield")
