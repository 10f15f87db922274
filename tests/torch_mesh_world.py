"""Shared harness of the mesh-recovery tests (``tests/test_torch_mesh_*.py``):
one shielded serving run on a graph-sharded mesh of CPU host positions,
in either package, over the seeded world of ``tests/test_heal.py``.

Bucket ladders divide by 12, so both a D = 4 serving layout and its D' = 3
survivor layout shard (``pn % D == 0``, the contract the heal planner
keeps). The port's runs cut their meshes from an explicit pool of eight
CPU positions (the counterpart of the JAX conftest's eight host devices);
the JAX runs use that conftest's devices. Compare against the JAX package
only on its deterministic paths: fresh builds, at pipeline depth 1 (its
depth-2 churn races in ``tick_async``). Not a test module: the test files
import it.
"""
from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch

from tests.test_torch_streaming import JAX_PKG, PORT_PKG, RESULT_KEYS, _world

# one intra-op thread: these tensors are small, and the suite runs
# several pytest workers side by side on the host's cores
torch.set_num_threads(1)

BUCKETS = dict(node_bucket_sizes=(384, 1536), incident_bucket_sizes=(12, 48))
EVENTS, BATCH = 120, 20
POOL = [torch.device("cpu")] * 8
PROB_KEYS = ("probs", "top_rule_index", "any_match", "top_confidence")

# a persistent loss of mesh position 2, repeating as often as the
# classification threshold: failures 1..N-1 walk the transient rungs,
# failure N opens the position's breaker and the ladder heals
SHARD_LOSS = dict(stage="shard_loss", at=2, kind="shard_loss", repeats=3,
                  shard=2)


@dataclasses.dataclass
class Run:
    out: dict
    shield: object
    world: tuple
    stream: list = dataclasses.field(default_factory=list)


def settings(pkg=PORT_PKG, shards=1, depth=2, **over):
    over.setdefault("mesh_heal_cooldown_s", 60.0)   # no implicit reexpand
    kw = dict(serve_graph_shards=shards, serve_pipeline_depth=depth,
              shield_snapshot_every_ticks=3, shield_retry_backoff_s=0.001,
              mesh_shard_failure_threshold=3, **BUCKETS)
    kw.update(over)
    return importlib.import_module(pkg + ".config").load_settings(**kw)


def mesh(shards: int):
    """A ``(1 x shards)`` serving mesh cut from :data:`POOL`."""
    from kubernetes_aiops_evidence_graph_tpu_torch.rca import heal
    return heal.survivor_mesh(shards, (), POOL)


def make_scorer(pkg, store, cfg, now_s, params=None, shards=None):
    """The rules scorer (``params`` None) or the learned one, at the
    settings' shard count (the port's on a mesh of :data:`POOL`)."""
    learned = params is not None
    name = "gnn_streaming" if learned else "streaming"
    cls = getattr(importlib.import_module(f"{pkg}.rca.{name}"),
                  "GnnStreamingScorer" if learned else "StreamingScorer")
    kw = {"params": params} if learned else {}
    if pkg == PORT_PKG:
        d = cfg.serve_graph_shards if shards is None else shards
        kw.update(device="cpu", mesh=mesh(d), mesh_from_settings=False)
    return cls(store, cfg, now_s=now_s, **kw)


def injector(pkg, faults=(), seeded=None):
    mod = importlib.import_module(pkg + ".rca.faults")
    if seeded is not None:
        return mod.FaultInjector.seeded(**seeded)
    if not faults:
        return None
    return mod.FaultInjector([mod.Fault(**f) for f in faults])


def shield_of(pkg, scorer, cfg, directory, inj=None):
    cls = importlib.import_module(pkg + ".rca.shield").ShieldedScorer
    kw = {"pool": POOL} if pkg == PORT_PKG else {}
    return cls(scorer, cfg, directory=str(directory), injector=inj, **kw)


def stream_of(pkg, cluster, incidents, events):
    mod = importlib.import_module(pkg + ".simulator.stream")
    return list(mod.churn_events(
        cluster, events, seed=99,
        incident_ids=tuple(f"incident:{i.id}" for i in incidents)))


def run(directory, pkg=PORT_PKG, shards=4, faults=(), seeded=None, cfg=None,
        params=None, events=EVENTS, during=None, sleep_s=0.0,
        close=True, num_pods=120, ticks=None) -> Run:
    """A shielded churn over a fresh seeded world: ``events`` full-mix
    events through the STORE in batches of :data:`BATCH` (the first
    ``ticks`` batches when given; the script is ``Run.stream``),
    ``tick()`` after each (``during(i, shield)`` after tick i), one
    ``rescore()`` at the end."""
    import time
    cfg = cfg or settings(pkg, shards)
    stream_mod = importlib.import_module(pkg + ".simulator.stream")
    cluster, builder, incidents = _world(pkg, cfg, num_pods=num_pods)
    scorer = make_scorer(pkg, builder.store, cfg, cluster.now.timestamp(),
                         params)
    shield = shield_of(pkg, scorer, cfg, directory,
                       injector(pkg, faults, seeded))
    try:
        shield.recover_or_snapshot()
        stream = stream_of(pkg, cluster, incidents, events)
        starts = list(range(0, len(stream), BATCH))[:ticks]
        for i, s in enumerate(starts):
            for ev in stream[s:s + BATCH]:
                stream_mod.store_step(cluster, builder.store, ev)
            shield.tick()
            if during is not None:
                during(i, shield)
            if sleep_s:
                time.sleep(sleep_s)
        out = shield.rescore()
    finally:
        if close:
            shield.close()
    return Run(out, shield, (cluster, builder, cfg, incidents), stream)


def fresh(pkg, run_: Run, shards: int, params=None, depth=1) -> dict:
    """A fresh build at ``shards`` on the run's final store: its rescore."""
    cluster, builder, cfg, _ = run_.world
    cfg = dataclasses.replace(cfg, serve_graph_shards=shards,
                              serve_pipeline_depth=depth)
    return make_scorer(pkg, builder.store, cfg, cluster.now.timestamp(),
                       params, shards).rescore()


def by_id(out, keys=None) -> dict:
    keys = keys or (PROB_KEYS if "probs" in out else RESULT_KEYS)
    return {iid: tuple(np.asarray(out[k])[row].tobytes() for k in keys)
            for row, iid in enumerate(out["incident_ids"])}


def assert_same(mine: dict, ref: dict, what: str) -> None:
    """Bit parity by incident id."""
    a, b = by_id(mine), by_id(ref)
    assert a.keys() == b.keys(), what
    for iid in b:
        assert a[iid] == b[iid], f"verdict diverged for {iid} ({what})"


def assert_equal_jax(mine: dict, jax_out: dict, what: str) -> None:
    """The rules fields equal the JAX package's, incident by incident."""
    a = {iid: i for i, iid in enumerate(mine["incident_ids"])}
    b = {iid: i for i, iid in enumerate(jax_out["incident_ids"])}
    assert a.keys() == b.keys(), what
    for key in RESULT_KEYS:
        np.testing.assert_array_equal(
            np.asarray(mine[key])[[a[i] for i in a]],
            np.asarray(jax_out[key])[[b[i] for i in a]],
            err_msg=f"{key} ({what})")


def jax_fresh(tmp_path_factory, shards: int, params=None,
              events=EVENTS) -> dict:
    """The JAX package's unfaulted shielded churn at ``shards``, pipeline
    depth 1 (deterministic), over the same world and script: its final
    rescore."""
    cfg = settings(JAX_PKG, shards, depth=1)
    return run(tmp_path_factory.mktemp(f"jax{shards}"), JAX_PKG, shards,
               cfg=cfg, params=params, events=events).out
