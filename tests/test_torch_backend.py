"""The port's batched backend (CudaRcaBackend on the CPU, i.e. the kernel's
plain version) against the JAX package's TpuRcaBackend: the same
snapshots give the same seven outputs exactly, for every scenario, mixed
batches and packed multi-tenant passes — both on the JAX package's own
snapshot (through ``snapshot_from_numpy``) and on the snapshot the port
builds itself from the same seed, whose arrays are byte-equal."""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu.rca.tpu_backend import TpuRcaBackend
from kubernetes_aiops_evidence_graph_tpu.simulator import SCENARIOS
from kubernetes_aiops_evidence_graph_tpu_torch.graph.snapshot import (
    snapshot_from_numpy)
from kubernetes_aiops_evidence_graph_tpu_torch.rca import RULES, get_backend
from kubernetes_aiops_evidence_graph_tpu_torch.rca.cuda_backend import (
    CudaRcaBackend)

# one intra-op thread: these tensors are small, and the suite runs
# several pytest workers side by side on the host's cores
torch.set_num_threads(1)

JAX_PKG = "kubernetes_aiops_evidence_graph_tpu"
PORT_PKG = "kubernetes_aiops_evidence_graph_tpu_torch"
FULL = ("conditions", "matched", "scores", "top_rule_index", "any_match",
        "top_confidence", "top_score")
TOP = ("top_rule_index", "any_match", "top_confidence", "top_score")
ARRAYS = ("node_kind", "features", "node_mask", "edge_src", "edge_dst",
          "edge_rel", "edge_mask", "incident_nodes", "incident_mask")


def run_pipeline(pkg, scenario_names, num_pods=200, seed=7):
    """tests/test_rca_parity.run_pipeline through either package."""
    col = importlib.import_module(pkg + ".collectors")
    cfg = importlib.import_module(pkg + ".config")
    gr = importlib.import_module(pkg + ".graph")
    sim = importlib.import_module(pkg + ".simulator")
    small = cfg.load_settings(node_bucket_sizes=(512, 2048),
                              incident_bucket_sizes=(8, 32))
    cluster = sim.generate_cluster(num_pods=num_pods, seed=seed)
    keys = sorted(cluster.deployments)
    rng = np.random.default_rng(seed)
    builder = gr.GraphBuilder()
    incidents = [sim.inject(cluster, name, keys[(i * 7) % len(keys)], rng)
                 for i, name in enumerate(scenario_names)]
    evidence = {}
    for inc in incidents:
        results = col.collect_all(inc, col.default_collectors(cluster, small),
                                  parallel=False)
        builder.ingest(inc, results)
        evidence[inc.id] = [ev.model_dump(mode="json")
                            for r in results for ev in r.evidence]
    snapshot = gr.build_snapshot(builder.store, small,
                                 now_s=cluster.now.timestamp())
    return incidents, evidence, snapshot


def _port_snapshot(jax_snapshot):
    return snapshot_from_numpy(dataclasses.asdict(jax_snapshot))


def _assert_raw_equal(mine, ref, keys=FULL):
    for k in keys:
        a, b = np.asarray(mine[k]), np.asarray(ref[k])
        assert a.shape == b.shape, (k, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scenario_matches_jax_backend_on_both_snapshots(scenario):
    _, _, jsnap = run_pipeline(JAX_PKG, [scenario])
    ref = TpuRcaBackend().score_snapshot(jsnap)
    port = CudaRcaBackend("cpu")
    _assert_raw_equal(port.score_snapshot(_port_snapshot(jsnap)), ref)

    incidents, _, psnap = run_pipeline(PORT_PKG, [scenario])
    for name in ARRAYS:
        a, b = getattr(psnap, name), getattr(jsnap, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert psnap.rel_offsets == jsnap.rel_offsets
    raw = port.score_snapshot(psnap)
    _assert_raw_equal(raw, ref)
    top = RULES[int(raw["top_rule_index"][0])]
    assert raw["any_match"][0] and top.id == SCENARIOS[scenario].expected_rule


def test_mixed_batch_matches_jax_and_cpu_oracle():
    names = sorted(SCENARIOS)
    _, _, jsnap = run_pipeline(JAX_PKG, names, num_pods=400, seed=11)
    incidents, evidence, psnap = run_pipeline(PORT_PKG, names, num_pods=400,
                                              seed=11)
    ref = TpuRcaBackend().score_snapshot(jsnap)
    port = get_backend("tpu", device="cpu")
    raw = port.score_snapshot(psnap)
    _assert_raw_equal(raw, ref)

    results = port.results(raw=raw)
    assert [r.top_hypothesis.rule_id for r in results] == [
        r.top_hypothesis.rule_id for r in TpuRcaBackend().results(raw=ref)]
    cpu = get_backend("cpu")
    row = {nid: i for i, nid in enumerate(raw["incident_ids"])}
    for inc in incidents:
        want = cpu.score_incident(inc.id, evidence[inc.id]).top_hypothesis
        got = results[row[f"incident:{inc.id}"]].top_hypothesis
        assert got.rule_id == want.rule_id
        assert got.final_score == pytest.approx(want.final_score, abs=1e-6)
        assert got.backend == "tpu" and got.rank == 1


def test_results_full_and_narrowed():
    _, _, psnap = run_pipeline(PORT_PKG, ["oom", "crashloop"], num_pods=200,
                               seed=3)
    port = CudaRcaBackend("cpu")
    full = port.results(psnap)
    top = port.score_snapshot(psnap, fields="top")
    assert set(top) >= set(TOP) and "matched" not in top
    narrowed = port.results(raw=top)
    for f, n in zip(full, narrowed):
        assert f.incident_id == n.incident_id
        assert f.top_hypothesis.rule_id == n.top_hypothesis.rule_id
        assert len(n.hypotheses) == 1 and len(f.hypotheses) >= 1
        assert f.rules_matched[:1] == n.rules_matched
    with pytest.raises(KeyError):
        port.score_snapshot(psnap, fields="bogus")
    with pytest.raises(ValueError):
        port.results()


def test_unmatched_incident_is_unknown():
    _, _, psnap = run_pipeline(PORT_PKG, [], num_pods=100)
    assert psnap.num_incidents == 0
    assert CudaRcaBackend("cpu").results(psnap) == []
    raw = {"incident_ids": ("incident:not-a-uuid",),
           "any_match": np.array([False]),
           "top_rule_index": np.array([0], np.int32),
           "top_score": np.array([0.15], np.float32)}
    (res,) = CudaRcaBackend("cpu").results(raw=raw)
    assert res.top_hypothesis.rule_id == "unknown"
    assert res.top_hypothesis.backend == "tpu" and res.rules_matched == []


@pytest.mark.parametrize("fields", ["top", "full"])
def test_packed_tenants_match_jax_and_own_passes(fields):
    """k tenants of different sizes in one pass: each tenant's rows equal
    the JAX package's packed pass and the tenant's own score_snapshot."""
    worlds = [run_pipeline(JAX_PKG, names, num_pods=pods, seed=seed)[2]
              for names, pods, seed in (
                  (["oom", "network"], 150, 1),
                  (sorted(SCENARIOS)[:6], 300, 2),
                  (["node_pressure"], 120, 3))]
    ref = TpuRcaBackend().score_snapshots(worlds, fields=fields)
    port = CudaRcaBackend("cpu")
    snaps = [_port_snapshot(w) for w in worlds]
    got = port.score_snapshots(snaps, fields=fields)
    keys = FULL if fields == "full" else TOP
    assert len(got) == len(ref) == 3
    for mine, theirs, snap in zip(got, ref, snaps):
        _assert_raw_equal(mine, theirs, keys)
        _assert_raw_equal(mine, port.score_snapshot(snap), keys)
        assert mine["device_passes"] == 1
    assert port.score_snapshots([]) == []


def test_prepared_batch_equals_jax_prep_and_is_cached():
    _, _, jsnap = run_pipeline(JAX_PKG, sorted(SCENARIOS), num_pods=300,
                               seed=5)
    ref = TpuRcaBackend().prepared(jsnap)
    port = CudaRcaBackend("cpu")
    snap = _port_snapshot(jsnap)
    mine = port.prepared(snap)
    for f in ("ev_idx", "ev_cnt", "ev_pair_slot", "features"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(ref, f))
    assert (mine.pair_width, mine.padded_incidents) == (
        ref.pair_width, ref.padded_incidents)
    assert port.device_arrays(snap) is port.device_arrays(snap)
    assert port.score_snapshot(snap)["prep_seconds"] == 0.0
