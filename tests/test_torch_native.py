"""The port's native host kernels (``kernels/kaeg_native.cpp`` through
``native.py``) against the JAX package's ``native.py`` and the Python
paths on the same inputs: the log scanner (and ``LogsCollector`` on top of
it), the k-hop BFS (and the store's subgraph above
``_NATIVE_BFS_MIN_NODES``), exact; a build with no ``g++`` raises
``KernelError`` instead of falling back."""
import numpy as np
import pytest

from kubernetes_aiops_evidence_graph_tpu import native as jnative
from kubernetes_aiops_evidence_graph_tpu.collectors.logs import (
    ERROR_PATTERNS as JAX_PATTERNS, LogsCollector as JaxLogsCollector)
from kubernetes_aiops_evidence_graph_tpu_torch import native
from kubernetes_aiops_evidence_graph_tpu_torch.collectors.logs import (
    ERROR_PATTERNS, LogsCollector, scan_python)
from kubernetes_aiops_evidence_graph_tpu_torch.kernels import _build

LINES = [
    "ERROR dial tcp 10.0.0.7:5432: connection refused",
    "WARN upstream request timeout after 5s",
    "terror in the aisles",              # must NOT match 'error' (\b)
    "CRITICAL panic: nil pointer dereference",
    "disk full on /var",
    "x509: certificate signed by unknown authority",
    "all good here",
    "Out of memory: killed process 1234",
    "oom-kill event; request timedout; permission denied",
    "",
]


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package's library is the reference: both must be built."""
    assert jnative.available(), "the JAX package's native library"
    assert native.available()


def test_scan_logs_equals_jax_native_and_the_regexes():
    counts, flags = native.scan_logs_native(LINES)
    jcounts, jflags = jnative.scan_logs_native(LINES)
    assert counts == jcounts
    np.testing.assert_array_equal(flags, jflags)
    assert flags.dtype == np.uint64 and len(flags) == len(LINES)
    assert [c for c, _a, _b in native.LOG_CATEGORIES] == list(ERROR_PATTERNS)
    for cat, rx in ERROR_PATTERNS.items():
        assert counts[cat] == sum(1 for ln in LINES if rx.search(ln)), cat
        assert JAX_PATTERNS[cat].pattern == rx.pattern
    assert flags[6] == 0 and flags[9] == 0
    # the cap leaves only max_lines flags
    c3, f3 = native.scan_logs_native(LINES, max_lines=3)
    j3, jf3 = jnative.scan_logs_native(LINES, max_lines=3)
    assert c3 == j3 and f3.tolist() == jf3.tolist() and len(f3) == 3
    assert native.scan_logs_native([])[1].size == 0


def test_scan_logs_review_regressions():
    """tests/test_native.py:60's inputs, against the JAX library and the
    Python regexes."""
    for lines in (["a\nfatal error\nfatal error\nfatal error"],
                  ["", "fatal error occurred"]):
        got, want = native.scan_logs_native(lines), \
            jnative.scan_logs_native(lines)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
    assert len(native.scan_logs_native(
        ["a\nfatal error\nfatal error"])[1]) == 1
    _c, flags = native.scan_logs_native(["", "fatal error occurred"])
    assert flags[0] == 0 and flags[1] != 0
    for line in ("Dismissing stale cache entry", "request timedout",
                 "networking layer ok", "terror in the aisles"):
        _c, flags = native.scan_logs_native([line])
        py = {cat for cat, rx in ERROR_PATTERNS.items() if rx.search(line)}
        nat = {native.LOG_CATEGORIES[i][0]
               for i in range(len(native.LOG_CATEGORIES))
               if int(flags[0]) >> i & 1}
        assert nat == py, line


def _snapshot_edges():
    from tests.test_torch_streaming import PORT_PKG, SMALL, _world
    from kubernetes_aiops_evidence_graph_tpu_torch.config import load_settings
    from kubernetes_aiops_evidence_graph_tpu_torch.graph.snapshot import (
        build_snapshot)
    cfg = load_settings(**SMALL)
    cluster, builder, _ = _world(PORT_PKG, cfg, seed=3, num_pods=120)
    return build_snapshot(builder.store, cfg,
                          now_s=cluster.now.timestamp()), builder.store


def test_khop_reach_equals_jax_native_and_a_python_bfs():
    snap, _store = _snapshot_edges()
    live = snap.edge_mask > 0
    src, dst = snap.edge_src[live], snap.edge_dst[live]
    adj: dict[int, set[int]] = {}
    for s, d in zip(src.tolist(), dst.tolist()):
        adj.setdefault(s, set()).add(d)
    for seed in snap.incident_nodes[snap.incident_mask > 0][:3].tolist():
        for hops in (1, 2, 3):
            reach = native.khop_reach_native(src, dst, snap.padded_nodes,
                                             seed, hops)
            np.testing.assert_array_equal(
                reach, jnative.khop_reach_native(src, dst, snap.padded_nodes,
                                                 seed, hops))
            seen, frontier = {seed}, [seed]
            for _ in range(hops):
                frontier = [v for u in frontier for v in adj.get(u, ())
                            if not (v in seen or seen.add(v))]
            assert set(np.nonzero(reach)[0].tolist()) == seen


def test_khop_isolated_seed_and_bounds_validation():
    src = np.array([0, 1], dtype=np.int32)
    dst = np.array([1, 0], dtype=np.int32)
    assert native.khop_reach_native(src, dst, 4, seed=3, hops=5).tolist() \
        == jnative.khop_reach_native(src, dst, 4, seed=3, hops=5).tolist() \
        == [0, 0, 0, 1]
    src = np.array([0, 9, -1], dtype=np.int32)   # 9 and -1 out of range
    dst = np.array([1, 0, 2], dtype=np.int32)
    assert native.khop_reach_native(src, dst, 3, seed=0, hops=2).tolist() \
        == [1, 1, 0]
    for bad in (7, -1):
        with pytest.raises(ValueError):
            native.khop_reach_native(src, dst, 3, seed=bad, hops=1)
        with pytest.raises(ValueError):
            jnative.khop_reach_native(src, dst, 3, seed=bad, hops=1)


def _chain_store(pkg_store, gen, rel, n: int, rng):
    store = pkg_store()
    store.upsert_entities(
        [gen(id="incident:i1", type="Incident", properties={})]
        + [gen(id=f"pod:p{i}", type="Pod", properties={}) for i in range(n)])
    rels = [rel(source_id="incident:i1", target_id="pod:p0",
                relation_type="AFFECTS")]
    rels += [rel(source_id=f"pod:p{i}", target_id=f"pod:p{i + 1}",
                 relation_type="CALLS") for i in range(n - 1)]
    for a, b in rng.integers(0, n, (200, 2)).tolist():
        rels.append(rel(source_id=f"pod:p{a}", target_id=f"pod:p{b}",
                        relation_type="CALLS"))
    store.upsert_relations(rels)
    return store


def test_store_subgraph_native_path_equals_python_and_jax():
    """Above _NATIVE_BFS_MIN_NODES the store routes its BFS through the
    C++ kernel (after removals too: the seed is the dense COO row); the
    ids equal the Python BFS's and the JAX store's."""
    from kubernetes_aiops_evidence_graph_tpu.graph.store import (
        EvidenceGraphStore as JStore)
    from kubernetes_aiops_evidence_graph_tpu.models import (
        GraphEntity as JEnt, GraphRelation as JRel)
    from kubernetes_aiops_evidence_graph_tpu_torch.graph.store import (
        EvidenceGraphStore)
    from kubernetes_aiops_evidence_graph_tpu_torch.models import (
        GraphEntity, GraphRelation)
    n = EvidenceGraphStore._NATIVE_BFS_MIN_NODES + 50
    assert n - 50 == JStore._NATIVE_BFS_MIN_NODES
    store = _chain_store(EvidenceGraphStore, GraphEntity, GraphRelation, n,
                         np.random.default_rng(0))
    jstore = _chain_store(JStore, JEnt, JRel, n, np.random.default_rng(0))
    for s in (store, jstore):
        s.remove_node("pod:p7")            # a hole in the node indices
    assert store.node_count() > EvidenceGraphStore._NATIVE_BFS_MIN_NODES
    py = EvidenceGraphStore()    # same graph, the Python BFS forced
    py._nodes, py._edges = store._nodes, store._edges
    py._out, py._in = store._out, store._in
    py._NATIVE_BFS_MIN_NODES = 10 ** 9
    before = native.calls["khop_reach"]
    for depth in (1, 2, 3):
        got = store.get_incident_subgraph("i1", depth=depth)
        with py._lock:
            want = py._bfs_reach("incident:i1", depth)
        assert {x["id"] for x in got["nodes"]} == want
        assert got == jstore.get_incident_subgraph("i1", depth=depth)
    assert native.calls["khop_reach"] == before + 3


@pytest.mark.parametrize("scenario", ["network", "oom", "crashloop_deploy"])
def test_logs_collector_equals_jax_and_the_python_scan(scenario):
    from kubernetes_aiops_evidence_graph_tpu.config import load_settings as jl
    from kubernetes_aiops_evidence_graph_tpu.simulator import (
        generate_cluster as jgen, inject as jinject)
    from kubernetes_aiops_evidence_graph_tpu_torch.config import load_settings
    from kubernetes_aiops_evidence_graph_tpu_torch.simulator import (
        generate_cluster, inject)
    cluster = generate_cluster(num_pods=60, seed=8)
    incident = inject(cluster, scenario, sorted(cluster.deployments)[0],
                      np.random.default_rng(8))
    jcluster = jgen(num_pods=60, seed=8)
    jinc = jinject(jcluster, scenario, sorted(jcluster.deployments)[0],
                   np.random.default_rng(8))
    lines = cluster.query_logs(incident.namespace, incident.service,
                               limit=1000)
    assert lines == jcluster.query_logs(jinc.namespace, jinc.service,
                                        limit=1000)
    got = LogsCollector(cluster, load_settings())._scan(lines)
    assert got == scan_python(lines)
    assert got == JaxLogsCollector(jcluster, jl())._scan(lines)


def test_build_without_gxx_raises_kernel_error(monkeypatch, tmp_path):
    """No g++ on PATH and nothing built: the first use raises
    KernelError (no silent Python fallback), and available() says so."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(_build.KernelError, match="g\\+\\+ not found"):
        native.scan_logs_native(["fatal error"])
    with pytest.raises(_build.KernelError):
        native.khop_reach_native(np.zeros(0, np.int32),
                                 np.zeros(0, np.int32), 2, 0, 1)
    assert not native.available()
    with pytest.raises(_build.KernelError):
        LogsCollector.__new__(LogsCollector)._scan(["fatal error"])
