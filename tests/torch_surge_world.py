"""Shared harness of the port's multi-tenant tests (not collected): the
tenant worlds of ``tests/test_surge.py`` and ``tests/test_swell.py``,
built in either package with the injected incidents' ids fixed from the
seed, so the JAX ``MultiTenantScorer`` and the port's see the same ids;
the settings those tests use; and the verdict comparisons.

On the CPU a port scorer runs ``kernels/rules_fold``'s plain version."""
from __future__ import annotations

import importlib
import uuid

import numpy as np
import torch

JAX_PKG = "kubernetes_aiops_evidence_graph_tpu"
PORT_PKG = "kubernetes_aiops_evidence_graph_tpu_torch"

# one intra-op thread: these tensors are small, and the suite runs several
# pytest workers side by side on the host's cores
torch.set_num_threads(1)

# tests/test_surge.py:36-39 (the port's settings have no edge ladder: the
# rules path never reads padded edges)
SURGE = dict(node_bucket_sizes=(256, 1024, 4096),
             incident_bucket_sizes=(8, 32), rca_backend="tpu")
JAX_EDGES = dict(edge_bucket_sizes=(1024, 4096))

VERDICT_KEYS = ("top_rule_index", "any_match", "top_confidence",
                "top_score", "matched", "scores", "conditions")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def settings(pkg: str = PORT_PKG, **over):
    """SURGE settings of ``pkg`` with ``over`` applied."""
    extra = JAX_EDGES if pkg == JAX_PKG else {}
    return mod(pkg, "config").load_settings(**{**SURGE, **extra, **over})


def world(pkg: str, seed: int, incidents: int = 1, pods: int = 36,
          cfg=None):
    """One tenant's cluster + store with ``incidents`` injected scenarios
    (``tests/test_surge.py::_world``), the incidents' ids fixed."""
    cfg = cfg or settings(pkg)
    col = mod(pkg, "collectors")
    sim = mod(pkg, "simulator")
    cluster = sim.generate_cluster(num_pods=pods, seed=seed)
    rng = np.random.default_rng(seed)
    builder = mod(pkg, "graph").GraphBuilder()
    mod(pkg, "graph.topology_sync").sync_topology(cluster, builder.store)
    keys = sorted(cluster.deployments)
    names = sorted(sim.SCENARIOS)
    incs = []
    for i in range(incidents):
        inc = sim.inject(cluster, names[(seed + i) % len(names)],
                         keys[(i * 3) % len(keys)], rng)
        inc.id = uuid.UUID(int=seed * 1000 + i + 1)
        builder.ingest(inc, col.collect_all(
            inc, col.default_collectors(cluster, cfg), parallel=False))
        incs.append(inc)
    return cluster, builder, incs


def inject_more(pkg: str, cluster, builder, cfg, seed: int, count: int,
                first: int = 0, start: int = 100):
    """``count`` more incidents into a world (ids fixed from ``seed`` and
    ``start``), as ``tests/test_surge.py``'s bursts inject them."""
    col = mod(pkg, "collectors")
    sim = mod(pkg, "simulator")
    rng = np.random.default_rng(seed)
    keys = sorted(cluster.deployments)
    names = sorted(sim.SCENARIOS)
    for i in range(count):
        inc = sim.inject(cluster, names[(first + i) % len(names)],
                         keys[(i * 2) % len(keys)], rng)
        inc.id = uuid.UUID(int=seed * 1000 + start + i)
        builder.ingest(inc, col.collect_all(
            inc, col.default_collectors(cluster, cfg), parallel=False))


def pack(pkg: str, stores: dict, cfg, now_s: float = 0.0):
    cls = mod(pkg, "rca.surge").MultiTenantScorer
    kw = {"device": "cpu"} if pkg == PORT_PKG else {}
    return cls(stores, cfg, now_s=now_s, **kw)


def single(pkg: str, store, cfg, now_s: float = 0.0):
    cls = mod(pkg, "rca.streaming").StreamingScorer
    kw = {"device": "cpu"} if pkg == PORT_PKG else {}
    return cls(store, cfg, now_s=now_s, **kw)


FLEET = dict(swell_max_packs=2, swell_pack_tenants=2)


def server(pkg: str = PORT_PKG, journal_path=None, **over):
    """A ``SurgeServer`` of ``pkg`` on SURGE settings with ``over``."""
    cls = mod(pkg, "rca.surge").SurgeServer
    kw = {"device": "cpu"} if pkg == PORT_PKG else {}
    return cls(settings(pkg, **over), journal_path=journal_path, **kw)


def fleet3(pkg: str = PORT_PKG, journal_path=None):
    """``tests/test_swell.py``'s fleet: 3 tenants at pack_tenants=2."""
    srv = server(pkg, journal_path, **FLEET)
    stores = {}
    for i, seed in enumerate((3, 14, 25)):
        store = world(pkg, seed=seed, incidents=2)[1].store
        stores[f"t{i}"] = store
        srv.register(f"t{i}", store)
    return srv, stores


def by_id(out: dict, keys=VERDICT_KEYS, values: bool = False) -> dict:
    """{incident id: tuple of each key's row bytes}. ``values=True`` hashes
    each row's values as float64 (exact for the bool, int32 and float32
    outputs), to compare across packages: the port's ``conditions`` are
    bool where the JAX package's are float32."""
    def row(k, i):
        a = np.asarray(out[k])[i]
        return (a.astype(np.float64) if values else a).tobytes()
    return {iid: tuple(row(k, i) for k in keys)
            for i, iid in enumerate(out["incident_ids"])}


def tenant_verdicts(mt, raw: dict | None = None,
                    values: bool = False) -> dict:
    """{tenant: {local incident id: verdict bytes}} of one pack serve."""
    raw = mt.serve() if raw is None else raw
    return {t: by_id(d, values=values) for t, d in mt.tenant_rows(raw).items()}


def assert_snapshot_parity(mt, stores: dict, cfg, raw=None) -> dict:
    """Each tenant's pack verdicts against the port's snapshot path on its
    own store (one B1 pass a tenant), bit for bit. Returns the pack's
    verdicts by tenant."""
    from kubernetes_aiops_evidence_graph_tpu_torch.graph.snapshot import (
        build_snapshot)
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.cuda_backend import (
        CudaRcaBackend)
    got = tenant_verdicts(mt, raw)
    backend = CudaRcaBackend("cpu")
    for t, store in stores.items():
        ref = backend.score_snapshot(build_snapshot(store, cfg))
        assert got.get(t, {}) == by_id(ref), t
    return got
