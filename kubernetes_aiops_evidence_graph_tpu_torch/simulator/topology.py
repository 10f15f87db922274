"""Synthetic cluster topology generation.

Deterministic, seedable generator for BASELINE.json's scale ladder
(200 pods → 50k nodes): namespaces, nodes, deployments (with services,
HPAs, configmaps), pods spread over nodes, and a CALLS mesh between
services. All randomness flows from one numpy Generator so identical seeds
reproduce identical clusters on every host.
"""
from __future__ import annotations

import numpy as np

from ..utils.timeutils import utcnow
from .cluster import (
    ConfigMapState,
    DeploymentState,
    FakeCluster,
    HPAState,
    NodeState,
    PodState,
    ServiceState,
)


def generate_cluster(
    num_pods: int = 200,
    seed: int = 0,
    pods_per_deployment: int = 4,
    pods_per_node: int = 12,
    namespaces: int | None = None,
    calls_per_service: float = 1.5,
) -> FakeCluster:
    rng = np.random.default_rng(seed)
    cluster = FakeCluster(seed=seed)
    cluster.now = utcnow()

    n_deploys = max(1, num_pods // pods_per_deployment)
    n_nodes = max(1, num_pods // pods_per_node)
    n_ns = namespaces if namespaces is not None else max(1, min(50, n_deploys // 8))

    ns_names = [f"ns-{i}" for i in range(n_ns)]
    ns_names[0] = "default"

    for i in range(n_nodes):
        name = f"node-{i}"
        cluster.nodes[name] = NodeState(name=name)

    pod_budget = num_pods
    deploy_index = 0
    while pod_budget > 0 and deploy_index < n_deploys:
        ns = ns_names[deploy_index % n_ns]
        dname = f"svc-{deploy_index}"
        replicas = int(min(pod_budget, max(1, rng.poisson(pods_per_deployment))))
        pod_budget -= replicas
        key = f"{ns}/{dname}"
        cluster.deployments[key] = DeploymentState(
            name=dname, namespace=ns, service=dname,
            replicas=replicas, ready_replicas=replicas,
        )
        cluster.services[key] = ServiceState(name=dname, namespace=ns, deployment=dname)
        if rng.random() < 0.3:
            cluster.hpas[key] = HPAState(
                name=dname, namespace=ns, deployment=dname,
                max_replicas=replicas + int(rng.integers(1, 5)),
                current_replicas=replicas,
            )
        if rng.random() < 0.5:
            cluster.configmaps[f"{ns}/{dname}-config"] = ConfigMapState(
                name=f"{dname}-config", namespace=ns, mounted_by=[dname],
            )
        for r in range(replicas):
            suffix = rng.integers(0, 16**5)
            pname = f"{dname}-{suffix:05x}-{r}"
            node = f"node-{int(rng.integers(0, n_nodes))}"
            cluster.pods[f"{ns}/{pname}"] = PodState(
                name=pname, namespace=ns, deployment=dname, service=dname,
                node=node, started_at=cluster.now,
            )
        deploy_index += 1

    # CALLS mesh: each service calls a few others (neo4j.py:254-278 analog)
    deploy_keys = sorted(cluster.services)
    for key in deploy_keys:
        svc = cluster.services[key]
        n_calls = int(rng.poisson(calls_per_service))
        for _ in range(n_calls):
            other = deploy_keys[int(rng.integers(0, len(deploy_keys)))]
            o = cluster.services[other]
            if o.name != svc.name and o.namespace == svc.namespace and o.name not in svc.calls:
                svc.calls.append(o.name)

    return cluster
