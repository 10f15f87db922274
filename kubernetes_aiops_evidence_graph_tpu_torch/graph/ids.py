"""Canonical graph-entity id scheme.

Matches the reference's "{type}:{namespace}:{name}" convention
(e.g. "pod:default:api-server-7d4f5b6c8-xyz", evidence.py:122) so store keys
and subgraph payloads are interchangeable.
"""
from __future__ import annotations


def incident_id(uid: str) -> str:
    return f"incident:{uid}"


def pod_id(namespace: str, name: str) -> str:
    return f"pod:{namespace}:{name}"


def deployment_id(namespace: str, name: str) -> str:
    return f"deployment:{namespace}:{name}"


def replicaset_id(namespace: str, name: str) -> str:
    return f"replicaset:{namespace}:{name}"


def node_id(name: str) -> str:
    return f"node:{name}"


def service_id(namespace: str, name: str) -> str:
    return f"service:{namespace}:{name}"


def hpa_id(namespace: str, name: str) -> str:
    return f"hpa:{namespace}:{name}"


def configmap_id(namespace: str, name: str) -> str:
    return f"configmap:{namespace}:{name}"


def change_id(namespace: str, name: str, revision: int | str) -> str:
    return f"change:{namespace}:{name}:{revision}"


def namespace_id(name: str) -> str:
    return f"namespace:{name}"
