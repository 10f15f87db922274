"""Live fault injection — failing workloads applied to a real cluster.

Parity with the reference IncidentSimulator (incident_simulator.py:15-267):
four fault scenarios as K8s manifests (crashloop, oom, imagepull, slowapp),
delete-then-create idempotency, and the ``simulator=kaeg-test`` label so
``cleanup`` can find everything it created. The hermetic analog lives in
scenarios.py/cluster.py; this module is the live-cluster path, sharing the
LiveClusterBackend transport (bearer-token K8s API over stdlib HTTP).
The port's copy of the JAX package's injector: the same manifests and
requests.
"""
from __future__ import annotations

import http.client
import json
import urllib.request
from typing import Any

LABEL_KEY = "simulator"
LABEL_VALUE = "kaeg-test"


def _labels(name: str) -> dict[str, str]:
    return {"app": name, LABEL_KEY: LABEL_VALUE}


def _deployment(name: str, namespace: str, containers: list[dict],
                replicas: int = 1) -> dict:
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {"name": name, "namespace": namespace,
                     "labels": _labels(name)},
        "spec": {
            "replicas": replicas,
            "selector": {"matchLabels": {"app": name}},
            "template": {
                "metadata": {"labels": _labels(name)},
                "spec": {"containers": containers},
            },
        },
    }


def manifests(scenario: str, namespace: str) -> list[dict]:
    """Manifests per fault scenario (reference incident_simulator.py:15-160)."""
    if scenario == "crashloop":
        return [_deployment("kaeg-sim-crashloop", namespace, [{
            "name": "app", "image": "busybox:1.36",
            "command": ["sh", "-c", "echo boot failed; exit 1"],
        }])]
    if scenario == "oom":
        return [_deployment("kaeg-sim-oom", namespace, [{
            "name": "app", "image": "python:3.11-alpine",
            "command": ["python", "-c",
                        "b=[];\nimport time\n"
                        "while True: b.append(bytearray(16*1024*1024)); time.sleep(0.2)"],
            "resources": {"limits": {"memory": "64Mi"},
                          "requests": {"memory": "32Mi"}},
        }])]
    if scenario == "imagepull":
        return [_deployment("kaeg-sim-imagepull", namespace, [{
            "name": "app",
            "image": "registry.invalid/nonexistent/image:latest",
        }])]
    if scenario == "slowapp":
        name = "kaeg-sim-slowapp"
        server = (
            "import http.server, random, time\n"
            "class H(http.server.BaseHTTPRequestHandler):\n"
            "    def do_GET(self):\n"
            "        time.sleep(random.uniform(1, 5))\n"
            "        code = 500 if random.random() < 0.3 else 200\n"
            "        self.send_response(code); self.end_headers()\n"
            "http.server.HTTPServer(('', 8080), H).serve_forever()\n")
        return [
            _deployment(name, namespace, [{
                "name": "app", "image": "python:3.11-alpine",
                "command": ["python", "-c", server],
                "ports": [{"containerPort": 8080}],
            }], replicas=2),
            {
                "apiVersion": "v1", "kind": "Service",
                "metadata": {"name": name, "namespace": namespace,
                             "labels": _labels(name)},
                "spec": {"selector": {"app": name},
                         "ports": [{"port": 80, "targetPort": 8080}]},
            },
        ]
    raise ValueError(f"unknown live scenario {scenario!r} "
                     "(crashloop|oom|imagepull|slowapp)")


class LiveFaultInjector:
    """Applies/removes fault manifests through the K8s API."""

    def __init__(self, backend: Any) -> None:
        # backend: LiveClusterBackend (reuses its URL/token/TLS context)
        self.backend = backend

    def _collection(self, manifest: dict) -> str:
        ns = manifest["metadata"]["namespace"]
        if manifest["kind"] == "Deployment":
            return f"/apis/apps/v1/namespaces/{ns}/deployments"
        if manifest["kind"] == "Service":
            return f"/api/v1/namespaces/{ns}/services"
        raise ValueError(f"unsupported kind {manifest['kind']}")

    def _request(self, method: str, path: str, payload: dict | None = None) -> bool:
        b = self.backend
        req = urllib.request.Request(
            b.k8s_url + path, method=method,
            data=json.dumps(payload).encode() if payload is not None else None)
        if b._token:
            req.add_header("Authorization", f"Bearer {b._token}")
        if payload is not None:
            req.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(req, timeout=b.timeout_s,
                                        context=b._ctx) as resp:
                return 200 <= resp.status < 300
        except (OSError, http.client.HTTPException):
            return False

    def create(self, scenario: str, namespace: str = "default") -> list[str]:
        """Delete-then-create each manifest (idempotent,
        reference incident_simulator.py:203-231)."""
        created = []
        for m in manifests(scenario, namespace):
            coll = self._collection(m)
            self._request("DELETE", f"{coll}/{m['metadata']['name']}")
            if self._request("POST", coll, m):
                created.append(f"{m['kind']}/{m['metadata']['name']}")
        return created

    def cleanup(self, namespace: str = "default") -> list[str]:
        """Remove everything labeled simulator=kaeg-test
        (reference incident_simulator.py:239-267)."""
        removed = []
        selector = f"{LABEL_KEY}={LABEL_VALUE}"
        for coll, kind in (
            (f"/apis/apps/v1/namespaces/{namespace}/deployments", "Deployment"),
            (f"/api/v1/namespaces/{namespace}/services", "Service"),
        ):
            try:
                data = self.backend._get(self.backend.k8s_url, coll,
                                         {"labelSelector": selector}, bearer=True)
            except (OSError, ValueError, http.client.HTTPException):
                continue
            for item in data.get("items", []):
                name = item["metadata"]["name"]
                if self._request("DELETE", f"{coll}/{name}"):
                    removed.append(f"{kind}/{name}")
        return removed

    def list_injected(self, namespace: str = "default") -> list[str]:
        out = []
        selector = f"{LABEL_KEY}={LABEL_VALUE}"
        for coll, kind in (
            (f"/apis/apps/v1/namespaces/{namespace}/deployments", "Deployment"),
            (f"/api/v1/namespaces/{namespace}/services", "Service"),
        ):
            try:
                data = self.backend._get(self.backend.k8s_url, coll,
                                         {"labelSelector": selector}, bearer=True)
            except (OSError, ValueError, http.client.HTTPException):
                continue
            out += [f"{kind}/{i['metadata']['name']}" for i in data.get("items", [])]
        return out
