"""Boundary of the PyTorch port: it imports no JAX, no orbax, no pydantic, no
yaml and nothing of the JAX package; its entry points default to CUDA and raise
without it; what it copied from the JAX package (ladders, query library,
data models) still agrees with the original."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "kubernetes_aiops_evidence_graph_tpu_torch"
JAX_PKG = "kubernetes_aiops_evidence_graph_tpu"
FORBIDDEN = ("jax", "jaxlib", "orbax", "pydantic", "yaml")

# one intra-op thread: these tensors are small, and the suite runs
# several pytest workers side by side on the host's cores
torch.set_num_threads(1)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_every_port_module_imports_without_jax_orbax_pydantic_yaml():
    code = (
        "import sys, importlib, pkgutil\n"
        f"for m in {FORBIDDEN!r}:\n"
        "    sys.modules[m] = None\n"
        "import kubernetes_aiops_evidence_graph_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert {'kubernetes_aiops_evidence_graph_tpu_torch.rca.surge',\n"
        "        'kubernetes_aiops_evidence_graph_tpu_torch.rca.elastic',\n"
        "        'kubernetes_aiops_evidence_graph_tpu_torch.native',\n"
        "        'kubernetes_aiops_evidence_graph_tpu_torch.parallel.mesh',\n"
        "        'kubernetes_aiops_evidence_graph_tpu_torch.parallel.compat',\n"
        "        'kubernetes_aiops_evidence_graph_tpu_torch.parallel.sharded_rules',\n"
        "        'kubernetes_aiops_evidence_graph_tpu_torch.parallel.partition',\n"
        "        'kubernetes_aiops_evidence_graph_tpu_torch.parallel.sharded_gnn',\n"
        "        'kubernetes_aiops_evidence_graph_tpu_torch.parallel.sharded_streaming'} <= set(names)\n"
        "import chip_smoke\n"
        f"bad = [k for k in sys.modules if k == {JAX_PKG!r} or k.startswith({JAX_PKG + '.'!r})]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 40


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_jax_package_or_forbidden_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path}: imports {name}"
            assert top != JAX_PKG, f"{path}: imports the JAX package ({name})"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from kubernetes_aiops_evidence_graph_tpu_torch.device import resolve_device
    from kubernetes_aiops_evidence_graph_tpu_torch.graph.store import (
        EvidenceGraphStore)
    from kubernetes_aiops_evidence_graph_tpu_torch.rca import get_backend
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.cuda_backend import (
        CudaRcaBackend)
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.gnn_backend import (
        GnnRcaBackend)
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.gnn_streaming import (
        GnnStreamingScorer)
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.streaming import (
        StreamingScorer)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    with pytest.raises(RuntimeError):
        CudaRcaBackend()
    with pytest.raises(RuntimeError):
        get_backend("tpu")
    with pytest.raises(RuntimeError):
        StreamingScorer(EvidenceGraphStore())
    with pytest.raises(RuntimeError):
        GnnRcaBackend()
    with pytest.raises(RuntimeError):
        get_backend("gnn")
    with pytest.raises(RuntimeError):
        GnnStreamingScorer(EvidenceGraphStore())
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
    assert CudaRcaBackend("cpu").device.type == "cpu"
    assert get_backend("tpu", device="cpu").name == "tpu"
    assert GnnRcaBackend(device="cpu").params["embed_w"].device.type == "cpu"


def test_kernel_wrapper_takes_plain_version_only_for_cpu_tensors():
    """On any device but the CPU the wrapper launches the kernel or
    raises; it never falls back to the plain version."""
    from kubernetes_aiops_evidence_graph_tpu_torch.graph.schema import DIM
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import rules_fold as rf

    def batch(dev):
        return (torch.zeros((4, DIM), device=dev),
                torch.zeros((8, 16), dtype=torch.int32, device=dev),
                torch.zeros(8, dtype=torch.int32, device=dev),
                torch.full((8, 16), 4, dtype=torch.int32, device=dev),
                torch.zeros(8, device=dev))

    before = rf.launches
    out = rf.rules_fold(*batch("cpu"), 4)
    assert rf.launches == before, "the plain version must not count"
    assert not out[4].any() and out[5].allclose(torch.tensor(0.3))
    with pytest.raises(ValueError, match="cuda or cpu"):
        rf.rules_fold(*batch("meta"), 4)


def test_kernel_build_targets_hopper_and_keys_on_source():
    from kubernetes_aiops_evidence_graph_tpu_torch.kernels import _build
    assert "arch=compute_90a,code=sm_90a" in _build._ARCH_FLAGS
    assert set(_build.SOURCES) == {p.stem for p in (PORT / "kernels").glob("*.cu")}
    path = _build.library_path("rules_fold")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("librules_fold-")
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert "kubernetes_aiops_evidence_graph_tpu_torch/kernels/_build/" in ignored


def test_ladders_equal_the_jax_registry():
    from kubernetes_aiops_evidence_graph_tpu.analysis import ladders as jl
    from kubernetes_aiops_evidence_graph_tpu_torch import ladders as tl
    names = {n for n in dir(tl) if n.isupper()}
    assert names == {"DELTA_BUCKETS", "ROW_BUCKETS", "WIDTH_BUCKETS",
                     "PAIR_WIDTH_BUCKETS", "PACK_BUCKETS", "REL_SLICE_BUCKETS",
                     "REL_SLICE_STEP", "NODE_BUCKET_SIZES",
                     "INCIDENT_BUCKET_SIZES", "EDGE_TILE", "DMA_NODE_BLOCK"}
    for n in names:
        assert getattr(tl, n) == getattr(jl, n), n


def test_settings_hold_only_what_the_port_reads(monkeypatch):
    """Each field keeps the JAX package's name and default; an env key the
    port has no field for warns and is ignored; an unknown override raises."""
    from dataclasses import fields
    from kubernetes_aiops_evidence_graph_tpu.config import settings as js
    from kubernetes_aiops_evidence_graph_tpu_torch.config import settings as ts
    defaults = {f.name: f.default for f in fields(js.Settings)}
    for f in fields(ts.Settings):
        assert f.default == defaults[f.name], f.name
    for k in [k for k in os.environ if k.startswith("KAEG_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("KAEG_SERVE_PIPELINE_DEPTH", "4")
    monkeypatch.setenv("KAEG_INCIDENT_BUCKET_SIZES", "32,8")
    monkeypatch.setenv("KAEG_GNN_TICK_DMA", "true")
    monkeypatch.setenv("KAEG_GNN_FEATURE_QUANT", "int8")
    monkeypatch.setenv("KAEG_MESH_GRAPH", "4")
    monkeypatch.setenv("KAEG_LEARN_LR", "0.02")
    monkeypatch.setenv("KAEG_LEARN_STEPS", "7")
    monkeypatch.setenv("KAEG_LEARN_WEAK_LABELS", "false")
    with pytest.warns(UserWarning, match="KAEG_MESH_GRAPH: no such setting"):
        s = ts.load_settings()
    assert s.serve_pipeline_depth == 4 and s.incident_bucket_sizes == (8, 32)
    assert s.gnn_tick_dma is True and s.gnn_fused_tick is False
    assert s.gnn_feature_quant == "int8" and s.gnn_dma_node_block == 2048
    assert s.learn_lr == 0.02 and isinstance(s.learn_lr, float)
    assert s.learn_steps == 7 and s.learn_weak_labels is False
    assert s.learn_interval_s == 30.0 and s.learn_pallas_grads is False
    learn = {f.name for f in fields(ts.Settings) if f.name.startswith("learn_")}
    assert learn == {
        "learn_enabled", "learn_interval_s", "learn_steps", "learn_lr",
        "learn_anchor_weight", "learn_min_episodes", "learn_buffer_cap",
        "learn_sim_episodes", "learn_sim_holdout", "learn_sim_pods",
        "learn_sim_incidents", "learn_holdout_every", "learn_weak_labels",
        "learn_weak_confidence", "learn_mesh_shards", "learn_pallas_grads"}
    monkeypatch.setenv("KAEG_GNN_TICK_DMA", "0")
    monkeypatch.delenv("KAEG_MESH_GRAPH")
    assert ts.load_settings().gnn_tick_dma is False
    assert not hasattr(s, "mesh_graph")
    assert s.mesh_dp == 1 and s.rca_backend == "tpu"
    for field in ("gnn_pallas", "vmem_budget_bytes", "learn_checkpoint_dir"):
        with pytest.raises(TypeError):
            ts.load_settings(**{field: 1})


def test_promql_json_equals_the_yaml_library():
    jax_yaml = REPO / JAX_PKG / "config" / "promql_queries.yaml"
    port_json = PORT / "config" / "promql_queries.json"
    assert json.loads(port_json.read_text()) == yaml.safe_load(jax_yaml.read_text())


def _evidence_dumps(pkg: str):
    import importlib
    col = importlib.import_module(pkg + ".collectors")
    cfg = importlib.import_module(pkg + ".config")
    sim = importlib.import_module(pkg + ".simulator")
    settings = cfg.load_settings()
    cluster = sim.generate_cluster(num_pods=150, seed=5)
    rng = np.random.default_rng(5)
    keys = sorted(cluster.deployments)
    out = []
    for i, name in enumerate(sorted(sim.SCENARIOS)):
        inc = sim.inject(cluster, name, keys[(i * 7) % len(keys)], rng)
        out.append([ev.model_dump(mode="json")
                    for r in col.collect_all(
                        inc, col.default_collectors(cluster, settings),
                        parallel=False)
                    for ev in r.evidence])
    return out


def test_dataclass_models_dump_like_the_pydantic_models():
    """The port's dataclass models give the same evidence dicts, key for
    key and type for type, as the JAX package's pydantic models (ids and
    wall-clock times differ run to run, so values are compared by type)."""
    def shape(v):
        if isinstance(v, dict):
            return {k: shape(x) for k, x in v.items()}
        if isinstance(v, list):
            return [shape(x) for x in v]
        return type(v).__name__

    jax_dumps = _evidence_dumps(JAX_PKG)
    port_dumps = _evidence_dumps("kubernetes_aiops_evidence_graph_tpu_torch")
    assert sum(map(len, port_dumps)) > 20
    assert shape(port_dumps) == shape(jax_dumps)
    for a, b in zip(jax_dumps, port_dumps):
        assert [(e["evidence_type"], e["entity_name"], e["signal_strength"])
                for e in a] == [(e["evidence_type"], e["entity_name"],
                                 e["signal_strength"]) for e in b]
    # the rest of the pydantic surface the port calls: model_fields (a
    # class attribute), model_dump_json, and model_validate reading a dump
    import importlib
    jm = importlib.import_module(JAX_PKG + ".models")
    tm = importlib.import_module("kubernetes_aiops_evidence_graph_tpu_torch.models")
    for name in tm.__all__:
        if isinstance(getattr(tm, name), type) and hasattr(
                getattr(tm, name), "model_fields"):
            assert list(getattr(tm, name).model_fields) == list(
                getattr(jm, name).model_fields), name
    inc = dict(fingerprint="fp", title="t", severity="high",
               labels={"a": "b"})
    mine, ref = tm.Incident.model_validate(inc), jm.Incident(**inc)
    assert shape(json.loads(mine.model_dump_json())) == shape(
        json.loads(ref.model_dump_json()))
    assert mine.severity is tm.Severity.HIGH
    back = tm.Incident.model_validate(json.loads(mine.model_dump_json()))
    assert back == mine


def test_chip_smoke_fails_without_cuda_or_without_the_package(tmp_path):
    """chip_smoke.py exits non-zero and prints no result where there is no
    GPU (this sandbox) and where the port's package is not beside it."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (lone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0, out.stdout
        assert '"ok"' not in out.stdout
