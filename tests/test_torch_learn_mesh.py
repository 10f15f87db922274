"""The data-parallel fine-tune (``learn/trainer.finetune(mesh_shards > 1)``:
the sharded train step over partitioned episodes on a ``(1 x shards)``
mesh of repeated ``cpu`` positions) against the JAX package's on its
8-device virtual mesh, at ``tests/test_learn.py:346``'s sizes; its logged
single-device fallback when the pool cannot carry the mesh; its refusal
when no episode partitions; and one online-learning cycle on the mesh."""
import numpy as np
import pytest
import torch
import jax

from kubernetes_aiops_evidence_graph_tpu.learn import trainer as jtrainer
from kubernetes_aiops_evidence_graph_tpu.rca import gnn as jgnn
from kubernetes_aiops_evidence_graph_tpu.rca import train as jtrain
from kubernetes_aiops_evidence_graph_tpu_torch.learn import trainer as ttrainer
from kubernetes_aiops_evidence_graph_tpu_torch.parallel import mesh as pmesh
from kubernetes_aiops_evidence_graph_tpu_torch.rca import gnn as tgnn
from kubernetes_aiops_evidence_graph_tpu_torch.rca import train as ttrain
from kubernetes_aiops_evidence_graph_tpu_torch.rca.gnn_backend import (
    SHIPPED_CHECKPOINT, load_validated_checkpoint)
from tests.test_torch_learn import (
    _assert_params_close, _flat_np, _learner, _port_params)
from tests.test_torch_streaming import JAX_PKG, PORT_PKG

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def host_pool(monkeypatch):
    monkeypatch.setattr(pmesh, "_HOST_POOL",
                        {"devices": 8, "committed": False})


@pytest.fixture(scope="module")
def params():
    return load_validated_checkpoint(SHIPPED_CHECKPOINT)


@pytest.fixture(scope="module")
def episodes():
    kw = dict(seed=7, return_snapshot=True)
    return (ttrain.make_dataset(2, 96, 4, **kw),
            jtrain.make_dataset(2, 96, 4, **kw))


def test_sharded_finetune_drives_data_mesh_like_jax(params, episodes):
    """``mesh_shards=2``: six ring steps on the (1 x 2) mesh, ``sharded``
    True, finite, moved off the serving tree (which stays untouched); the
    final loss within 1e-4 and the candidate within 1e-3 of the JAX
    package's sharded fine-tune."""
    eps, jeps = episodes
    serving = tgnn.params_from_numpy(params, device="cpu")
    before = _flat_np(serving)
    out = ttrainer.finetune(serving, eps[:1], eps[1:], steps=6, lr=1e-3,
                            anchor_weight=1e-3, mesh_shards=2)
    ref = jtrainer.finetune(params, jeps[:1], jeps[1:], steps=6, lr=1e-3,
                            anchor_weight=1e-3, mesh_shards=2)
    assert out.keys() == ref.keys() == {"params", "steps", "final_loss",
                                        "sharded"}
    assert out["sharded"] is ref["sharded"] is True
    assert out["steps"] == ref["steps"] == 6
    assert ttrainer.params_finite(out["params"])
    after = _flat_np(out["params"])
    assert any(not np.array_equal(after[k], before[k]) for k in before)
    for k, v in _flat_np(serving).items():
        assert np.array_equal(v, before[k]), k
    np.testing.assert_allclose(out["final_loss"], ref["final_loss"],
                               rtol=1e-4, atol=1e-4)
    _assert_params_close(out["params"], ref["params"], 1e-3)


def test_learn_mesh_unavailable_falls_back_to_one_device(params, episodes,
                                                         monkeypatch,
                                                         caplog):
    """A pool committed at one position cannot carry the learn mesh:
    logged ``learn_mesh_unavailable``, and the single-device tier runs
    with the bits of ``mesh_shards=1``."""
    monkeypatch.setattr(pmesh, "_HOST_POOL",
                        {"devices": 1, "committed": True})
    eps, _ = episodes
    serving = tgnn.params_from_numpy(params, device="cpu")
    with caplog.at_level("WARNING"):
        out = ttrainer.finetune(serving, eps[:1], eps[1:], steps=3,
                                lr=1e-3, anchor_weight=1e-3, mesh_shards=2)
    assert "learn_mesh_unavailable" in caplog.text
    one = ttrainer.finetune(serving, eps[:1], eps[1:], steps=3, lr=1e-3,
                            anchor_weight=1e-3)
    assert out["sharded"] is False and out["steps"] == 3
    a, b = _flat_np(out["params"]), _flat_np(one["params"])
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_no_partitionable_episode_raises(params, episodes):
    """Episodes without a snapshot, or whose padded nodes do not divide
    over the mesh, are skipped; with none left the fine-tune refuses."""
    eps, _ = episodes
    serving = tgnn.params_from_numpy(params, device="cpu")
    bare = [{k: v for k, v in ep.items() if k != "snapshot"} for ep in eps]
    with pytest.raises(ValueError, match="partitionable"):
        ttrainer.finetune(serving, bare[:1], bare[1:], steps=2, lr=1e-3,
                          anchor_weight=1e-3, mesh_shards=2)
    with pytest.raises(ValueError, match="partitionable"):
        ttrainer.finetune(serving, eps[:1], eps[1:], steps=2, lr=1e-3,
                          anchor_weight=1e-3, mesh_shards=3)


def test_online_learner_cycle_on_the_learn_mesh_like_jax(monkeypatch):
    """One ``run_once()`` with ``learn_mesh_shards=2`` in both packages:
    the port's candidate comes from the sharded tier; the same steps, gate
    verdict and swap, the final loss within 1e-3."""
    seen = []
    real = ttrainer._finetune_sharded

    def spy(*a, **k):
        out = real(*a, **k)
        seen.append(out)
        return out
    monkeypatch.setattr(ttrainer, "_finetune_sharded", spy)
    weak = jgnn.init_params(jax.random.PRNGKey(123))
    outs = {}
    for pkg in (JAX_PKG, PORT_PKG):
        learner, _, _ = _learner(
            pkg, 41, weak if pkg == JAX_PKG else _port_params(weak),
            learn_mesh_shards=2, learn_steps=8)
        outs[pkg] = learner.run_once()
    mine, ref = outs[PORT_PKG], outs[JAX_PKG]
    assert len(seen) == 1 and seen[0]["sharded"] is True
    assert seen[0]["steps"] == mine["train_steps"]
    for k in ("harvested", "trained", "swapped", "train_steps"):
        assert mine[k] == ref[k], k
    assert mine["gate"]["finite"] and ref["gate"]["finite"]
    for k in ("candidate_top1", "serving_top1", "holdout_episodes"):
        assert mine["gate"][k] == ref["gate"][k], k
    np.testing.assert_allclose(mine["final_loss"], ref["final_loss"],
                               rtol=1e-3, atol=1e-3)
