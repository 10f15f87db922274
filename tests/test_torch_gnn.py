"""The port's learned RCA model and snapshot backend against the JAX
package's: ``gnn.forward`` on the same snapshot and params (bucketed and
reference mappings; a narrow width from numpy seeds and the shipped
checkpoint at full width), the shipped ``gnn.npz`` leaf for leaf against
the orbax checkpoint it was converted from, ``GnnRcaBackend`` against the
JAX backend, and every ``CheckpointError``.

The shipped weights were written by :func:`write_npz_checkpoint`; rewrite
them from the repository root with

    JAX_PLATFORMS=cpu python -c "from tests.test_torch_gnn import \\
write_npz_checkpoint; write_npz_checkpoint()"
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kubernetes_aiops_evidence_graph_tpu.rca import gnn as jgnn
from kubernetes_aiops_evidence_graph_tpu.rca.gnn_backend import (
    GnnRcaBackend as JaxGnnBackend, _shipped_checkpoint,
    load_validated_checkpoint as jax_load_checkpoint)
from kubernetes_aiops_evidence_graph_tpu.simulator import SCENARIOS
from kubernetes_aiops_evidence_graph_tpu_torch.config import load_settings
from kubernetes_aiops_evidence_graph_tpu_torch.graph.snapshot import (
    snapshot_from_numpy)
from kubernetes_aiops_evidence_graph_tpu_torch.rca import get_backend
from kubernetes_aiops_evidence_graph_tpu_torch.rca import gnn as tgnn
from kubernetes_aiops_evidence_graph_tpu_torch.rca.gnn_backend import (
    CheckpointError, GnnRcaBackend, SHIPPED_CHECKPOINT,
    load_validated_checkpoint)
from tests.test_torch_backend import JAX_PKG, PORT_PKG, run_pipeline

# one intra-op thread: these tensors are small, and the suite runs
# several pytest workers side by side on the host's cores
torch.set_num_threads(1)


def write_npz_checkpoint(out=SHIPPED_CHECKPOINT, src=None) -> None:
    """The one-off converter: the JAX package's orbax checkpoint (read
    through its own ``load_validated_checkpoint``) → a flat-key ``.npz``
    the port reads with numpy alone."""
    params = jax_load_checkpoint(src or _shipped_checkpoint())
    np.savez(out, **{k: np.asarray(v, np.float32)
                     for k, v in tgnn.flat_params(params).items()})


@pytest.fixture(scope="module")
def shipped():
    return load_validated_checkpoint(SHIPPED_CHECKPOINT)


@pytest.fixture(scope="module")
def world():
    """All scenarios on one 300-pod cluster: the JAX package's snapshot,
    and the port's own snapshot of the same seed."""
    names = sorted(SCENARIOS)
    _, _, jsnap = run_pipeline(JAX_PKG, names, num_pods=300, seed=5)
    _, _, psnap = run_pipeline(PORT_PKG, names, num_pods=300, seed=5)
    return jsnap, psnap


def numpy_params(seed, hidden, layers):
    """Random params with the model's shapes, from a numpy seed."""
    rng = np.random.default_rng(seed)
    shapes = {"embed_w": (48, hidden), "embed_b": (hidden,),
              "kind_emb": (tgnn.NUM_KINDS, hidden),
              "head_w": (hidden, tgnn.NUM_CLASSES),
              "head_b": (tgnn.NUM_CLASSES,)}
    flat = {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
            for k, s in shapes.items()}
    for i in range(layers):
        flat[f"layers.{i}.w_self"] = (rng.standard_normal((hidden, hidden))
                                      * 0.2).astype(np.float32)
        flat[f"layers.{i}.w_rel"] = (rng.standard_normal(
            (tgnn.NUM_RELS, hidden, hidden)) * 0.2).astype(np.float32)
        flat[f"layers.{i}.b"] = (rng.standard_normal(hidden)
                                 * 0.1).astype(np.float32)
    return tgnn.unflat_params(flat)


def _logits_both(params, jsnap, psnap, bucketed=True, compute_dtype=None):
    jl = np.asarray(jgnn.forward_batch(
        jax.tree_util.tree_map(jnp.asarray, params), jgnn.snapshot_batch(jsnap),
        bucketed=bucketed, compute_dtype=compute_dtype))
    tp = tgnn.params_from_numpy(params, device="cpu")
    batch = tgnn.snapshot_batch(psnap)
    if bucketed:
        tl = tgnn.forward_batch(tp, batch, compute_dtype=compute_dtype)
    else:
        tl = tgnn.forward(tp, *[torch.as_tensor(batch[k])
                                for k in tgnn._BATCH_ARRAYS])
    return jl, tl.numpy()


@pytest.mark.parametrize("bucketed", [True, False],
                         ids=["bucketed", "reference"])
@pytest.mark.parametrize("width", ["narrow_h16_l2", "shipped_h64_l3"])
def test_forward_equals_jax_forward(world, shipped, bucketed, width):
    """Logits within 1e-5 (rtol and atol) of the JAX forward on the same
    snapshot; the same argmax on every incident."""
    jsnap, psnap = world
    params = numpy_params(1, 16, 2) if width.startswith("narrow") else shipped
    jl, tl = _logits_both(params, jsnap, psnap, bucketed=bucketed)
    n = psnap.num_incidents
    assert tl.shape == jl.shape == (psnap.padded_incidents, tgnn.NUM_CLASSES)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tl[:n].argmax(-1), jl[:n].argmax(-1))


def test_bf16_forward_within_tolerance(world, shipped):
    jsnap, psnap = world
    jl, tl = _logits_both(shipped, jsnap, psnap, compute_dtype="bfloat16")
    np.testing.assert_allclose(tl, jl, rtol=0.05, atol=0.05)
    _, f32 = _logits_both(shipped, jsnap, psnap)
    np.testing.assert_allclose(tl, f32, rtol=0.05, atol=0.05)


def test_shipped_npz_equals_orbax_leaves(shipped, tmp_path):
    """Every leaf of the shipped .npz is bit-equal to the orbax leaf, the
    converter reproduces it, and the tree has the full model's widths."""
    orbax = tgnn.flat_params(jax_load_checkpoint(_shipped_checkpoint()))
    mine = tgnn.flat_params(shipped)
    assert mine.keys() == orbax.keys()
    for k in orbax:
        a, b = np.asarray(mine[k]), np.asarray(orbax[k])
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    out = tmp_path / "gnn.npz"
    write_npz_checkpoint(out)
    again = tgnn.flat_params(load_validated_checkpoint(out))
    assert all(np.array_equal(again[k], mine[k]) for k in mine)
    assert mine["embed_w"].shape == (48, 64)
    assert mine["kind_emb"].shape == (11, 64)
    assert mine["head_w"].shape == (64, 11)
    assert len(shipped["layers"]) == 3
    assert shipped["layers"][0]["w_rel"].shape == (9, 64, 64)


def test_params_from_numpy_and_init_params():
    params = numpy_params(2, 8, 2)
    t = tgnn.params_from_numpy(params, device="cpu")
    assert set(t) == set(params) and len(t["layers"]) == 2
    for k, v in tgnn.flat_params(t).items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), tgnn.flat_params(params)[k])
    # the tensors are copies: the numpy tree stays untouched
    t["embed_w"].zero_()
    assert params["embed_w"].any()
    again = tgnn.params_from_numpy(t, device="cpu")
    assert again["embed_w"] is not t["embed_w"]
    init = tgnn.init_params(torch.Generator().manual_seed(0), hidden=32,
                            layers=2)
    jinit = jgnn.init_params(jax.random.PRNGKey(0), hidden=32, layers=2)
    shapes = {k: tuple(v.shape) for k, v in tgnn.flat_params(init).items()}
    assert shapes == {k: tuple(v.shape)
                      for k, v in tgnn.flat_params(jinit).items()}
    assert tgnn.unflat_params(tgnn.flat_params(init)).keys() == init.keys()


def test_backend_equals_jax_backend(world, shipped):
    """Same raw keys, probs within 1e-5, same top-1, and results() gives
    the same rule ids with the GNN's attribution."""
    jsnap, psnap = world
    ref = JaxGnnBackend(params=jax.tree_util.tree_map(
        jnp.asarray, jax_load_checkpoint(_shipped_checkpoint()))
    ).score_snapshot(jsnap)
    backend = get_backend("gnn", device="cpu")
    assert backend.name == "gnn"
    for snap in (psnap, snapshot_from_numpy(dataclasses.asdict(jsnap))):
        raw = backend.score_snapshot(snap)
        assert raw.keys() == ref.keys()
        # incident ids are uuids minted per world; the rows line up
        assert len(raw["incident_ids"]) == len(ref["incident_ids"])
        np.testing.assert_allclose(raw["probs"], ref["probs"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(raw["top_confidence"],
                                   ref["top_confidence"], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(raw["top_rule_index"],
                                      ref["top_rule_index"])
        np.testing.assert_array_equal(raw["any_match"], ref["any_match"])
    assert raw["incident_ids"] == ref["incident_ids"]
    results = backend.results(raw=raw)
    jres = JaxGnnBackend(params=shipped).results(jsnap, raw=ref)
    assert [[h.rule_id for h in r.hypotheses] for r in results] == \
        [[h.rule_id for h in r.hypotheses] for r in jres]
    for r in results:
        assert r.backend == "gnn" and r.top_hypothesis.backend == "gnn"
        assert r.top_hypothesis.generated_by.value == "gnn"
    assert len(backend.results(psnap)) == psnap.num_incidents
    with pytest.raises(ValueError):
        backend.results()


def _save(path, flat):
    np.savez(path, **flat)
    return path


def test_checkpoint_errors(tmp_path, shipped):
    orbax_dir = tmp_path / "orbax"
    orbax_dir.mkdir()
    with pytest.raises(CheckpointError, match="directory"):
        load_validated_checkpoint(orbax_dir)
    with pytest.raises(CheckpointError, match="unreadable"):
        load_validated_checkpoint(tmp_path / "missing.npz")
    corrupt = tmp_path / "corrupt.npz"
    corrupt.write_bytes(b"not a zip archive")
    with pytest.raises(CheckpointError, match="unreadable"):
        load_validated_checkpoint(corrupt)
    flat = {k: np.asarray(v) for k, v in tgnn.flat_params(shipped).items()}
    no_embed = {k: v for k, v in flat.items() if k != "embed_w"}
    with pytest.raises(CheckpointError, match="embed_w"):
        load_validated_checkpoint(_save(tmp_path / "no_embed.npz", no_embed))
    legacy = {(k.replace("w_rel", "w_msg")): v for k, v in flat.items()}
    with pytest.raises(CheckpointError, match="w_msg"):
        load_validated_checkpoint(_save(tmp_path / "legacy.npz", legacy))
    # settings.gnn_checkpoint naming an orbax directory raises at once
    with pytest.raises(CheckpointError, match="directory"):
        GnnRcaBackend(settings=load_settings(gnn_checkpoint=str(orbax_dir)),
                      device="cpu")
    assert issubclass(CheckpointError, ValueError)
