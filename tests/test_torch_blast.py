"""The port's blast radius (``ops/propagate.py`` and ``rca/blast.py``) on
the CPU against the JAX package's on the same inputs: ``k_hop_reach``
equal (the cases of tests/test_ops.py and a seeded random graph, 1 and 4
seed rows, 0 to 3 hops), ``propagate_labels`` within 1e-6 for ``[N]`` and
``[N, D]`` scores, and ``blast_propagation`` on stores built from the same
seeded cluster: the same blast ids in the same order, scores within 1e-6,
the same ``reached_nodes``, and ``None`` for an unknown incident."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu.ops import propagate as jprop
from kubernetes_aiops_evidence_graph_tpu_torch.ops import propagate as tprop
from tests.test_torch_streaming import JAX_PKG, PORT_PKG, SMALL, _world

# one intra-op thread: these tensors are small, and the suite runs
# several pytest workers side by side on the host's cores
torch.set_num_threads(1)


def _chain_edges():
    # 0 -> 1 -> 2 -> 3 (undirected duplicated), plus isolated node 4
    src = np.array([0, 1, 1, 2, 2, 3, 0, 0], dtype=np.int32)
    dst = np.array([1, 0, 2, 1, 3, 2, 0, 0], dtype=np.int32)
    mask = np.array([1, 1, 1, 1, 1, 1, 0, 0], dtype=np.float32)  # 2 padded
    return src, dst, mask, 5


def _random_edges(seed=0, n=64, e=300):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    mask = (rng.random(e) < 0.8).astype(np.float32)
    return src, dst, mask, n


GRAPHS = {"chain": _chain_edges, "random": _random_edges}


def _both(fn_j, fn_t, arrays, **kw):
    want = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays), **kw))
    got = fn_t(*(torch.from_numpy(a) for a in arrays), **kw).numpy()
    return got, want


def test_k_hop_reach_depth_semantics_match_jax():
    """The cases of tests/test_ops.py: row 1 is a padded seed."""
    src, dst, mask, n = _chain_edges()
    seeds = (np.array([0, 3], np.int32), np.array([1.0, 0.0], np.float32))
    for hops, row0 in ((1, [1, 1, 0, 0, 0]), (3, [1, 1, 1, 1, 0])):
        got, want = _both(jprop.k_hop_reach, tprop.k_hop_reach,
                          (*seeds, src, dst, mask), num_nodes=n, hops=hops)
        assert got.dtype == np.float32 and np.array_equal(got, want)
        assert got[0].tolist() == row0 and got[1].sum() == 0


@pytest.mark.parametrize("hops", [0, 1, 2, 3])
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_k_hop_reach_equals_jax(graph, batch, hops):
    src, dst, mask, n = GRAPHS[graph]()
    rng = np.random.default_rng(batch * 10 + hops)
    seeds = rng.integers(0, n, batch).astype(np.int32)
    seed_mask = np.ones(batch, np.float32)
    seed_mask[1:2] = 0.0                    # a padded row when batch > 1
    got, want = _both(jprop.k_hop_reach, tprop.k_hop_reach,
                      (seeds, seed_mask, src, dst, mask), num_nodes=n,
                      hops=hops)
    assert got.shape == (batch, n) and np.array_equal(got, want)


@pytest.mark.parametrize("width", [None, 3], ids=["N", "N,D"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_propagate_labels_equals_jax(graph, width):
    src, dst, mask, n = GRAPHS[graph]()
    rng = np.random.default_rng(7)
    shape = (n,) if width is None else (n, width)
    x = rng.random(shape).astype(np.float32)
    for iterations, alpha in ((3, 0.5), (5, 0.3)):
        got, want = _both(jprop.propagate_labels, tprop.propagate_labels,
                          (x, src, dst, mask), num_nodes=n,
                          iterations=iterations, alpha=alpha)
        assert got.shape == shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        again = tprop.propagate_labels(
            *(torch.from_numpy(a) for a in (x, src, dst, mask)),
            num_nodes=n, iterations=iterations, alpha=alpha).numpy()
        assert np.array_equal(got, again)


def test_propagate_labels_conserves_and_spreads():
    src, dst, mask, n = _chain_edges()
    x = torch.tensor([1.0, 0.0, 0.0, 0.0, 0.0])
    out = tprop.propagate_labels(x, *(torch.from_numpy(a)
                                      for a in (src, dst, mask)),
                                 num_nodes=n, iterations=3).numpy()
    assert out[1] > out[2] > out[3] >= 0   # decays with distance
    assert out[4] == 0.0                   # isolated node untouched
    assert out[0] > 0.1                    # source retains mass


@pytest.fixture(scope="module")
def stores():
    """The same seeded world (incidents with fixed UUIDs, so node ids and
    the snapshot's order agree) built through each package."""
    out = {}
    for pkg in (JAX_PKG, PORT_PKG):
        cfg = importlib.import_module(pkg + ".config").load_settings(**SMALL)
        _cluster, builder, incidents = _world(pkg, cfg)
        out[pkg] = (builder.store, cfg, incidents)
    return out


@pytest.mark.parametrize("hops,iterations,top_k", [(1, 3, 25), (3, 3, 25),
                                                   (2, 5, 10), (3, 1, 400)])
def test_blast_propagation_equals_jax(stores, hops, iterations, top_k):
    jblast = importlib.import_module(JAX_PKG + ".rca.blast")
    tblast = importlib.import_module(PORT_PKG + ".rca.blast")
    for j_inc, t_inc in zip(stores[JAX_PKG][2], stores[PORT_PKG][2]):
        assert j_inc.id == t_inc.id
        kw = dict(hops=hops, iterations=iterations, top_k=top_k)
        want = jblast.blast_propagation(stores[JAX_PKG][0], str(j_inc.id),
                                        settings=stores[JAX_PKG][1], **kw)
        got = tblast.blast_propagation(stores[PORT_PKG][0], str(t_inc.id),
                                       settings=stores[PORT_PKG][1],
                                       device="cpu", **kw)
        assert got.keys() == want.keys()
        for k in ("incident", "hops", "iterations", "reached_nodes"):
            assert got[k] == want[k], k
        assert got["reached_nodes"] > 0 and got["blast"]
        assert [(b["id"], b["type"]) for b in got["blast"]] == [
            (b["id"], b["type"]) for b in want["blast"]]
        np.testing.assert_allclose([b["score"] for b in got["blast"]],
                                   [b["score"] for b in want["blast"]],
                                   rtol=0, atol=1e-6)
    unknown = "00000000-0000-0000-0000-000000000bad"
    assert tblast.blast_propagation(stores[PORT_PKG][0], unknown,
                                    settings=stores[PORT_PKG][1],
                                    device="cpu") is None
    assert jblast.blast_propagation(stores[JAX_PKG][0], unknown,
                                    settings=stores[JAX_PKG][1]) is None


def test_blast_snapshot_cache_follows_the_store_version(stores):
    from kubernetes_aiops_evidence_graph_tpu_torch.rca import blast
    store, cfg, incidents = stores[PORT_PKG]
    blast.blast_propagation(store, str(incidents[0].id), settings=cfg,
                            device="cpu")
    snap = blast._CACHE[store][2]
    blast.blast_propagation(store, str(incidents[1].id), settings=cfg,
                            device="cpu")
    assert blast._CACHE[store][2] is snap          # unchanged graph: a hit
    assert store.touch_nodes([f"incident:{incidents[0].id}"]) == 1
    blast.blast_propagation(store, str(incidents[0].id), settings=cfg,
                            device="cpu")
    assert blast._CACHE[store][2] is not snap      # a new version rebuilds
