"""The port's sharded GNN loss and train step (``parallel/sharded_gnn.py``
on a mesh of repeated ``cpu`` positions, the message pass's plain version)
against the JAX package's on its 8-device virtual mesh, on
``tests/test_parallel.py``'s contracts: the loss within 1e-5 of JAX's and
1e-4 of the single-device loss, for both halos and both relation
mappings, at (dp, graph) ∈ {(1, 2), (2, 2), (1, 4)}; ring against
all-gather (loss within 1e-5, grads within rtol 1e-4 / atol 1e-5); grads
against JAX's; a decreasing loss; two runs bit-equal."""
import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

from kubernetes_aiops_evidence_graph_tpu.parallel import (
    device_put_partitioned as jput, make_mesh as jmake_mesh,
    make_sharded_train_step as jmake_step, partition_snapshot as jpartition)
from kubernetes_aiops_evidence_graph_tpu.parallel.sharded_gnn import (
    _sharded_loss as jsharded_loss)
from kubernetes_aiops_evidence_graph_tpu.rca import gnn as jgnn
from kubernetes_aiops_evidence_graph_tpu.rca import train as jtrain
from kubernetes_aiops_evidence_graph_tpu_torch.parallel import compat
from kubernetes_aiops_evidence_graph_tpu_torch.parallel.mesh import make_mesh
from kubernetes_aiops_evidence_graph_tpu_torch.parallel.partition import (
    partition_snapshot)
from kubernetes_aiops_evidence_graph_tpu_torch.parallel.sharded_gnn import (
    _reference_agg, _sharded_loss, device_put_partitioned,
    make_sharded_train_step)
from kubernetes_aiops_evidence_graph_tpu_torch.rca import gnn as tgnn
from kubernetes_aiops_evidence_graph_tpu_torch.rca import train as ttrain

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def episode():
    """A seeded labeled episode with its snapshot, from each package."""
    kw = dict(num_incidents=8, seed=3, return_snapshot=True)
    return (ttrain.make_dataset(1, 200, **kw)[0],
            jtrain.make_dataset(1, 200, **kw)[0])


def _params(seed):
    jp = jgnn.init_params(jax.random.PRNGKey(seed), hidden=32, layers=2)
    return jp, tgnn.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")


def _meshes(episode, dp, graph):
    """(port mesh, its arrays, rel_offsets, JAX mesh, its arrays)."""
    mine, ref = episode
    part = partition_snapshot(mine["snapshot"], dp, graph,
                              labels=mine["labels"])
    jpart = jpartition(ref["snapshot"], dp, graph, labels=ref["labels"])
    mesh = make_mesh(dp, graph, ["cpu"] * (dp * graph))
    jmesh = jmake_mesh(dp=dp, graph=graph,
                       devices=jax.devices()[:dp * graph])
    return (mesh, device_put_partitioned(part, mesh), part.rel_offsets,
            jmesh, jput(jpart, jmesh))


def _single_loss(params, ep, offs):
    b = tgnn.batch_to(ep, "cpu")
    return float(tgnn.loss_fn(params, *(b[k] for k in tgnn.TRAIN_ARRAYS),
                              rel_offsets=offs))


def _port_grads(mesh, arrays, params, halo, offs):
    p = tgnn.trainable(params)
    loss = _sharded_loss(mesh, halo, offs)(p, *arrays)
    grads = torch.autograd.grad(loss, tgnn.leaves(p))
    return float(loss.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("dp,graph", [(1, 2), (2, 2), (1, 4)])
def test_sharded_loss_equals_jax_and_single_device(episode, dp, graph):
    """Both halos × both relation mappings: the loss within 1e-5 of the
    JAX sharded loss and 1e-4 of the port's single-device loss."""
    jp, tp = _params(7)
    mesh, arrays, offs, jmesh, jarrays = _meshes(episode, dp, graph)
    for mapping in (None, offs):
        single = _single_loss(tp, episode[0],
                              None if mapping is None
                              else tuple(episode[0]["rel_offsets"]))
        for halo in ("allgather", "ring"):
            mine = float(_sharded_loss(mesh, halo, mapping)(tp, *arrays))
            ref = float(np.asarray(jax.jit(jsharded_loss(
                jmesh, halo=halo, rel_offsets=mapping,
                slices_sorted=mapping is not None))(jp, *jarrays)).mean())
            assert abs(mine - ref) < 1e-5, (halo, mapping, mine, ref)
            assert abs(mine - single) < 1e-4, (halo, mapping, mine, single)


@pytest.mark.parametrize("dp,graph", [(2, 2), (1, 4)])
def test_ring_matches_allgather_loss_and_grads(episode, dp, graph):
    """The ring halo against the all-gather one, for both mappings: loss
    within 1e-5, every grad within rtol 1e-4 / atol 1e-5; the ring moves
    G blocks a layer plus G for the readout, the all-gather none."""
    _, tp = _params(4)
    mesh, arrays, offs, _, _ = _meshes(episode, dp, graph)
    for mapping in (None, offs):
        hops = compat.ring_hops
        l_ring, g_ring = _port_grads(mesh, arrays, tp, "ring", mapping)
        assert compat.ring_hops - hops == (len(tp["layers"]) + 1) * graph
        hops = compat.ring_hops
        l_ag, g_ag = _port_grads(mesh, arrays, tp, "allgather", mapping)
        assert compat.ring_hops == hops
        assert abs(l_ring - l_ag) < 1e-5
        for a, b in zip(g_ring, g_ag):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("halo", ["allgather", "ring"])
def test_grads_equal_jax(episode, halo):
    """The bucketed sharded loss's grads at (2, 2) against
    ``jax.value_and_grad`` of the JAX package's, leaf for leaf."""
    jp, tp = _params(11)
    mesh, arrays, offs, jmesh, jarrays = _meshes(episode, 2, 2)
    loss, grads = _port_grads(mesh, arrays, tp, halo, offs)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jsharded_loss(
        jmesh, halo=halo, rel_offsets=offs, slices_sorted=True)(
            p, *jarrays).mean()))(jp)
    assert abs(loss - float(jl)) < 1e-5
    names = list(tgnn.flat_params(tp))
    ref = tgnn.flat_params(jax.tree_util.tree_map(np.asarray, jg))
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g, ref[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_bucketed_ring_step_decreases_loss_like_jax(episode):
    """Six bucketed ring steps with Adam (``gnn.adam`` against
    ``optax.adam``): finite, decreasing, each step's loss within 1e-4 of
    the JAX step's; the serving tree is never touched."""
    jp, tp = _params(8)
    before = {k: v.clone() for k, v in tgnn.flat_params(tp).items()}
    mesh, arrays, offs, jmesh, jarrays = _meshes(episode, 2, 2)
    step = make_sharded_train_step(mesh, tgnn.adam(3e-3), halo="ring",
                                   rel_offsets=offs)
    tx = optax.adam(3e-3)
    jstep = jmake_step(jmesh, tx, halo="ring", rel_offsets=offs,
                       slices_sorted=True)
    params, opt = tp, None
    jparams = jax.tree_util.tree_map(jnp.array, jp)
    jopt = tx.init(jparams)
    losses, jlosses = [], []
    for _ in range(6):
        params, opt, loss = step(params, opt, *arrays)
        jparams, jopt, jl = jstep(jparams, jopt, *jarrays)
        losses.append(float(loss))
        jlosses.append(float(jl))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-4)
    for k, v in tgnn.flat_params(tp).items():
        assert torch.equal(v, before[k]), k


def test_two_runs_of_the_step_are_bit_equal(episode):
    """The same params and partition give the same bits twice."""
    _, tp = _params(5)
    mesh, arrays, offs, _, _ = _meshes(episode, 1, 4)

    def run():
        step = make_sharded_train_step(mesh, tgnn.adam(1e-3), halo="ring",
                                       rel_offsets=offs)
        params, opt = tp, None
        for _ in range(2):
            params, opt, loss = step(params, opt, *arrays)
        return {k: v.detach().numpy().copy()
                for k, v in tgnn.flat_params(params).items()}, float(loss)

    (a, la), (b, lb) = run(), run()
    assert la == lb
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_reference_mapping_runs_on_the_cpu_only():
    """The reference mapping's ``index_add_`` never reaches a device
    tensor; an unknown halo is refused."""
    h = torch.zeros((4, 8), device="meta")
    w = torch.zeros((tgnn.NUM_RELS, 8, 8), device="meta")
    idx = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU only"):
        _reference_agg(h, w, idx, idx, torch.zeros(3, device="meta"), idx, 4)
    with pytest.raises(ValueError, match="allgather\\|ring"):
        _sharded_loss(make_mesh(1, 2, ["cpu"] * 2), halo="tree")
