"""Offline training of the learned RCA model in the port (``rca/gnn.py``'s
``loss_fn`` and ``make_train_step``, ``rca/train.py``) against the JAX
package, on the CPU at a small size: the same seeded episodes, the same
initial params, the same optimizer; and the ``.npz`` checkpoint."""
import json

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

from kubernetes_aiops_evidence_graph_tpu.rca import gnn as jgnn
from kubernetes_aiops_evidence_graph_tpu.rca import train as jtrain
from kubernetes_aiops_evidence_graph_tpu_torch.rca import gnn as tgnn
from kubernetes_aiops_evidence_graph_tpu_torch.rca import train as ttrain
from kubernetes_aiops_evidence_graph_tpu_torch.rca.gnn_backend import (
    load_validated_checkpoint)

torch.set_num_threads(1)

ARRAYS = tgnn.TRAIN_ARRAYS


def _jax_params(seed=0, hidden=16, layers=2):
    return jgnn.init_params(jax.random.PRNGKey(seed), hidden=hidden,
                            layers=layers)


def _port(params):
    return tgnn.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                  device="cpu")


def _flat_np(params):
    """Flat dotted keys → numpy, for either package's params tree."""
    if isinstance(params["embed_w"], torch.Tensor):
        return {k: v.detach().numpy() for k, v in
                tgnn.flat_params(params).items()}
    return {k: np.asarray(v) for k, v in tgnn.flat_params(params).items()}


def _assert_params_close(mine, ref, tol):
    a, b = _flat_np(mine), _flat_np(ref)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=tol, atol=tol, err_msg=k)


@pytest.fixture(scope="module")
def episodes():
    """Three seeded small episodes (the JAX package's arrays; the port
    makes the same, see test_episodes_equal_the_jax_package)."""
    return jtrain.make_dataset(3, [96, 128], num_incidents=4, seed=5)


def _jax_batch(ep):
    return {k: jnp.asarray(ep[k]) for k in ARRAYS}


@pytest.mark.parametrize("seed", [0, 11])
def test_episodes_equal_the_jax_package(seed):
    """make_episode / make_dataset (churn, unknowns, dense): every array
    and the relation layout equal the JAX package's exactly."""
    cases = [dict(), dict(churn=12, unknowns=1), dict(dense=True)]
    for kw in cases:
        a = jtrain.make_dataset(2, [96, 128], num_incidents=4, seed=seed, **kw)
        b = ttrain.make_dataset(2, [96, 128], num_incidents=4, seed=seed, **kw)
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            assert tuple(x["rel_offsets"]) == tuple(y["rel_offsets"])
            for k in ARRAYS:
                assert np.array_equal(np.asarray(x[k]), np.asarray(y[k])), \
                    (kw, k)


@pytest.mark.parametrize("pallas", [False, True])
def test_loss_fn_value_and_grads_equal_jax(episodes, pallas):
    """loss_fn and torch's autograd of it against
    ``jax.value_and_grad(gnn.loss_fn)`` through the XLA message pass and
    through the Pallas kernel's custom_vjp (interpret mode), rtol/atol
    1e-4, at the shipped depth and width."""
    jp = _jax_params(1, hidden=64, layers=3)
    for ep in episodes:
        offs = tuple(ep["rel_offsets"])
        jl, jg = jax.value_and_grad(jgnn.loss_fn)(
            jp, *(_jax_batch(ep)[k] for k in ARRAYS), rel_offsets=offs,
            pallas=pallas)
        tp = tgnn.trainable(_port(jp))
        b = tgnn.batch_to(ep, "cpu")
        loss = tgnn.loss_fn(tp, *(b[k] for k in ARRAYS), rel_offsets=offs)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4,
                                   atol=1e-4)
        grads = {k: v.grad for k, v in tgnn.flat_params(tp).items()}
        _assert_params_close(grads, jg, 1e-4)


def test_loss_fn_masks_rows_and_divides_by_at_least_one(episodes):
    ep = dict(episodes[0])
    tp = _port(_jax_params())
    b = tgnn.batch_to(ep, "cpu")
    args = [b[k] for k in ARRAYS]
    args[-1] = torch.zeros_like(args[-1])
    assert float(tgnn.loss_fn(tp, *args, rel_offsets=tuple(
        ep["rel_offsets"]))) == 0.0


@pytest.mark.parametrize("opt", ["adam", "adamw"])
def test_train_steps_equal_jax_make_train_step(episodes, opt):
    """Three steps of make_train_step from the same params against the
    JAX package's make_train_step(optax.adam / optax.adamw): losses and
    params within 1e-4."""
    lr, wd = 3e-3, 1e-2
    jp = _jax_params(2)
    tx = optax.adamw(lr, weight_decay=wd) if opt == "adamw" \
        else optax.adam(lr)
    jstep = jgnn.make_train_step(tx)
    jstate = tx.init(jp)
    factory = tgnn.adamw(lr, wd) if opt == "adamw" else tgnn.adam(lr)
    tstep = tgnn.make_train_step(factory)
    tp, tstate = _port(jp), None
    jp = jax.tree_util.tree_map(jnp.array, jp)
    for ep in episodes:
        offs = tuple(ep["rel_offsets"])
        jp, jstate, jl = jstep(jp, jstate, _jax_batch(ep), rel_offsets=offs,
                               slices_sorted=True)
        tp, tstate, tl = tstep(tp, tstate, ep, rel_offsets=offs)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4, atol=1e-4)
    _assert_params_close(tp, jp, 1e-4)


def test_train_equals_jax_train_from_the_same_params(monkeypatch):
    """train() on both packages from the same initial params (the port's
    init_params draws from torch's generator, so the test hands it JAX's
    draw): the loss history within 1e-3 relative, the same holdout
    accuracy, and the JAX package's metric keys."""
    kw = dict(episodes=4, steps=12, num_pods=[96, 128], num_incidents=4,
              hidden=16, layers=2, lr=3e-3, seed=3, eval_holdout=1)
    monkeypatch.setattr(
        tgnn, "init_params", lambda gen, hidden, layers, device=None:
        tgnn.params_from_numpy(jax.tree_util.tree_map(
            np.asarray, _jax_params(3, hidden, layers)), device=device))
    mine = ttrain.train(device="cpu", **kw)
    ref = jtrain.train(**kw)
    assert mine["metrics"].keys() == ref["metrics"].keys()
    assert mine["config"] == ref["config"]
    hm, hr = mine["metrics"]["history"], ref["metrics"]["history"]
    assert [h["step"] for h in hm] == [h["step"] for h in hr]
    np.testing.assert_allclose([h["loss"] for h in hm],
                               [h["loss"] for h in hr], rtol=1e-3)
    assert mine["metrics"]["holdout_accuracy"] == \
        ref["metrics"]["holdout_accuracy"]
    assert mine["metrics"]["train_incidents"] == \
        ref["metrics"]["train_incidents"]
    assert hm[-1]["loss"] < hm[0]["loss"]
    _assert_params_close(mine["params"], ref["params"], 1e-3)


def test_confusion_and_crosscheck_equal_jax(monkeypatch):
    """The holdout confusion matrix and the oracle crosscheck (the rules
    backend on the same snapshots) equal the JAX package's for the same
    params."""
    jp = _jax_params(4)
    hold = jtrain.make_dataset(2, [96, 128], num_incidents=4, seed=40,
                               return_snapshot=True)
    mine_hold = ttrain.make_dataset(2, [96, 128], num_incidents=4, seed=40,
                                    return_snapshot=True)
    a = ttrain.confusion(_port(jp), mine_hold)
    b = jtrain.confusion(jp, hold)
    assert a == b
    ca = ttrain.crosscheck_holdout(_port(jp), mine_hold)
    cb = jtrain.crosscheck_holdout(jp, hold)
    assert ca == cb


def test_checkpoint_round_trips_through_the_serving_loader(tmp_path):
    params = _port(_jax_params(5))
    path = ttrain.save_checkpoint(str(tmp_path / "gnn"), params,
                                  {"hidden": 16, "layers": 2})
    assert path.endswith(".npz")
    back = ttrain.load_checkpoint(path)
    assert back["config"] == {"hidden": 16, "layers": 2}
    served = load_validated_checkpoint(path)
    for tree in (back["params"], served):
        _assert_params_close(tree, params, 0.0)
        assert "config.hidden" not in tgnn.flat_params(tree)


def test_cli_trains_and_saves_on_the_cpu(tmp_path, capsys):
    ckpt = tmp_path / "cli.npz"
    assert ttrain.main(["--episodes", "3", "--steps", "4", "--pods", "96",
                        "--incidents", "3", "--hidden", "8", "--layers", "1",
                        "--holdout", "1", "--device", "cpu",
                        "--checkpoint", str(ckpt)]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(metrics["history"]) == 4 and metrics["holdout_incidents"] == 3
    assert ttrain.load_checkpoint(str(ckpt))["config"] == {"hidden": 8,
                                                           "layers": 1}


def test_train_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.train(episodes=2, steps=1, eval_holdout=1)
