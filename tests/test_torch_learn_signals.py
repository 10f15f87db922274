"""The online learner's post-swap watch against the JAX package's: the
learners of both packages drive the same sequence on the same seeded
world — a swap of new params into the served scorer, then a shielded
serve whose verdict is non-finite — and must end with the same
rollbacks, the same served generation and the same learner events in the
flight ring (``params_swap_atomic``, ``params_swap``,
``params_rollback``).

The watch reads the shield's non-finite verdict counter
(``aiops_shield_nonfinite_verdicts_total{path="shield"}``, process-wide)
beside each target's quarantines. With the non-finite serve on another
shielded scorer, only that counter moves: the learner rolls its target
back. With it on the target's own shield, the shield rolls the swap back
itself (its ``params_rollback`` rung) and the learner has nothing left to
restore."""
import numpy as np
import pytest
import torch

from tests.test_torch_scope_shield import _scaled
from tests.test_torch_scope_tick import _fence, _mod, _records, _setup
from tests.test_torch_streaming import JAX_PKG, PORT_PKG

torch.set_num_threads(1)

LEARNER_EVENTS = ("params_swap_atomic", "params_swap", "params_rollback")


@pytest.fixture(scope="module")
def params():
    from kubernetes_aiops_evidence_graph_tpu_torch.rca.gnn_backend import (
        SHIPPED_CHECKPOINT, load_validated_checkpoint)
    return load_validated_checkpoint(SHIPPED_CHECKPOINT)


def _poison(pkg, scorer) -> None:
    """Every resident feature row NaN (a silent device corruption): the
    next learned verdict is non-finite."""
    if pkg == JAX_PKG:
        import jax.numpy as jnp
        scorer._features_dev = jnp.full_like(scorer._features_dev, jnp.nan)
    else:
        scorer._features_dev.fill_(float("nan"))


@pytest.mark.parametrize("where", ["other_shield", "own_shield"])
def test_learner_watch_matches_jax_after_a_nonfinite_serve(params, tmp_path,
                                                           where):
    def run(pkg):
        metrics = _mod(pkg, "observability.metrics")
        shield_mod = _mod(pkg, "rca.shield")
        cluster, builder, incidents, target = _setup(
            pkg, 2, tier="composed", params=params)
        served = target
        if where == "own_shield":
            served = shield_mod.ShieldedScorer(
                target, target.settings, directory=str(tmp_path / pkg / "own"))
        learner = _mod(pkg, "learn.loop").OnlineLearner(
            None, [served], settings=target.settings)
        other = None
        if where == "other_shield":
            other = shield_mod.ShieldedScorer(
                _mod(pkg, "rca.gnn_streaming").GnnStreamingScorer(
                    builder.store, target.settings, params=params,
                    now_s=target.now_s,
                    **({"device": "cpu"} if pkg == PORT_PKG else {})),
                target.settings, directory=str(tmp_path / pkg / "other"))
            other.rescore()
        shielded = other if other is not None else served
        shielded.rescore()
        marker = _fence(pkg)
        nonfinite0 = metrics.SHIELD_NONFINITE_VERDICTS.value(path="shield")
        gen = learner.swap(_scaled(params, 0.5))
        _poison(pkg, shielded.scorer)
        shielded.rescore()
        moved = metrics.SHIELD_NONFINITE_VERDICTS.value(path="shield") \
            - nonfinite0
        rolled = learner.maybe_rollback()
        out = target.rescore()
        assert np.isfinite(out["probs"]).all()
        events = [{k: v for k, v in r.items() if k != "generations"}
                  | {"generations": list(r.get("generations", []))}
                  for r in _records(pkg, marker)
                  if r.get("event") in LEARNER_EVENTS]
        return (gen, moved > 0, rolled, learner.rollbacks,
                out["params_generation"], events)

    got = {pkg: run(pkg) for pkg in (JAX_PKG, PORT_PKG)}
    assert got[PORT_PKG] == got[JAX_PKG]
    gen, moved, rolled, rollbacks, served_gen, events = got[PORT_PKG]
    assert gen == 1 and moved
    if where == "other_shield":
        # only the process-wide counter moved: the learner rolls back
        assert rolled and rollbacks == 1 and served_gen == 2
        assert [e["event"] for e in events] == [
            "params_swap", "params_swap_atomic", "params_swap",
            "params_rollback"]
    else:
        # the target's own shield rolled the swap back first
        assert not rolled and rollbacks == 0 and served_gen == 2
