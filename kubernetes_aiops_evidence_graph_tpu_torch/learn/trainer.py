"""Background fine-tune from the live checkpoint + the eval gate.

The port of the JAX package's ``learn/trainer.py``, single-device:

* :func:`make_finetune_step` — the relation-bucketed loss plus a PROXIMAL
  ANCHOR ``0.5·w·Σ‖θ − θ_serve‖²`` pulling the candidate toward the
  serving checkpoint (the parameter-space half of the anti-forgetting
  story; the replay mix of simulator episodes is the data-space half).
  The anchor is read every step and never written.
* :func:`finetune` — a FRESH candidate fine-tuned over the interleaved
  production/simulator schedule; the serving tree is never mutated.
* the **gate**: :func:`params_finite` and :func:`gate_eval` (holdout top-1).

On the card every message pass of the fine-tune and its backward run
through the hand kernels. ``pallas_grads`` (``settings.learn_pallas_grads``)
first holds one loss + grads through the params' device against a CPU copy
through the plain versions (:func:`check_grads_parity`) and RAISES on a
mismatch; the JAX package instead falls back to its XLA step. The
data-parallel fine-tune (``mesh_shards > 1``) is not ported yet (ROADMAP
item 9b) and raises.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..observability import metrics as obs_metrics
from ..rca import gnn

log = logging.getLogger(__name__)


class GradsParityError(RuntimeError):
    """The fine-tune's loss or grads on the params' device differ from the
    plain versions' on the CPU."""


def make_finetune_step(optimizer_factory):
    """``step(params, opt_state, anchor, anchor_weight, batch,
    rel_offsets=None) -> (params, opt_state, loss)``: the online fine-tune
    step (see the module docstring). ``opt_state`` is the optimizer made by
    ``optimizer_factory`` over the params' leaves (``None`` on the first
    step makes it over a :func:`gnn.trainable` copy); ``anchor`` is the
    serving tree, on the params' device, read-only."""

    def step(params, opt_state, anchor, anchor_weight, batch,
             rel_offsets=None):
        if opt_state is None:
            params = gnn.trainable(params)
            opt_state = optimizer_factory(gnn.leaves(params))
        opt_state.zero_grad(set_to_none=True)
        loss = _total_loss(params, anchor, anchor_weight,
                           gnn.batch_to(batch, params["embed_w"].device),
                           rel_offsets)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return step


def _total_loss(params, anchor, anchor_weight, b: dict, rel_offsets):
    data = gnn.loss_fn(params, *(b[k] for k in gnn.TRAIN_ARRAYS),
                       rel_offsets=rel_offsets)
    prox = sum(torch.sum(torch.square(p - a.detach()))
               for p, a in zip(gnn.leaves(params), gnn.leaves(anchor)))
    return data + 0.5 * anchor_weight * prox


def _clean_batch(ep: dict) -> tuple[dict, "tuple | None"]:
    """(the batch's arrays, its rel_offsets): snapshot, tenant and the
    other bookkeeping entries stripped, as the offline trainer does."""
    offs = tuple(ep.get("rel_offsets") or ()) or None
    batch = {k: v for k, v in ep.items() if k in gnn.TRAIN_ARRAYS}
    return batch, offs


def _interleave(prod: list, sim: list, steps: int) -> list:
    """The fine-tune schedule: production and simulator episodes
    alternate (anti-forgetting), cycling each list independently."""
    out = []
    for s in range(steps):
        pool = prod if (s % 2 == 0 or not sim) else sim
        if not pool:
            pool = sim or prod
        out.append(pool[(s // 2) % len(pool)])
    return out


def _loss_and_grads(params, batch: dict, offs) -> tuple[float, list]:
    """One loss + grads of the data loss, on the params' device."""
    p = gnn.trainable(params)
    b = gnn.batch_to(batch, p["embed_w"].device)
    loss = gnn.loss_fn(p, *(b[k] for k in gnn.TRAIN_ARRAYS),
                       rel_offsets=offs)
    grads = torch.autograd.grad(loss, gnn.leaves(p))
    return float(loss.detach()), [g.detach().cpu() for g in grads]


def check_grads_parity(params, episode: dict, rtol: float = 1e-4,
                       atol: float = 1e-4) -> None:
    """Gate-time parity check of the device tier: one loss + grads through
    the params' device (on the card: the hand kernels) against a CPU copy
    through the plain versions, on a real episode, leaf by leaf. Raises
    :class:`GradsParityError` on a mismatch (no fallback) and ValueError
    for an episode without a relation-bucketed layout."""
    batch, offs = _clean_batch(episode)
    if offs is None:
        raise ValueError("the grads parity check needs a relation-bucketed "
                         "episode (rel_offsets)")
    ld, gd = _loss_and_grads(params, batch, offs)
    cpu = gnn.unflat_params({k: v.detach().cpu() for k, v in
                             gnn.flat_params(params).items()})
    lc, gc = _loss_and_grads(cpu, batch, offs)
    names = list(gnn.flat_params(params))
    if not np.allclose(ld, lc, rtol=rtol, atol=atol):
        raise GradsParityError(f"fine-tune loss {ld} on "
                               f"{params['embed_w'].device} vs {lc} on cpu")
    for name, a, b in zip(names, gd, gc):
        if not torch.allclose(a, b, rtol=rtol, atol=atol):
            raise GradsParityError(
                f"fine-tune grad {name} differs from the plain versions' "
                f"(max |d| {float((a - b).abs().max())})")


def finetune(serving_params, episodes: list, sim_episodes: list,
             steps: int, lr: float, anchor_weight: float,
             mesh_shards: int = 1, pallas_grads: bool = False) -> dict:
    """Fine-tune a candidate from ``serving_params`` (on its device) over
    the interleaved production/simulator schedule. Returns ``{"params",
    "steps", "final_loss", "sharded", "pallas"}``; the candidate is a FRESH
    tree (the serving tree is never mutated; the swap is the only way a
    candidate reaches serving). ``pallas_grads`` runs
    :func:`check_grads_parity` on the first scheduled episode first."""
    if not episodes and not sim_episodes:
        raise ValueError("finetune needs at least one episode")
    if mesh_shards > 1:
        raise NotImplementedError(
            f"learn_mesh_shards={mesh_shards}: the data-parallel fine-tune "
            "is not ported yet (ROADMAP item 9b, multi-device); use 1")
    schedule = _interleave(episodes, sim_episodes, steps)
    if pallas_grads:
        check_grads_parity(serving_params, schedule[0])
    dev = serving_params["embed_w"].device
    anchor = gnn.unflat_params({k: v.detach() for k, v in
                                gnn.flat_params(serving_params).items()})
    step = make_finetune_step(gnn.adam(lr))
    params, opt_state = serving_params, None
    loss = torch.zeros((), device=dev)
    uploaded: dict[int, dict] = {}      # each episode moves to the device once
    for ep in schedule:
        batch, offs = _clean_batch(ep)
        b = uploaded.get(id(ep))
        if b is None:
            b = uploaded[id(ep)] = gnn.batch_to(batch, dev)
        params, opt_state, loss = step(params, opt_state, anchor,
                                       anchor_weight, b, rel_offsets=offs)
        obs_metrics.LEARN_TRAIN_STEPS.inc()
    params = gnn.unflat_params({k: v.detach() for k, v in
                                gnn.flat_params(params).items()})
    return {"params": params, "steps": len(schedule),
            "final_loss": float(loss), "sharded": False,
            "pallas": bool(pallas_grads)}


def params_finite(params) -> bool:
    """Host check that every candidate leaf is finite — a poisoned
    candidate must die at the gate, not at the verdict boundary."""
    return all(bool(torch.isfinite(torch.as_tensor(v)).all())
               for v in gnn.flat_params(params).values())


def gate_eval(params, holdout: list) -> float:
    """Holdout top-1 for the gate: the offline trainer's evaluate() over
    the holdout episodes' arrays and layouts."""
    from ..rca.train import evaluate
    batches = []
    for ep in holdout:
        batch, offs = _clean_batch(ep)
        if offs is not None:
            batch["rel_offsets"] = offs   # forward_batch reads it
        batches.append(batch)
    return evaluate(params, batches)
