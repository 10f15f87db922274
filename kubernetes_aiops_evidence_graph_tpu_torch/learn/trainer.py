"""Background fine-tune from the live checkpoint + the eval gate.

The port of the JAX package's ``learn/trainer.py``:

* :func:`make_finetune_step` — the relation-bucketed loss plus a PROXIMAL
  ANCHOR ``0.5·w·Σ‖θ − θ_serve‖²`` pulling the candidate toward the
  serving checkpoint (the parameter-space half of the anti-forgetting
  story; the replay mix of simulator episodes is the data-space half).
  The anchor is read every step and never written.
* :func:`finetune` — a FRESH candidate fine-tuned over the interleaved
  production/simulator schedule; the serving tree is never mutated. With
  ``mesh_shards > 1`` it drives the sharded train step
  (``parallel/sharded_gnn.py``, ring halo) on a ``(1 x shards)`` data
  mesh over partitioned episodes (:func:`_finetune_sharded`).
* the **gate**: :func:`params_finite` and :func:`gate_eval` (holdout top-1).

On the card every message pass of the fine-tune and its backward run
through the hand kernels. ``pallas_grads`` (``settings.learn_pallas_grads``)
first holds one loss + grads through the params' device against a CPU copy
through the plain versions (:func:`check_grads_parity`) and RAISES on a
mismatch; the JAX package instead falls back to its XLA step.
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
    :func:`check_grads_parity` on the first scheduled episode first.
    ``mesh_shards > 1`` runs :func:`_finetune_sharded` on a ``(1 x
    mesh_shards)`` mesh, or (logged ``learn_mesh_unavailable``) this
    single-device tier when the position pool cannot carry one."""
    if not episodes and not sim_episodes:
        raise ValueError("finetune needs at least one episode")
    schedule = _interleave(episodes, sim_episodes, steps)
    if mesh_shards > 1:
        mesh = _data_mesh(mesh_shards, serving_params["embed_w"].device)
        if mesh is not None:
            return _finetune_sharded(serving_params, schedule, lr, mesh)
        log.warning("learn_mesh_unavailable: shards=%d", mesh_shards)
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


def _data_mesh(shards: int, device: torch.device):
    """The ``(1 x shards)`` data mesh of the sharded fine-tune, cut from
    the pool of the serving params' platform: the CPU's host positions
    (grown as serving grows them, ``parallel/mesh.ensure_host_devices``),
    the params' card repeated where the CUDA pool has one card, or the
    cards, the params' first, where it has several. None when the pool
    cannot carry it."""
    from ..parallel.mesh import (canonical_device, device_pool,
                                 ensure_host_devices, make_mesh)
    device = canonical_device(device)
    if device.type == "cpu" and not ensure_host_devices(shards):
        return None
    pool = device_pool(device)
    if device.type == "cuda":
        pool = ([device] * shards if len(pool) == 1 else
                [device] + [d for d in pool if d != device])
    if len(pool) < shards:
        return None
    return make_mesh(1, shards, pool[:shards])


def _finetune_sharded(serving_params, schedule: list, lr: float,
                      mesh) -> dict:
    """Drive the sharded train step (``parallel/sharded_gnn.py``, ring
    halo, one step per relation layout) over partitioned episodes, with
    Adam at ``lr``. Episodes must carry their snapshot, and its padded
    node count must divide over the mesh; others are skipped (ValueError
    when none is left). The label mask stands in for the incident mask,
    so unlabeled rows never add loss. As in the JAX package this tier has
    no proximal anchor (``anchor_weight`` is not read) and reports no
    ``pallas`` key."""
    import dataclasses
    from ..parallel.partition import partition_snapshot
    from ..parallel.sharded_gnn import (device_put_partitioned,
                                        make_sharded_train_step)
    graph = mesh.shape["graph"]
    steps_by_offs: dict = {}
    placed: dict[int, tuple] = {}    # each episode partitions and moves once
    params, opt_state = serving_params, None
    loss = torch.zeros(())
    ran = 0
    for ep in schedule:
        snap = ep.get("snapshot")
        if snap is None or snap.padded_nodes % graph:
            continue
        hit = placed.get(id(ep))
        if hit is None:
            labeled = dataclasses.replace(
                snap, incident_mask=np.asarray(ep["label_mask"], np.float32))
            part = partition_snapshot(labeled, dp=1, graph=graph,
                                      labels=np.asarray(ep["labels"]))
            hit = placed[id(ep)] = (part.rel_offsets,
                                    device_put_partitioned(part, mesh))
        key, arrays = hit
        step = steps_by_offs.get(key)
        if step is None:
            step = steps_by_offs[key] = make_sharded_train_step(
                mesh, gnn.adam(lr), halo="ring", rel_offsets=key)
        params, opt_state, loss = step(params, opt_state, *arrays)
        obs_metrics.LEARN_TRAIN_STEPS.inc()
        ran += 1
    if not ran:
        raise ValueError(
            "no episode was partitionable over the learn mesh "
            "(padded_nodes must divide by learn_mesh_shards)")
    params = gnn.unflat_params({k: v.detach() for k, v in
                                gnn.flat_params(params).items()})
    return {"params": params, "steps": ran, "final_loss": float(loss),
            "sharded": True}


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
