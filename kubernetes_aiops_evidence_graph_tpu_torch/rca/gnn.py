"""Learnable GNN RCA scorer (``rca_backend="gnn"``).

A relation-aware graph scorer over the tensorized evidence graph: node
features + entity-kind embeddings, ``L`` rounds of message passing with a
separate ``[H, H]`` transform per RelationKind, and an incident-node
readout to rule logits (``NUM_RULES + 1`` classes, the last = unknown).
The math is the JAX package's ``rca/gnn.py``; parameters are a plain
dictionary of tensors in the same nesting (``layers`` is a list), so the
JAX package's params convert leaf for leaf (:func:`params_from_numpy`).

Two mappings of the per-relation math:

* **relation-bucketed (served)**: the snapshot lays edges out in
  per-relation contiguous slices (``rel_offsets``), and each layer runs
  one message pass of ``kernels/gms`` — on the card the hand-written CUDA
  kernel, on the CPU its plain version. The layout's dst-CSR is built once
  per forward and shared by the layers.
* **transform-then-gather (reference)**: :func:`rel_messages` /
  :func:`_message_pass`, plain PyTorch, kept for the tests. Only CPU
  tensors take it; the port serves bucketed layouts.

Training: :func:`loss_fn` (masked mean cross-entropy) and
:func:`make_train_step` (loss, backward, a ``torch.optim`` step). On the
card the backward of each message pass runs through the hand kernels too
(``kernels/gms``'s autograd Function: ``gms`` on the transposed layout for
the node-table gradient, ``kernels/grad_w`` for the weight gradient).

The embed, self-transform and head products are ``torch.matmul`` in full
float32 (the JAX package leaves them to XLA outside any kernel), so TF32
must stay off (``torch.backends.cuda.matmul.allow_tf32``, off by default).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..graph.schema import DIM, EntityKind, RelationKind
from ..kernels import gms
from ..ops.segment import as_dtype
from .ruleset import NUM_RULES

NUM_CLASSES = NUM_RULES + 1   # + unknown
NUM_KINDS = len(EntityKind)   # embedding rows track the schema
NUM_RELS = len(RelationKind)  # per-relation message transforms

Params = dict[str, Any]


def init_params(generator: torch.Generator | None = None, hidden: int = 64,
                layers: int = 3, device=None) -> Params:
    """Random params with the JAX package's shapes and scales, drawn from
    ``generator`` (the numbers differ from ``jax.random``'s)."""
    def normal(*shape, scale):
        return (torch.randn(shape, generator=generator) * scale).to(device)

    s_dim, s_hid = 1.0 / np.sqrt(DIM), 1.0 / np.sqrt(hidden)
    params: Params = {
        "embed_w": normal(DIM, hidden, scale=s_dim),
        "embed_b": torch.zeros(hidden, device=device),
        "kind_emb": normal(NUM_KINDS, hidden, scale=0.1),
        "head_w": normal(hidden, NUM_CLASSES, scale=s_hid),
        "head_b": torch.zeros(NUM_CLASSES, device=device),
        "layers": [],
    }
    for _ in range(layers):
        params["layers"].append({
            "w_self": normal(hidden, hidden, scale=s_hid),
            "w_rel": normal(NUM_RELS, hidden, hidden, scale=s_hid),
            "b": torch.zeros(hidden, device=device),
        })
    return params


def flat_params(params: Params) -> dict[str, Any]:
    """``{"embed_w": ..., "layers.0.w_rel": ...}``: the leaves under flat
    dotted keys (the keys of the shipped ``checkpoints/gnn.npz``)."""
    flat = {k: v for k, v in params.items() if k != "layers"}
    for i, layer in enumerate(params.get("layers", [])):
        for k, v in layer.items():
            flat[f"layers.{i}.{k}"] = v
    return flat


def unflat_params(flat: dict[str, Any]) -> Params:
    """Inverse of :func:`flat_params`."""
    params: Params = {"layers": []}
    for key, v in flat.items():
        if not key.startswith("layers."):
            params[key] = v
            continue
        _, i, name = key.split(".", 2)
        i = int(i)
        while len(params["layers"]) <= i:
            params["layers"].append({})
        params["layers"][i][name] = v
    return params


def params_from_numpy(tree: Params, device=None) -> Params:
    """The JAX package's params (numpy or array leaves, same nesting; or
    tensors) → the port's float32 tensors on ``device``, leaf for leaf."""
    def leaf(v):
        if isinstance(v, torch.Tensor):
            return v.detach().to(device=device, dtype=torch.float32,
                                  copy=True)
        return torch.as_tensor(np.array(v, dtype=np.float32, copy=True),
                               device=device)
    return unflat_params({k: leaf(v) for k, v in flat_params(tree).items()})


def rel_messages(h_table, w_rel, src_index, edge_rel, edge_mask):
    """[E, H] per-edge messages under the transform-then-gather mapping
    (the reference): every relation's transformed copy of ``h_table``
    densely, then each edge gathers its rel-specific source row. Padded
    edges carry rel = -1 (clipped to 0; their mask zeroes the message)."""
    rel = torch.clamp(edge_rel.long(), 0, NUM_RELS - 1)
    hr = torch.einsum("nh,rhk->nrk", h_table, w_rel)          # [N, R, K]
    flat = hr.reshape(h_table.shape[0] * NUM_RELS, hr.shape[-1])
    return flat[src_index.long() * NUM_RELS + rel] * edge_mask[:, None]


def _message_pass(h, layer, edge_src, edge_dst, edge_rel, edge_mask,
                  inv_deg):
    """One round of the reference mapping: messages, one segment sum."""
    msg = rel_messages(h, layer["w_rel"], edge_src, edge_rel, edge_mask)
    agg = torch.zeros_like(h).index_add_(0, edge_dst.long(), msg) \
        * inv_deg[:, None]
    return torch.relu(h @ layer["w_self"] + agg + layer["b"]) + h


def _message_pass_bucketed(h, layer, edge_src, edge_dst, edge_mask,
                           rel_offsets, inv_deg, compute_dtype, plan):
    """One round over the relation-bucketed layout through ``kernels/gms``.
    ``compute_dtype`` ("bfloat16") casts the matmul operands only;
    accumulation stays float32."""
    agg = gms.gather_matmul_segment(
        h, layer["w_rel"], edge_src, edge_dst, edge_mask, rel_offsets,
        h.shape[0], compute_dtype=compute_dtype, plan=plan) \
        * inv_deg[:, None]
    if compute_dtype is not None:
        cdt = as_dtype(compute_dtype)
        self_t = h.to(cdt).to(h.dtype) @ layer["w_self"].to(cdt).to(h.dtype)
    else:
        self_t = h @ layer["w_self"]
    return torch.relu(self_t + agg + layer["b"]) + h


def forward(
    params: Params,
    features: torch.Tensor,        # [N, DIM] f32
    node_kind: torch.Tensor,       # [N] i32
    node_mask: torch.Tensor,       # [N] f32
    edge_src: torch.Tensor,        # [E] i32
    edge_dst: torch.Tensor,        # [E] i32
    edge_rel: torch.Tensor,        # [E] i32 (RelationKind; -1 = padding)
    edge_mask: torch.Tensor,       # [E] f32
    incident_nodes: torch.Tensor,  # [B] i32
    *,
    rel_offsets: tuple[int, ...] | None = None,
    compute_dtype: str | None = None,
) -> torch.Tensor:
    """Logits ``[B, NUM_CLASSES]`` for each incident node.

    ``rel_offsets`` (the ``[R+1]`` slice bounds of a relation-bucketed
    layout) selects the bucketed mapping through ``kernels/gms``; without
    it the reference mapping runs, for CPU tensors only."""
    n = features.shape[0]
    # degree: a sum of 0/1 masks, exact in any order
    deg = torch.zeros(n, dtype=features.dtype, device=features.device
                      ).index_add_(0, edge_dst.long(), edge_mask)
    # maximum, not clamp: at deg == 1 its gradient splits between the two
    # arguments, as jnp.maximum's does (edge_mask's gradient in training)
    inv_deg = torch.where(deg > 0, 1.0 / torch.maximum(deg, torch.ones_like(deg)),
                          torch.zeros_like(deg))
    # the kind lookup as a one-hot product: the same rows exactly (one term
    # of 1 * row, the others 0), and a backward that is one deterministic
    # matmul. On an H100 at config 3 the index form's backward took 16 ms
    # of a 20 ms training step (it walks each kind's rows one by one) and
    # F.embedding's adds with float atomics, so two steps differed
    kinds = torch.arange(params["kind_emb"].shape[0], device=features.device)
    one_hot = (node_kind.long()[:, None] == kinds).to(features.dtype)
    h = torch.relu(features @ params["embed_w"] + params["embed_b"]
                   + one_hot @ params["kind_emb"])
    h = h * node_mask[:, None]
    if rel_offsets is not None:
        plan = (gms.make_plan(edge_dst, edge_mask, rel_offsets, n)
                if features.device.type == "cuda" else None)
        for layer in params["layers"]:
            h = _message_pass_bucketed(h, layer, edge_src, edge_dst,
                                       edge_mask, rel_offsets, inv_deg,
                                       compute_dtype, plan)
    else:
        if features.device.type != "cpu":
            raise ValueError("the reference mapping runs on the CPU only; "
                             "pass rel_offsets (relation-bucketed layout)")
        for layer in params["layers"]:
            h = _message_pass(h, layer, edge_src, edge_dst, edge_rel,
                              edge_mask, inv_deg)
    return h[incident_nodes.long()] @ params["head_w"] + params["head_b"]


def loss_fn(
    params: Params,
    features, node_kind, node_mask, edge_src, edge_dst, edge_rel,
    edge_mask, incident_nodes, labels, label_mask,
    *,
    rel_offsets: tuple[int, ...] | None = None,
    compute_dtype: str | None = None,
) -> torch.Tensor:
    """Masked mean cross-entropy over incident rows (keywords as in
    :func:`forward`): ``sum(nll * label_mask) / max(sum(label_mask), 1)``."""
    logits = forward(params, features, node_kind, node_mask, edge_src,
                     edge_dst, edge_rel, edge_mask, incident_nodes,
                     rel_offsets=rel_offsets, compute_dtype=compute_dtype)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    return (nll * label_mask).sum() / torch.clamp(label_mask.sum(), min=1.0)


def adam(lr: float):
    """The optimizer factory of ``optax.adam(lr)``: torch's Adam has the
    same defaults (b1 0.9, b2 0.999, eps 1e-8) and the same update,
    ``lr * m_hat / (sqrt(v_hat) + eps)``."""
    return lambda leaves: torch.optim.Adam(leaves, lr=lr)


def adamw(lr: float, weight_decay: float):
    """The optimizer factory of ``optax.adamw(lr, weight_decay=wd)``. optax
    adds ``wd * p`` to the update before the ``-lr`` scale, torch decays
    ``p`` first; the two agree to rounding."""
    return lambda leaves: torch.optim.AdamW(leaves, lr=lr,
                                            weight_decay=weight_decay)


def trainable(params: Params) -> Params:
    """A fresh copy of ``params`` whose float32 leaves require grad (the
    tree an optimizer steps; the tree it came from is never touched)."""
    return unflat_params({k: v.detach().clone().float().requires_grad_(True)
                          for k, v in flat_params(params).items()})


def leaves(params: Params) -> list[torch.Tensor]:
    """The params' leaves in :func:`flat_params` order."""
    return list(flat_params(params).values())


def batch_to(batch: dict, device) -> dict:
    """The array entries of a :func:`snapshot_batch` (``TRAIN_ARRAYS``;
    numpy arrays or tensors) as tensors on ``device``; other entries are
    left out."""
    return {k: _tensor(batch[k], device) for k in TRAIN_ARRAYS if k in batch}


def _tensor(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.as_tensor(np.ascontiguousarray(v)).to(device)


def make_train_step(optimizer_factory):
    """The single-device train step: ``step(params, opt_state, batch,
    rel_offsets=None) -> (params, opt_state, loss)``.

    ``optimizer_factory`` maps a list of leaves to a ``torch.optim``
    optimizer (:func:`adam`, :func:`adamw`). ``opt_state`` is that
    optimizer; pass ``None`` on the first step and the step makes it over
    :func:`trainable` leaves of ``params``. The optimizer updates the
    leaves in place, so the returned ``params`` is the tree it steps.
    ``batch`` holds ``TRAIN_ARRAYS`` (numpy or tensors; moved to the
    params' device); ``rel_offsets`` is the batch's relation layout. The
    returned loss is a detached scalar tensor on the params' device."""

    def step(params, opt_state, batch, rel_offsets=None):
        if opt_state is None:
            params = trainable(params)
            opt_state = optimizer_factory(leaves(params))
        dev = params["embed_w"].device
        b = batch_to(batch, dev)
        opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(params, *(b[k] for k in TRAIN_ARRAYS),
                       rel_offsets=rel_offsets)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return step


_BATCH_ARRAYS = ("features", "node_kind", "node_mask", "edge_src",
                 "edge_dst", "edge_rel", "edge_mask", "incident_nodes")
TRAIN_ARRAYS = _BATCH_ARRAYS + ("labels", "label_mask")


def forward_batch(params: Params, batch: dict, *,
                  compute_dtype: str | None = None) -> torch.Tensor:
    """Score one :func:`snapshot_batch` on the params' device through the
    relation-bucketed mapping (every snapshot of the port carries
    ``rel_offsets``)."""
    offs = tuple(batch.get("rel_offsets") or ())
    if not offs:
        raise ValueError("batch has no rel_offsets: the port serves "
                         "relation-bucketed layouts only")
    dev = params["embed_w"].device
    args = [_tensor(batch[k], dev) for k in _BATCH_ARRAYS]
    return forward(params, *args, rel_offsets=offs,
                   compute_dtype=compute_dtype)


def snapshot_batch(snapshot, labels=None) -> dict:
    """Pack a GraphSnapshot (+ optional int labels per incident) into the
    host array batch :func:`forward_batch` consumes."""
    n_inc = snapshot.padded_incidents
    lab = np.full(n_inc, NUM_CLASSES - 1, dtype=np.int32)
    if labels is not None:
        lab[:len(labels)] = np.asarray(labels, dtype=np.int32)
    return {
        "rel_offsets": tuple(getattr(snapshot, "rel_offsets", ()) or ()),
        "features": snapshot.features,
        "node_kind": snapshot.node_kind,
        "node_mask": snapshot.node_mask,
        "edge_src": snapshot.edge_src,
        "edge_dst": snapshot.edge_dst,
        "edge_rel": snapshot.edge_rel,
        "edge_mask": snapshot.edge_mask,
        "incident_nodes": snapshot.incident_nodes,
        "labels": lab,
        "label_mask": snapshot.incident_mask,
    }
