"""Learned RCA backend — ``rca_backend="gnn"``.

Scores every incident in a GraphSnapshot with the GNN (``rca/gnn.py``) in
one forward, returning the same raw-dict / RCAResult surface as the JAX
package's ``GnnRcaBackend``. Parameters come from a numpy ``.npz`` file
(``settings.gnn_checkpoint``, or the checkpoint shipped inside this
package, ``checkpoints/gnn.npz``) or are passed in.

The shipped file is the JAX package's orbax checkpoint (``checkpoints/gnn``
at the repository root) converted leaf for leaf; the converter and the
test that holds every leaf equal to the orbax leaf live in
``tests/test_torch_gnn.py``. Reading it needs numpy alone.
"""
from __future__ import annotations

import os
from pathlib import Path
from uuid import uuid4

import numpy as np
import torch

from ..device import resolve_device
from ..graph.snapshot import GraphSnapshot
from ..models import Hypothesis, HypothesisSource, RCAResult
from . import gnn
from .cuda_backend import _incident_uuid
from .ruleset import NUM_RULES, RULES, UNKNOWN_CONFIDENCE

SHIPPED_CHECKPOINT = Path(__file__).resolve().parents[1] / "checkpoints" / "gnn.npz"


class CheckpointError(ValueError):
    """A checkpoint could not be loaded or fails the serving contract
    (unreadable file, an orbax directory, the legacy pre-relation-aware
    layout, missing keys). A ValueError, as in the JAX package."""


def load_validated_checkpoint(path: "str | os.PathLike") -> gnn.Params:
    """Load a ``.npz`` checkpoint (flat keys ``embed_w``, ``layers.0.w_rel``
    ...; see ``gnn.flat_params``) as a numpy params tree, and validate it
    against the serving model contract. Keys ``config.*`` (the model config
    the trainer stores beside the leaves, ``rca/train.save_checkpoint``)
    are not params. Every failure is one :class:`CheckpointError`."""
    path = Path(path)
    if path.is_dir():
        raise CheckpointError(
            f"checkpoint at {path} is a directory (an orbax checkpoint of "
            "the JAX package): convert it to .npz with the converter in "
            "tests/test_torch_gnn.py (write_npz_checkpoint)")
    try:
        with np.load(path, allow_pickle=False) as data:
            flat = {k: np.asarray(data[k]) for k in data.files
                    if not k.startswith("config.")}
    except (OSError, ValueError, KeyError, EOFError) as exc:
        raise CheckpointError(
            f"checkpoint at {path} is unreadable ({type(exc).__name__}: "
            f"{exc}): point KAEG_GNN_CHECKPOINT at a valid .npz "
            "checkpoint") from exc
    params = gnn.unflat_params(flat)
    if "embed_w" not in params:
        raise CheckpointError(
            f"checkpoint at {path} does not contain a GNN params tree "
            "(no 'embed_w')")
    layers = params.get("layers") or []
    if layers and "w_rel" not in layers[0]:
        raise CheckpointError(
            f"checkpoint at {path} predates the relation-aware GNN "
            "(layers carry 'w_msg', expected 'w_rel'): point "
            "KAEG_GNN_CHECKPOINT at a current checkpoint")
    return params


def resolve_params(params: "gnn.Params | None", settings,
                   device: torch.device) -> gnn.Params:
    """``params`` (numpy or tensor leaves) on ``device``, or the checkpoint
    ``settings.gnn_checkpoint`` names (the shipped one when empty)."""
    if params is None:
        path = getattr(settings, "gnn_checkpoint", "") or SHIPPED_CHECKPOINT
        params = load_validated_checkpoint(path)
    return gnn.params_from_numpy(params, device=device)


class GnnRcaBackend:
    name = "gnn"

    def __init__(self, params: gnn.Params | None = None, settings=None,
                 device: "str | torch.device | None" = None) -> None:
        from ..config import get_settings
        cfg = settings or get_settings()
        self.device = resolve_device(device)
        self.params = resolve_params(params, cfg, self.device)
        self._compute_dtype = getattr(cfg, "gnn_compute_dtype", "") or None

    def score_snapshot(self, snapshot: GraphSnapshot) -> dict:
        """Same keys as the JAX package's GnnRcaBackend.score_snapshot:
        softmax and argmax run on the device, and the result is fetched
        once."""
        logits = gnn.forward_batch(self.params, gnn.snapshot_batch(snapshot),
                                   compute_dtype=self._compute_dtype)
        probs = torch.softmax(logits, dim=-1)
        conf, pred = probs.max(dim=-1)
        probs, pred, conf = (t.cpu().numpy() for t in (probs, pred, conf))
        n = snapshot.num_incidents
        return {
            "incident_ids": snapshot.incident_ids,
            "probs": probs[:n],
            "top_rule_index": pred[:n],                      # NUM_RULES = unknown
            "any_match": (pred != NUM_RULES)[:n],
            "top_confidence": conf[:n],
        }

    def results(self, snapshot: GraphSnapshot | None = None,
                raw: dict | None = None, top_k: int = 3) -> list[RCAResult]:
        """RCAResult models from a snapshot or a raw dict (a
        ``score_snapshot`` result or a GnnStreamingScorer rescore)."""
        if raw is None:
            if snapshot is None:
                raise ValueError("results() needs a snapshot or a raw dict")
            raw = self.score_snapshot(snapshot)
        out: list[RCAResult] = []
        for i, inc_id in enumerate(raw["incident_ids"]):
            uid = _incident_uuid(inc_id)
            order = np.argsort(raw["probs"][i])[::-1][:top_k]
            hyps: list[Hypothesis] = []
            # argmax == unknown  ⇒  any_match is False: the incident gets the
            # unknown hypothesis, not a low-probability rule promoted to top-1
            if int(order[0]) != NUM_RULES:
                ranked = [c for c in order
                          if c != NUM_RULES and raw["probs"][i][c] > 0.0]
                for rank, cls in enumerate(ranked, start=1):
                    conf = float(raw["probs"][i][cls])
                    rule = RULES[int(cls)]
                    hyps.append(Hypothesis(
                        id=uuid4(), incident_id=uid, category=rule.category,
                        title=rule.name, description=rule.description,
                        confidence=min(conf, 0.99), final_score=conf, rank=rank,
                        recommended_actions=rule.recommended_actions,
                        rule_id=rule.id, backend="gnn",
                        generated_by=HypothesisSource.GNN,
                    ))
            if not hyps:
                from .cpu_backend import _unknown_hypothesis
                from .signals import Signals
                h = _unknown_hypothesis(uid, Signals())
                h.backend = "gnn"
                h.generated_by = HypothesisSource.GNN
                h.confidence = UNKNOWN_CONFIDENCE
                hyps = [h]
            out.append(RCAResult(
                incident_id=uid, hypotheses=hyps, top_hypothesis=hyps[0],
                rules_matched=[h.rule_id for h in hyps if h.rule_id != "unknown"],
                backend="gnn",
            ))
        return out
