"""Batched RCA backend — every incident scored in one device pass.

The per-incident Python fold + rule loop of the reference becomes one
batched computation over the tensorized evidence graph:

1. host prep (numpy, O(E)): evidence edges (Incident→entity AFFECTS /
   CORRELATES_WITH) labeled with their incident *row* and laid out as a
   dense bucketed [Pi, W] slot table (sorted by row; W = bucketed max
   evidence per incident); a join of AFFECTS(incident→pod) with
   SCHEDULED_ON(pod→node) stamps each slot with a row-local pair id for
   the multiple-pods-same-node condition (same slot layout, see
   EvidenceLayout);
2. device: one ``kernels/rules_fold`` launch folds the live slots of each
   row into counts and per-(row, node) problem-pod counts and runs the
   rules tail (conditions → all-of rule matching → constant-folded scores
   → first-maximal top-1) without leaving the chip.

Because the signal fold and checkers mirror the CPU oracle exactly, top-1
rule ids and scores are bit-identical to ``CpuRcaBackend`` and to the JAX
package's ``TpuRcaBackend`` on the same snapshot.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from uuid import UUID, uuid4

import numpy as np
import torch

from ..device import resolve_device
from ..graph.schema import EntityKind, RelationKind
from ..graph.snapshot import GraphSnapshot
from ..kernels.rules_fold import rules_fold
from ..ladders import (PACK_BUCKETS as _PACK_BUCKETS_LADDER,
                       PAIR_WIDTH_BUCKETS as _PAIR_WIDTH_BUCKETS,
                       WIDTH_BUCKETS as _WIDTH_BUCKETS)
from ..models import Hypothesis, HypothesisSource, RCAResult
from ..observability import get_logger
from ..observability import metrics as obs_metrics
from ..observability import scope as obs_scope
from ..utils.padding import bucket_for
from .ruleset import NUM_RULES, RULES

log = get_logger("cuda_backend")


@dataclass(frozen=True)
class DeviceBatch:
    """Host-prepared, padded arrays for one scoring pass."""
    num_incidents: int
    padded_incidents: int
    # dense evidence slots: for incident row i, ev_idx[i, :ev_cnt[i]] are
    # the node indices of its evidence entities (live slots are always a
    # contiguous prefix, so the kernel reads exactly that prefix)
    ev_idx: np.ndarray         # [Pi, W] int32
    ev_cnt: np.ndarray         # [Pi] int32
    # (incident, node) pairs for multiple_pods_same_node: each evidence slot
    # carries the row-local id of the node its pod is scheduled on (or
    # pair_width = "no node")
    ev_pair_slot: np.ndarray   # [Pi, W] int32, values in [0, pair_width]
    pair_width: int            # Wr: max distinct nodes per row, bucketed
    features: np.ndarray       # [Pn, DIM] f32


def evidence_coo(snapshot: GraphSnapshot) -> tuple[np.ndarray, np.ndarray]:
    """Live evidence edges as (incident row, entity node) COO arrays.

    AFFECTS / CORRELATES_WITH edges whose src is an incident (undirected
    duplicates whose *dst* is the incident are dropped here). Invariant
    under pod reschedules."""
    inc_row = np.full(snapshot.padded_nodes, -1, dtype=np.int64)
    real = snapshot.incident_mask > 0
    inc_row[snapshot.incident_nodes[real]] = np.arange(int(real.sum()))

    live = snapshot.edge_mask > 0
    src = snapshot.edge_src[live]
    dst = snapshot.edge_dst[live]
    rel = snapshot.edge_rel[live]
    is_ev = ((rel == int(RelationKind.AFFECTS)) | (rel == int(RelationKind.CORRELATES_WITH)))
    is_ev &= inc_row[src] >= 0
    return inc_row[src[is_ev]], dst[is_ev].astype(np.int64)


@dataclass(frozen=True)
class EvidenceLayout:
    """The shared slot layout of the dense evidence table: the alignment
    between ev_idx and ev_pair_slot is load-bearing (slot (i, w) must mean
    the same evidence entry in both), so both tables derive from this one
    object instead of re-sorting independently."""
    order: np.ndarray    # permutation sorting the COO by incident row (stable)
    rows_s: np.ndarray   # sorted incident rows
    slots: np.ndarray    # within-row slot of each sorted entry
    cnt: np.ndarray      # per-row entry counts [Pi]
    width: int           # bucketed max entries per row


def evidence_layout(ev_rows: np.ndarray, pi: int) -> EvidenceLayout:
    order = np.argsort(ev_rows, kind="stable")
    rows_s = ev_rows[order]
    cnt = np.bincount(rows_s, minlength=pi) if len(rows_s) else np.zeros(pi, np.int64)
    width = bucket_for(max(int(cnt.max()) if len(rows_s) else 1, 1), _WIDTH_BUCKETS)
    if len(rows_s):
        starts = np.concatenate([[0], np.cumsum(cnt)])
        slots = np.arange(len(rows_s)) - starts[rows_s]
    else:
        slots = np.zeros(0, np.int64)
    return EvidenceLayout(order=order, rows_s=rows_s, slots=slots,
                          cnt=cnt, width=width)


def dense_evidence_table(ev_rows: np.ndarray, ev_dst: np.ndarray, pi: int,
                         layout: EvidenceLayout | None = None,
                         ) -> tuple[np.ndarray, np.ndarray]:
    """[Pi, W] slot table + per-row counts from the COO."""
    lo = layout or evidence_layout(ev_rows, pi)
    ev_idx = np.zeros((pi, lo.width), np.int32)
    if len(lo.rows_s):
        ev_idx[lo.rows_s, lo.slots] = ev_dst[lo.order]
    return ev_idx, lo.cnt.astype(np.int32)


def pair_tables(snapshot: GraphSnapshot, ev_rows: np.ndarray,
                ev_dst: np.ndarray,
                layout: EvidenceLayout | None = None,
                min_width: int = 0) -> tuple[np.ndarray, int]:
    """Per-evidence-slot pair ids for multiple_pods_same_node.

    Joins incident->pod evidence with pod->node SCHEDULED_ON edges and
    assigns each (row, node) pair a ROW-LOCAL id in [0, Wr). Returns
    ``(ev_pair_slot [Pi, W], Wr)`` aligned with the dense evidence table's
    slot layout (the SAME EvidenceLayout object): slot (i, w) holds the
    local pair id of evidence w's node, or Wr when that evidence is not a
    pod-on-a-node. ``min_width`` floors the returned width."""
    pi = snapshot.padded_incidents
    live = snapshot.edge_mask > 0
    src = snapshot.edge_src[live]
    dst = snapshot.edge_dst[live]
    rel = snapshot.edge_rel[live]

    # original direction = pod side is src; reversed duplicates have a Node
    # as src — a vectorized numpy join via a node_of_pod lookup table
    is_sched = rel == int(RelationKind.SCHEDULED_ON)
    pod_side = is_sched & (snapshot.node_kind[src] == int(EntityKind.POD))
    node_of_pod = np.full(snapshot.padded_nodes, -1, dtype=np.int64)
    node_of_pod[src[pod_side]] = dst[pod_side]

    lo = layout or evidence_layout(ev_rows, pi)
    rows_s = lo.rows_s
    dst_s = ev_dst[lo.order]

    node_s = node_of_pod[dst_s] if len(dst_s) else dst_s
    on_node = node_s >= 0
    if on_node.any():
        pair_key = rows_s[on_node].astype(np.int64) << 32 | node_s[on_node]
        uniq, inv = np.unique(pair_key, return_inverse=True)
        pair_row = (uniq >> 32).astype(np.int64)
        per_row = np.bincount(pair_row, minlength=pi)
        wr = bucket_for(max(int(per_row.max()), 1), _PAIR_WIDTH_BUCKETS)
        starts_r = np.concatenate([[0], np.cumsum(per_row)])
        local_of_pair = np.arange(len(uniq)) - starts_r[pair_row]
    else:
        local_of_pair = np.zeros(0, np.int64)
        inv = np.zeros(0, np.int64)
        wr = _PAIR_WIDTH_BUCKETS[0]
    wr = max(wr, min_width)

    ev_pair_slot = np.full((pi, lo.width), wr, dtype=np.int32)  # wr = "no node"
    if len(rows_s) and on_node.any():
        ev_pair_slot[rows_s[on_node], lo.slots[on_node]] = local_of_pair[inv]
    return ev_pair_slot, wr


def prepare_batch(snapshot: GraphSnapshot) -> DeviceBatch:
    """Host-side O(E) prep from a snapshot (pure numpy)."""
    pi = snapshot.padded_incidents
    ev_rows, ev_dst = evidence_coo(snapshot)
    layout = evidence_layout(ev_rows, pi)   # ONE layout for both tables
    ev_idx, ev_cnt = dense_evidence_table(ev_rows, ev_dst, pi, layout=layout)
    ev_pair_slot, pair_width = pair_tables(snapshot, ev_rows, ev_dst,
                                           layout=layout)
    return DeviceBatch(
        num_incidents=snapshot.num_incidents,
        padded_incidents=pi,
        ev_idx=ev_idx,
        ev_cnt=ev_cnt,
        ev_pair_slot=ev_pair_slot,
        pair_width=pair_width,
        features=snapshot.features,
    )


def score_device(features: torch.Tensor, ev_idx: torch.Tensor,
                 ev_cnt: torch.Tensor, ev_pair_slot: torch.Tensor,
                 chain: torch.Tensor, padded_incidents: int,
                 pair_width: int) -> tuple:
    """One scoring pass on the tensors' device: (conds, matched, scores,
    top_idx, any_match, top_conf, top_score), see kernels/rules_fold."""
    if ev_idx.shape[0] != padded_incidents:
        raise ValueError(f"ev_idx has {ev_idx.shape[0]} rows, expected "
                         f"{padded_incidents}")
    return rules_fold(features, ev_idx, ev_cnt, ev_pair_slot, chain,
                      pair_width)


def fetch(tensors) -> tuple[np.ndarray, ...]:
    """Device tensors → host numpy arrays, after one wait for the device."""
    tensors = tuple(tensors)
    if tensors and tensors[0].device.type == "cuda":
        torch.cuda.current_stream(tensors[0].device).synchronize()
    return tuple(t.cpu().numpy() for t in tensors)


class CudaRcaBackend:
    """rca_backend="tpu" — batched scoring over a GraphSnapshot.

    Device tensors are cached per snapshot: re-scoring the same snapshot
    re-uses the resident buffers and skips host prep entirely.
    """

    name = "tpu"

    # result-field groups for the fetch modes of score_snapshot, in the
    # output order of score_device. "top" is the narrowed serving fetch:
    # per-incident verdict fields only — the [Pi, C]/[Pi, R] tables stay
    # on the device.
    _FETCH_FIELDS = {
        "full": ("conditions", "matched", "scores", "top_rule_index",
                 "any_match", "top_confidence", "top_score"),
        "top": ("top_rule_index", "any_match", "top_confidence",
                "top_score"),
    }

    # incident-bucket ladder for the packed cross-tenant pass
    _PACK_BUCKETS = _PACK_BUCKETS_LADDER

    def __init__(self, device: "str | torch.device | None" = None) -> None:
        self.device = resolve_device(device)
        # (snapshot, batch, device args) of the last snapshot loaded, one
        # tuple replaced whole: get_backend shares one instance between
        # the workflow's step threads, so a reader never pairs one
        # snapshot with another's tensors. The snapshot is a strong ref.
        self._cache: tuple | None = None

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _load(self, snapshot: GraphSnapshot) -> tuple[DeviceBatch, tuple, float]:
        cache = self._cache
        if cache is not None and cache[0] is snapshot:
            return cache[1], cache[2], 0.0
        t0 = time.perf_counter()
        batch = prepare_batch(snapshot)
        args = tuple(self._to_device(a) for a in (
            batch.features, batch.ev_idx, batch.ev_cnt, batch.ev_pair_slot))
        self._cache = (snapshot, batch, args)
        return batch, args, time.perf_counter() - t0

    def dispatch(self, snapshot: GraphSnapshot,
                 chain: torch.Tensor | None = None) -> tuple:
        """Enqueue one scoring pass; returns *device* tensors, no host fetch.

        ``chain`` (f32 [padded_incidents]) lets back-to-back passes carry a
        true data dependency: the caller feeds the previous pass's
        top_score back in, and the pass adds ``min(chain, 0)`` to the
        aggregated counts — scores are always >= 0, so the result is
        bit-identical, but no pass can be skipped or reordered."""
        batch, args, _ = self._load(snapshot)
        if chain is None:
            chain = torch.zeros(batch.padded_incidents, dtype=torch.float32,
                                device=self.device)
        return score_device(*args, chain,
                            padded_incidents=batch.padded_incidents,
                            pair_width=batch.pair_width)

    def prepared(self, snapshot: GraphSnapshot) -> DeviceBatch:
        """The (cached) host-prepared batch."""
        batch, _, _ = self._load(snapshot)
        return batch

    def device_arrays(self, snapshot: GraphSnapshot) -> tuple:
        """The (cached) resident device tensors (features, ev_idx, ev_cnt,
        ev_pair_slot) a scoring pass of this snapshot reads."""
        _, args, _ = self._load(snapshot)
        return args

    def score_snapshot(self, snapshot: GraphSnapshot,
                       fields: str = "full") -> dict:
        """Score every incident in the snapshot in one device pass.

        Returns a dict of host numpy arrays keyed by incident order
        (snapshot.incident_ids); use :meth:`results` for model objects
        (which needs the default ``fields="full"``). ``fields="top"``
        fetches only the top-1 verdict fields. Every fetch increments
        ``aiops_serve_fetched_bytes_total`` (path="score_snapshot") with
        the bytes moved."""
        _, _, prep_s = self._load(snapshot)  # dispatch() below hits the cache

        all_fields = self._FETCH_FIELDS["full"]
        keys = self._FETCH_FIELDS[fields]    # KeyError = unknown fetch mode
        t1 = time.perf_counter()
        out = self.dispatch(snapshot)
        dispatch_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        fetched = fetch(out[all_fields.index(k)] for k in keys)
        fetch_s = time.perf_counter() - t2

        obs_metrics.SERVE_FETCHED_BYTES.inc(
            float(sum(a.nbytes for a in fetched)), path="score_snapshot")
        # under a live trace (the workflow's snapshot-verdict path) the
        # pass joins it as a child span with its dispatch/fetch splits,
        # emitted afterwards: no span object inside the timed windows
        obs_scope.emit_stage_span(
            "serve.score_snapshot",
            (("dispatch", dispatch_s), ("fetch", fetch_s)),
            fields=fields, incidents=snapshot.num_incidents)

        # a poisoned feature row must never pass silently as a verdict:
        # this batch path has no delta to quarantine, so it counts, logs
        # and flight-records the signal
        for k, a in zip(keys, fetched):
            if a.dtype.kind == "f" and not np.isfinite(a).all():
                obs_metrics.SHIELD_NONFINITE_VERDICTS.inc(
                    path="score_snapshot")
                log.warning(
                    "nonfinite_verdict_field", field=k)
                obs_scope.FLIGHT_RECORDER.note_event(
                    "nonfinite_verdict_field", field=k,
                    path="score_snapshot")
                break

        n = snapshot.num_incidents
        res = {
            "incident_ids": snapshot.incident_ids,
            "prep_seconds": prep_s,
            "dispatch_seconds": dispatch_s,
            "fetch_seconds": fetch_s,
            "device_seconds": dispatch_s + fetch_s,
            "fetched_fields": fields,
        }
        for k, a in zip(keys, fetched):
            res[k] = a[:n]
        return res

    def score_snapshots(self, snapshots: "list[GraphSnapshot]",
                        fields: str = "top") -> list[dict]:
        """Score k tenants' snapshots in ONE device pass.

        The per-tenant batches pack along the incident axis (padded rows
        concatenated, then padded up the ``_PACK_BUCKETS`` ladder) with
        each tenant's evidence slot indices offset by its feature base.
        Widths and the pair bucket take the max over tenants; the extra
        padded slots lie past each row's count and are never read, so each
        verdict row is bit-identical to that tenant's own
        ``score_snapshot``. One dispatch + one readback in all."""
        if not snapshots:
            return []
        batches = [prepare_batch(s) for s in snapshots]
        width = max(b.ev_idx.shape[1] for b in batches)
        pair_width = max(b.pair_width for b in batches)
        total = sum(b.padded_incidents for b in batches)
        pi = bucket_for(total, self._PACK_BUCKETS)
        features = np.concatenate([b.features for b in batches], axis=0)
        ev_idx = np.zeros((pi, width), np.int32)
        ev_cnt = np.zeros(pi, np.int32)
        ev_pair = np.full((pi, width), pair_width, np.int32)
        slices: list[tuple[int, int]] = []
        row = base = 0
        for b in batches:
            k, w = b.padded_incidents, b.ev_idx.shape[1]
            # slot indices shift into the tenant's feature region
            ev_idx[row:row + k, :w] = b.ev_idx + base
            ev_cnt[row:row + k] = b.ev_cnt
            # re-stamp each tenant's "no node" sentinel to the pack's
            ev_pair[row:row + k, :w] = np.where(
                b.ev_pair_slot >= b.pair_width, pair_width, b.ev_pair_slot)
            slices.append((row, k))
            row += k
            base += b.features.shape[0]
        t1 = time.perf_counter()
        out = score_device(
            self._to_device(features), self._to_device(ev_idx),
            self._to_device(ev_cnt), self._to_device(ev_pair),
            torch.zeros(pi, dtype=torch.float32, device=self.device),
            padded_incidents=pi, pair_width=pair_width)
        dispatch_s = time.perf_counter() - t1
        all_fields = self._FETCH_FIELDS["full"]
        keys = self._FETCH_FIELDS[fields]
        t2 = time.perf_counter()
        fetched = fetch(out[all_fields.index(k)] for k in keys)
        fetch_s = time.perf_counter() - t2
        res: list[dict] = []
        for snap, (r0, _k) in zip(snapshots, slices):
            n = snap.num_incidents
            one = {
                "incident_ids": snap.incident_ids,
                "dispatch_seconds": dispatch_s,
                "fetch_seconds": fetch_s,
                "device_seconds": dispatch_s + fetch_s,
                "fetched_fields": fields,
                "device_passes": 1,
            }
            for k, a in zip(keys, fetched):
                one[k] = a[r0:r0 + n]
            res.append(one)
        return res

    def results(self, snapshot: GraphSnapshot | None = None,
                raw: dict | None = None) -> list[RCAResult]:
        """Materialize RCAResult models (host-side, for the workflow path).

        Accepts either a snapshot to score, or a pre-computed ``raw`` dict —
        e.g. a StreamingScorer.rescore() result, whose keys are identical.
        A NARROWED raw dict (``fields="top"``: no ``matched``/``scores``
        tables) materializes the top hypothesis only."""
        if raw is None:
            if snapshot is None:
                raise ValueError("results() needs a snapshot or a raw dict")
            raw = self.score_snapshot(snapshot)
        narrowed = "matched" not in raw or "scores" not in raw
        out: list[RCAResult] = []
        for i, inc_id in enumerate(raw["incident_ids"]):
            uid = _incident_uuid(inc_id)
            hyps: list[Hypothesis] = []
            if raw["any_match"][i]:
                if narrowed:
                    matched_rules = [
                        (RULES[int(raw["top_rule_index"][i])],
                         float(raw["top_score"][i]))]
                else:
                    matched_rules = [
                        (RULES[r], float(raw["scores"][i, r]))
                        for r in range(NUM_RULES) if raw["matched"][i, r]
                    ]
                matched_rules.sort(key=lambda t: t[1], reverse=True)
                for rank, (rule, score) in enumerate(matched_rules, start=1):
                    hyps.append(Hypothesis(
                        id=uuid4(), incident_id=uid, category=rule.category,
                        title=rule.name, description=rule.description,
                        confidence=rule.confidence, final_score=score, rank=rank,
                        support_count=len(rule.conditions),
                        signal_strength=rule.evidence_strength,
                        recommended_actions=rule.recommended_actions,
                        rule_id=rule.id, backend="tpu",
                        generated_by=HypothesisSource.RULES_ENGINE,
                    ))
            else:
                from .cpu_backend import _unknown_hypothesis
                from .signals import Signals
                h = _unknown_hypothesis(uid, Signals())
                h.backend = "tpu"
                hyps = [h]
            out.append(RCAResult(
                incident_id=uid, hypotheses=hyps, top_hypothesis=hyps[0],
                rules_matched=[h.rule_id for h in hyps if h.rule_id != "unknown"],
                backend="tpu",
            ))
        return out


def _incident_uuid(node_id: str) -> UUID:
    try:
        return UUID(node_id.split(":", 1)[1])
    except (ValueError, IndexError):
        return uuid4()
