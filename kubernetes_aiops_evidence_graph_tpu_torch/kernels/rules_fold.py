"""The rules scoring pass: evidence fold + conditions → rules → top-1.

``rules_fold`` computes, for every padded incident row, the seven outputs
of the JAX package's ``rca/tpu_backend._score_device``: the evidence fold
of ``_aggregate`` (gather of the live ``[Pi, W]`` evidence slots, masked
sum into ``[Pi, DIM]`` counts, per-(row, node) problem-pod counts reduced
to ``per_row_max``) followed by ``finish_scores`` (conditions, all-of rule
matching, constant-folded scores, first-maximal top-1).

On a CUDA tensor it launches ``rules_fold.cu``, one hand-written kernel
that replaces the Pallas rules tail (``experiments/pallas_rules.py::
_rules_kernel``) together with the XLA fold that feeds it: one block of 64
threads per incident row, which reads the row's count, chain, first 64
slots and the rule tables in one round trip, then issues the gathers of a
whole 64-slot chunk before adding them in slot order (one thread per
feature column; the pair histogram bin by bin, each bin's slots in slot
order), and ends in warp 0 with the conditions, rules and first-maximal
top-1. No floating-point atomics, so the same bits on every run. On a CPU
tensor it runs :func:`rules_fold_reference`, the plain PyTorch version,
which the tests hold against the JAX package and ``chip_smoke.py`` holds
the kernel against on the card. There is no fallback from one to the other.

Bound on an H100: bytes. A pass must read each distinct feature row its
live slots gather (``DIM * 4`` bytes a row), the index and pair id of each
live slot, ``ev_cnt`` and ``chain``, and write its outputs
(:func:`bound_bytes`); it does a few adds per gathered value. The kernel
reads only live slots and keeps the counts, the pair histogram and the
whole rules tail on chip, so nothing between the fold and the verdict
touches device memory; its floor is a launch and two dependent round
trips (the row's indices, then the rows). See the ``.cu`` source for what
is left for later.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..graph.schema import DIM, F
from ..ladders import PAIR_WIDTH_BUCKETS
from ..rca.ruleset import (
    Cond,
    MULTIPLE_PODS_THRESHOLD,
    NETWORK_ERRORS_THRESHOLD,
    NUM_CONDS,
    NUM_RULES,
    RULES,
    UNKNOWN_CONFIDENCE,
    UNKNOWN_FINAL_SCORE,
)
from . import _build

# chunk of the slot axis per fold step: bounds the [Pi, chunk, DIM]
# intermediate of the plain version under per-incident skew
_FOLD_CHUNK = 256
# chunk of the pair axis of the one-hot contraction: bounds the
# [Pi, chunk, pair_chunk] intermediate at wide pair buckets
_PAIR_CHUNK = 64

# static rule tensors (host constants)
_RULE_COND = np.zeros((NUM_RULES, NUM_CONDS), dtype=np.float32)
for _i, _r in enumerate(RULES):
    for _c in _r.conditions:
        _RULE_COND[_i, int(_c)] = 1.0
_RULE_REQ = _RULE_COND.sum(axis=1)
_FINAL_SCORES = np.asarray([r.final_score for r in RULES], dtype=np.float32)
_CONFIDENCES = np.asarray([r.confidence for r in RULES], dtype=np.float32)

# The kernel's condition table, the same comparisons as finish_scores:
# each condition sums the listed count columns (PER_ROW_MAX stands for the
# per-row max of the pair histogram), compares the sum with ">" or ">="
# against its threshold, and may negate the result.
PER_ROW_MAX = DIM
_OP_GE, _OP_NEG = 1, 2
_COND_TERMS: dict[Cond, tuple[tuple[int, ...], float, int]] = {
    Cond.WAITING_CRASHLOOP: ((F.W_CRASHLOOPBACKOFF,), 0.0, 0),
    Cond.WAITING_IMAGE_PULL: ((F.W_IMAGEPULLBACKOFF, F.W_ERRIMAGEPULL,
                               F.W_IMAGEINSPECTERROR), 0.0, 0),
    Cond.TERMINATED_OOM: ((F.T_OOMKILLED,), 0.0, 0),
    Cond.TERMINATED_CONFIG: ((F.T_CONTAINERCANNOTRUN,
                              F.T_CREATECONTAINERCONFIGERROR), 0.0, 0),
    Cond.RECENT_DEPLOY: ((F.HAS_RECENT_DEPLOY,), 0.0, 0),
    Cond.NO_RECENT_DEPLOY: ((F.HAS_RECENT_DEPLOY,), 0.0, _OP_NEG),
    Cond.MEMORY_USAGE_HIGH: ((F.MEMORY_USAGE_HIGH,), 0.0, 0),
    Cond.HPA_AT_MAX: ((F.HPA_AT_MAX,), 0.0, 0),
    Cond.LATENCY_HIGH: ((F.LATENCY_HIGH,), 0.0, 0),
    Cond.LOG_PATTERN_NETWORK: ((F.LOG_NETWORK, F.LOG_CONNECTION,
                                F.LOG_TIMEOUT), 0.0, 0),
    Cond.NODE_UNHEALTHY: ((F.NODE_NOT_READY,), 0.0, 0),
    Cond.MULTIPLE_PODS_SAME_NODE: ((PER_ROW_MAX,),
                                   float(MULTIPLE_PODS_THRESHOLD), _OP_GE),
    Cond.POD_NOT_READY: ((F.POD_NOT_READY,), 0.0, 0),
    Cond.READINESS_PROBE_FAILING: ((F.READINESS_PROBE_FAILING,), 0.0, 0),
    Cond.NETWORK_ERRORS_HIGH: ((F.NETWORK_ERROR_COUNT,),
                               float(NETWORK_ERRORS_THRESHOLD), _OP_GE),
}


def kernel_tables() -> dict[str, np.ndarray]:
    """The condition and rule tables the kernel reads, as numpy arrays:
    per condition a bit mask over count columns (bit ``PER_ROW_MAX`` =
    per_row_max), a threshold and an op (bit 0: ``>=`` instead of ``>``,
    bit 1: negate); per rule a bit mask of required conditions, its
    constant score and confidence. The kernel handles at most 32
    conditions and 32 rules (one warp lane each)."""
    if NUM_CONDS > 32 or NUM_RULES > 32:
        raise ValueError("rules_fold handles at most 32 conditions and rules")
    cond_mask = np.zeros(NUM_CONDS, np.int64)
    cond_thresh = np.zeros(NUM_CONDS, np.float32)
    cond_op = np.zeros(NUM_CONDS, np.int32)
    for cond, (cols, thresh, op) in _COND_TERMS.items():
        for col in cols:
            cond_mask[int(cond)] |= 1 << int(col)
        cond_thresh[int(cond)] = thresh
        cond_op[int(cond)] = op
    rule_mask = np.zeros(NUM_RULES, np.int32)
    for i, rule in enumerate(RULES):
        for c in rule.conditions:
            rule_mask[i] |= 1 << int(c)
    return {"cond_mask": cond_mask, "cond_thresh": cond_thresh,
            "cond_op": cond_op, "rule_mask": rule_mask,
            "rule_score": _FINAL_SCORES.copy(),
            "rule_conf": _CONFIDENCES.copy()}


# ---------------------------------------------------------------- plain ----

def pair_contract(problem: torch.Tensor, pslot: torch.Tensor,
                  pair_width: int) -> torch.Tensor:
    """[Pi, C] problem flags × per-slot pair ids → [Pi, pair_width] counts,
    as a one-hot contraction chunked on the pair axis. Ids outside
    ``[0, pair_width)`` (the "no node" sentinel) one-hot to zero rows."""
    def contract(r0: int, n: int) -> torch.Tensor:
        lanes = torch.arange(r0, r0 + n, device=pslot.device,
                             dtype=pslot.dtype)
        onehot = (pslot[..., None] == lanes).to(problem.dtype)
        return torch.einsum("ic,icr->ir", problem, onehot)

    if pair_width <= _PAIR_CHUNK:
        return contract(0, pair_width)
    return torch.cat([contract(r0, _PAIR_CHUNK)
                      for r0 in range(0, pair_width, _PAIR_CHUNK)], dim=1)


def aggregate(features: torch.Tensor, ev_idx: torch.Tensor,
              ev_cnt: torch.Tensor, ev_pair_slot: torch.Tensor,
              pair_width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The evidence fold: (counts [Pi, DIM], per_row_max [Pi]). Slots at
    or past a row's ``ev_cnt`` are masked out, so what they index is
    never summed."""
    pi, width = ev_idx.shape
    dev = features.device
    counts = torch.zeros((pi, features.shape[1]), dtype=torch.float32,
                         device=dev)
    pair = torch.zeros((pi, pair_width), dtype=torch.float32, device=dev)
    for base in range(0, width, _FOLD_CHUNK):
        idx = ev_idx[:, base:base + _FOLD_CHUNK]
        slots = torch.arange(base, base + idx.shape[1], device=dev)
        live = slots[None, :] < ev_cnt[:, None]
        rows = torch.where(live[..., None], features[idx.long()], 0.0)
        counts += rows.sum(dim=1)
        pair += pair_contract(rows[:, :, F.POD_PROBLEM],
                              ev_pair_slot[:, base:base + _FOLD_CHUNK],
                              pair_width)
    return counts, pair.amax(dim=1)


def finish_scores(counts: torch.Tensor, per_row_max: torch.Tensor) -> tuple:
    """counts [Pi, DIM] + per_row_max [Pi] → (conds [Pi, C] bool,
    matched [Pi, R] bool, scores [Pi, R] f32, top_idx [Pi] i32,
    any_match [Pi] bool, top_conf [Pi] f32, top_score [Pi] f32)."""
    c = counts
    dev = c.device
    conds = torch.zeros((c.shape[0], NUM_CONDS), dtype=torch.bool,
                        device=dev)
    conds[:, Cond.WAITING_CRASHLOOP] = c[:, F.W_CRASHLOOPBACKOFF] > 0
    conds[:, Cond.WAITING_IMAGE_PULL] = (
        c[:, F.W_IMAGEPULLBACKOFF] + c[:, F.W_ERRIMAGEPULL]
        + c[:, F.W_IMAGEINSPECTERROR]) > 0
    conds[:, Cond.TERMINATED_OOM] = c[:, F.T_OOMKILLED] > 0
    conds[:, Cond.TERMINATED_CONFIG] = (
        c[:, F.T_CONTAINERCANNOTRUN] + c[:, F.T_CREATECONTAINERCONFIGERROR]) > 0
    recent = c[:, F.HAS_RECENT_DEPLOY] > 0
    conds[:, Cond.RECENT_DEPLOY] = recent
    conds[:, Cond.NO_RECENT_DEPLOY] = ~recent
    conds[:, Cond.MEMORY_USAGE_HIGH] = c[:, F.MEMORY_USAGE_HIGH] > 0
    conds[:, Cond.HPA_AT_MAX] = c[:, F.HPA_AT_MAX] > 0
    conds[:, Cond.LATENCY_HIGH] = c[:, F.LATENCY_HIGH] > 0
    conds[:, Cond.LOG_PATTERN_NETWORK] = (
        c[:, F.LOG_NETWORK] + c[:, F.LOG_CONNECTION] + c[:, F.LOG_TIMEOUT]) > 0
    conds[:, Cond.NODE_UNHEALTHY] = c[:, F.NODE_NOT_READY] > 0
    conds[:, Cond.MULTIPLE_PODS_SAME_NODE] = (
        per_row_max >= MULTIPLE_PODS_THRESHOLD)
    conds[:, Cond.POD_NOT_READY] = c[:, F.POD_NOT_READY] > 0
    conds[:, Cond.READINESS_PROBE_FAILING] = c[:, F.READINESS_PROBE_FAILING] > 0
    conds[:, Cond.NETWORK_ERRORS_HIGH] = (
        c[:, F.NETWORK_ERROR_COUNT] >= NETWORK_ERRORS_THRESHOLD)

    # rule matching: satisfied-required-count == required-count
    rule_cond = torch.from_numpy(_RULE_COND).to(dev)
    sat = conds.to(torch.float32) @ rule_cond.T
    matched = sat >= torch.from_numpy(_RULE_REQ).to(dev)[None, :]
    # constant-folded scores; argmax ties go to the first rule in table
    # order (the CPU oracle's stable sort)
    scores = torch.where(matched, torch.from_numpy(_FINAL_SCORES).to(dev), 0.0)
    any_match = matched.any(dim=1)
    top_idx = torch.argmax(scores, dim=1).to(torch.int32)
    top_score = torch.where(any_match, scores.amax(dim=1), UNKNOWN_FINAL_SCORE)
    top_conf = torch.where(
        any_match, torch.from_numpy(_CONFIDENCES).to(dev)[top_idx.long()],
        UNKNOWN_CONFIDENCE)
    return conds, matched, scores, top_idx, any_match, top_conf, top_score


def rules_fold_reference(features, ev_idx, ev_cnt, ev_pair_slot, chain,
                         pair_width: int) -> tuple:
    """Plain PyTorch version of the kernel (see :func:`rules_fold`)."""
    counts, per_row_max = aggregate(features, ev_idx, ev_cnt, ev_pair_slot,
                                    pair_width)
    counts = counts + torch.clamp(chain, max=0.0)[:, None]
    return finish_scores(counts, per_row_max)


# --------------------------------------------------------------- kernel ----

launches = 0
"""Kernel launches so far; a run resets it to show that its path went
through the kernel. Plain-version calls never count."""

_tables: dict[torch.device, dict[str, torch.Tensor]] = {}
_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("rules_fold")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rules_fold_launch.argtypes = [
            p, i, p, p, p, p, i, i, i, i,      # features .. pod_problem
            p, p, p, i, p, p, p, i, f, f,      # tables .. unknown score
            p, p, p, p, p, p, p, p]            # outputs, stream
        lib.rules_fold_launch.restype = ctypes.c_int
        lib.rules_fold_error_string.argtypes = [ctypes.c_int]
        lib.rules_fold_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _device_tables(device: torch.device) -> dict[str, torch.Tensor]:
    t = _tables.get(device)
    if t is None:
        t = {k: torch.from_numpy(v).to(device)
             for k, v in kernel_tables().items()}
        _tables[device] = t
    return t


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           shape: tuple, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, features on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def rules_fold(features: torch.Tensor, ev_idx: torch.Tensor,
               ev_cnt: torch.Tensor, ev_pair_slot: torch.Tensor,
               chain: torch.Tensor, pair_width: int) -> tuple:
    """One scoring pass over every padded incident row.

    features [Pn, DIM] f32; ev_idx / ev_pair_slot [Pi, W] int32 (row i's
    live slots are the prefix ``w < ev_cnt[i]``; pair ids outside
    ``[0, pair_width)`` mean "no node"); ev_cnt [Pi] int32; chain [Pi]
    f32 (``min(chain, 0)`` is added to every count, see
    ``CudaRcaBackend.dispatch``). Returns (conds [Pi, C] bool, matched
    [Pi, R] bool, scores [Pi, R] f32, top_idx [Pi] int32, any_match [Pi]
    bool, top_conf [Pi] f32, top_score [Pi] f32).

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream (or raise)."""
    global launches
    dev = features.device
    if dev.type == "cpu":
        return rules_fold_reference(features, ev_idx, ev_cnt, ev_pair_slot,
                                    chain, pair_width)
    if dev.type != "cuda":
        raise ValueError(f"rules_fold runs on cuda or cpu, not {dev}")
    pn = features.shape[0]
    pi, width = ev_idx.shape
    _check("features", features, torch.float32, (pn, DIM), dev)
    _check("ev_idx", ev_idx, torch.int32, (pi, width), dev)
    _check("ev_cnt", ev_cnt, torch.int32, (pi,), dev)
    _check("ev_pair_slot", ev_pair_slot, torch.int32, (pi, width), dev)
    _check("chain", chain, torch.float32, (pi,), dev)
    if not 1 <= pair_width <= PAIR_WIDTH_BUCKETS[-1]:
        raise ValueError(f"pair_width {pair_width} outside "
                         f"[1, {PAIR_WIDTH_BUCKETS[-1]}]")
    t = _device_tables(dev)
    conds = torch.empty((pi, NUM_CONDS), dtype=torch.bool, device=dev)
    matched = torch.empty((pi, NUM_RULES), dtype=torch.bool, device=dev)
    scores = torch.empty((pi, NUM_RULES), dtype=torch.float32, device=dev)
    top_idx = torch.empty(pi, dtype=torch.int32, device=dev)
    any_match = torch.empty(pi, dtype=torch.bool, device=dev)
    top_conf = torch.empty(pi, dtype=torch.float32, device=dev)
    top_score = torch.empty(pi, dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.rules_fold_launch(
            features.data_ptr(), pn, ev_idx.data_ptr(), ev_cnt.data_ptr(),
            ev_pair_slot.data_ptr(), chain.data_ptr(), pi, width, pair_width,
            int(F.POD_PROBLEM),
            t["cond_mask"].data_ptr(), t["cond_thresh"].data_ptr(),
            t["cond_op"].data_ptr(), NUM_CONDS,
            t["rule_mask"].data_ptr(), t["rule_score"].data_ptr(),
            t["rule_conf"].data_ptr(), NUM_RULES,
            UNKNOWN_CONFIDENCE, UNKNOWN_FINAL_SCORE,
            conds.data_ptr(), matched.data_ptr(), scores.data_ptr(),
            top_idx.data_ptr(), any_match.data_ptr(), top_conf.data_ptr(),
            top_score.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise _build.KernelError("rules_fold launch failed: "
                           + lib.rules_fold_error_string(rc).decode())
    launches += 1
    return conds, matched, scores, top_idx, any_match, top_conf, top_score


def bound_bytes(ev_idx: np.ndarray, ev_cnt: np.ndarray,
                outputs: bool = True) -> int:
    """Bytes one pass must move at least: each distinct feature row the
    live slots gather, once (incidents that share an entity share its
    row); the index and pair id of each live slot; ev_cnt and chain; and
    (with ``outputs``) the seven outputs once."""
    pi, width = ev_idx.shape
    live = np.arange(width)[None, :] < np.asarray(ev_cnt)[:, None]
    rows = np.unique(ev_idx[live]).size
    n = rows * DIM * 4 + int(live.sum()) * 8 + pi * 8
    if outputs:
        n += pi * (NUM_CONDS + NUM_RULES + NUM_RULES * 4 + 4 + 1 + 4 + 4)
    return n
