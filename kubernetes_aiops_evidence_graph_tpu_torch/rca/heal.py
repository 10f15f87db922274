"""Shard-loss survival for the resident serving state: the parts of the
JAX package's ``rca/heal.py`` that exist on one card.

**Per-shard state attestation** (:func:`attest_fold` / :func:`attest_host`).
A modular-checksum fold over the node-addressed resident tensors, computed
per shard block on the device and compared against the SAME fold of the
host-truth mirrors at snapshot boundaries: silent corruption (the fault
class the whole-state finite guard can only catch after it serves a wrong
verdict) is detected and localized to the block that must be repaired.
One card is one shard (``shards=1``); the fold takes any block count, so
the sharded layout of ROADMAP item 9c reuses it.

The shard-loss classifier (``ShardHealthTracker``), the reshard plan
(``plan_reshard``), the survivor mesh (:func:`survivor_mesh`,
:func:`device_index`) and the shield's live reshard that reads them wait
for multi-device serving, ROADMAP item 9c; the two mesh functions raise
until then.
"""
from __future__ import annotations

import numpy as np
import torch

_MESH_ITEM = ("multi-device serving (parallel/) is not ported yet: "
              "ROADMAP item 9c")


# -- the survivor mesh (ROADMAP item 9c) ---------------------------------

def survivor_mesh(shards: int, exclude: tuple[int, ...] = ()):
    """A ``(1 x shards)`` serving mesh over the survivor devices: a mesh
    is multi-device serving, which is not ported yet."""
    raise NotImplementedError(f"heal.survivor_mesh: {_MESH_ITEM}")


def device_index(device) -> int:
    """Global index of ``device`` in the process device pool, the identity
    a heal's exclusion bookkeeping keys on: mesh-only, not ported yet."""
    raise NotImplementedError(f"heal.device_index: {_MESH_ITEM}")


# -- per-shard state attestation --------------------------------------------

_U32 = 0xFFFFFFFF


def attest_fold(*tensors: torch.Tensor, shards: int) -> torch.Tensor:
    """Per-shard modular checksum of node-addressed resident tensors, on
    their device: float tables viewed as int32 bit for bit (after a cast to
    float32, so a bf16 table folds its float32 value; NaN payloads
    included, so a poisoned block can never checksum clean), every other
    dtype cast to int32; each tensor split into ``shards`` contiguous
    blocks along its flattened order and summed with wraparound mod 2**32
    (in int64, masked: torch has no full uint32 arithmetic). Returns
    ``[num_tensors, shards]`` int64 holding the uint32 sums, which equal
    :func:`attest_host` and the JAX package's ``heal.attest_fold``."""
    sums = []
    for a in tensors:
        if a.dtype.is_floating_point:
            a = a.to(torch.float32).contiguous().view(torch.int32)
        else:
            a = a.to(torch.int32)
        blocks = a.reshape(shards, -1).to(torch.int64) & _U32
        sums.append(blocks.sum(dim=1) & _U32)
    return torch.stack(sums)


def attest_host(arrays, shards: int) -> np.ndarray:
    """Host-side oracle of :func:`attest_fold` over the host-truth
    mirrors — the comparison baseline (the host copies are authoritative
    and bit-identical to the device state by the streaming mirror
    contract, rca/streaming.capture_host_state)."""
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        if a.dtype.kind == "f":
            a = np.ascontiguousarray(a.astype(np.float32)).view(np.int32)
        else:
            a = a.astype(np.int32)
        blocks = a.reshape(shards, -1).astype(np.uint32)
        out.append(blocks.sum(axis=1, dtype=np.uint32))
    return np.stack(out)
