"""Shard-loss survival for the resident serving mesh: the port of the JAX
package's ``rca/heal.py``, four pieces.

1. **Shard-loss classification** (:class:`ShardHealthTracker`). A
   per-mesh-position :class:`~..ingestion.admission.CircuitBreaker`:
   transient device faults reset on the next clean pass (the retry and
   replay rungs handle them), while N consecutive failures localized to
   ONE mesh position open that position's breaker: the "persistently
   failed shard" verdict the shield's ``mesh_heal`` rung keys on.

2. **Reshard planning** (:func:`plan_reshard` / :func:`survivor_mesh`).
   D' is the largest shard count below D that the survivor pool can carry
   and the padded node bucket divides over (the contract
   ``StreamingScorer._graph_sharded`` enforces), so the healed state is
   exactly the state a fresh D' build would shard. D' = 1 is
   single-device serving (mesh ``None``), the graceful floor.

3. **Per-shard state attestation** (:func:`attest_fold` /
   :func:`attest_host`). A modular-checksum fold over the node-addressed
   resident tensors, computed per shard block on the device and compared
   against the SAME fold of the host-truth mirrors at snapshot boundaries:
   silent corruption (the class the whole-state finite guard can only
   catch after it serves a wrong verdict) is detected and localized to
   the block that must be repaired. On a mesh each position folds its own
   block.

4. **Re-expansion.** The failed position's breaker cools down into its
   half-open probe; the shield grows D' back to D and the probe closes the
   breaker on the next clean pass or re-opens it.

**Identity.** A port mesh may put one device at several positions (the
card repeated, or the CPU's host positions), so a ``torch.device`` cannot
name "the dead chip". What the JAX package calls a global device index is
here an index into a POOL, a list of positions: a mesh built from a pool
carries each position's index (``Mesh.pool_index``), :func:`device_index`
reads it, and :func:`survivor_mesh` builds from the pool minus the
excluded indices.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..ingestion.admission import CircuitBreaker
from ..observability import metrics as obs_metrics
from ..observability import scope as obs_scope


# -- reshard planning -------------------------------------------------------

def plan_reshard(padded_nodes: int, shards: int, survivors: int) -> int:
    """Largest viable shard count D' < ``shards``: the survivor pool must
    carry it and the padded node bucket must divide over it. Returns 1
    (single-device serving, mesh ``None``) when no sharded layout
    survives."""
    for d in range(min(int(shards) - 1, int(survivors)), 1, -1):
        if padded_nodes % d == 0:
            return d
    return 1


def survivor_mesh(shards: int, exclude: tuple[int, ...] = (), pool=None):
    """``(1 x shards)`` serving mesh over ``pool`` (default: the CUDA
    devices, ``parallel/mesh.device_pool``) MINUS the excluded pool
    indices, each position naming its pool index. ``None`` when shards
    <= 1 (single-device serving) or the survivors cannot carry the axis.
    Built afresh each call: nothing of the port keys on a mesh object."""
    if shards <= 1:
        return None
    from ..parallel.mesh import Mesh, _grid, device_pool
    pool = list(device_pool() if pool is None else pool)
    dead = {int(i) for i in exclude}
    keep = [i for i in range(len(pool)) if i not in dead][:shards]
    if len(keep) < shards:
        return None
    return Mesh(_grid([pool[i] for i in keep], (1, shards)),
                ("dp", "graph"), pool_index=keep)


def device_index(mesh, pos: int) -> int:
    """Pool index of mesh position ``pos`` (row-major): the stable
    identity health and exclusion bookkeeping key on (positions shift
    across heals; pool indices do not)."""
    return int(mesh.pool_index.reshape(-1)[int(pos)])


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


# -- shard-loss classification ----------------------------------------------

class ShardHealthTracker:
    """Per-mesh-position failure classification over the CircuitBreaker.

    ``record_failure(pos)`` feeds a shard-localized fault into that
    position's breaker: N consecutive failures open it, the "persistently
    failed shard" verdict (:meth:`failed_position`). A clean guarded pass
    resets every live breaker (transient faults never accumulate across
    healthy ticks). On heal, the failed position's breaker moves to the
    EXCLUDED table keyed by its pool index (positions shift with the mesh;
    pool indices do not), where its cooldown gates the re-expansion probe:
    ``can_reexpand()`` is the half-open transition, and after
    :meth:`note_reexpanded` the probing breaker rides the index's new mesh
    position half-open: one more failure re-opens it (immediate re-heal),
    one clean pass closes it."""

    def __init__(self, failure_threshold: int = 3,
                 cooldown_s: float = 5.0) -> None:
        self.failure_threshold = max(int(failure_threshold), 1)
        self.cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()
        self._live: dict[int, CircuitBreaker] = {}       # mesh position
        self._excluded: dict[int, CircuitBreaker] = {}   # pool index
        self.shard_failures = 0

    def _breaker(self, pos: int) -> CircuitBreaker:
        b = self._live.get(pos)
        if b is None:
            b = self._live[pos] = CircuitBreaker(
                f"mesh_shard_{pos}",
                failure_threshold=self.failure_threshold,
                cooldown_s=self.cooldown_s)
        return b

    def record_failure(self, pos: int) -> str:
        """One shard-localized fault at mesh position ``pos``; returns the
        breaker state after recording (``open`` = classified)."""
        pos = int(pos)
        with self._lock:
            b = self._breaker(pos)
        b.record_failure()
        self.shard_failures += 1
        obs_metrics.MESH_SHARD_FAILURES.inc(shard=str(pos))
        obs_metrics.MESH_SHARD_HEALTH.set(
            0.0 if b.state == "open" else 1.0, shard=str(pos))
        obs_scope.FLIGHT_RECORDER.note_event(
            "shard_fault", shard=pos, state=b.state, failures=b.failures)
        return b.state

    def record_clean_pass(self) -> None:
        """A guarded pass with zero failures: consecutive-failure counts
        reset (transient is not persistent), half-open probes close, and
        fully healthy breakers are pruned."""
        with self._lock:
            live = list(self._live.items())
        for pos, b in live:
            closing = b.state == "half_open"
            b.record_success()
            obs_metrics.MESH_SHARD_HEALTH.set(1.0, shard=str(pos))
            if closing:
                obs_scope.FLIGHT_RECORDER.note_event(
                    "shard_probe_closed", shard=pos)
            with self._lock:
                if b.state == "closed" and b.failures == 0:
                    self._live.pop(pos, None)

    def failed_position(self, exclude: tuple[int, ...] = ()) -> "int | None":
        """First mesh position classified as persistently failed (breaker
        open), skipping positions in ``exclude``."""
        with self._lock:
            for pos in sorted(self._live):
                if pos in exclude:
                    continue
                if self._live[pos].state == "open":
                    return pos
        return None

    def exclude(self, pos: int, dev_idx: int) -> None:
        """Heal applied: move the failed position's breaker to the excluded
        table under its pool index and reset the live position space
        (positions shift with the new mesh)."""
        with self._lock:
            b = self._live.pop(int(pos), None)
            self._live.clear()
            if b is None:
                b = CircuitBreaker(
                    f"mesh_device_{dev_idx}",
                    failure_threshold=self.failure_threshold,
                    cooldown_s=self.cooldown_s)
                for _ in range(self.failure_threshold):
                    b.record_failure()
            self._excluded[int(dev_idx)] = b
        obs_metrics.MESH_SHARD_HEALTH.set(0.0, shard=str(dev_idx))

    def excluded_devices(self) -> tuple[int, ...]:
        with self._lock:
            return tuple(sorted(self._excluded))

    def can_reexpand(self) -> bool:
        """True when EVERY excluded index's breaker admits its half-open
        probe (cooldown elapsed): the re-expansion gate. A breaker already
        half-open (its probe admitted on an earlier poll that another
        index vetoed) counts as ready."""
        with self._lock:
            excluded = list(self._excluded.values())
        return bool(excluded) and all(
            b.state == "half_open" or b.allow() for b in excluded)

    def note_reexpanded(self, dev_to_pos: dict[int, int]) -> None:
        """Re-expansion applied: the probing breakers ride their indices'
        new mesh positions half-open."""
        with self._lock:
            for dev, b in list(self._excluded.items()):
                pos = dev_to_pos.get(dev)
                if pos is not None:
                    self._live[pos] = b
            self._excluded.clear()

    def stats(self) -> dict:
        with self._lock:
            return {
                "live": {p: b.state for p, b in self._live.items()},
                "excluded": {d: b.state for d, b in self._excluded.items()},
                "shard_failures": self.shard_failures,
            }
