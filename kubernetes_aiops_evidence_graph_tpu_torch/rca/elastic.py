"""Load-driven elastic serving meshes: the decision half.

An :class:`ElasticController` consumes the gauges the tick scope already
exports for every serving pack:

- pipeline occupancy (dispatched-but-unfetched ticks / pipeline depth)
  and stall seconds (time blocked for a pipeline slot),
- the admission layer's shed-ratio EWMA (demand the gate is refusing),
- roofline drift (achieved-bytes/s EWMA against the session high-water
  mark of the pack's tick entry point, ``observability/scope.ROOFLINE``)

and gates D -> D' decisions behind two hysteresis + dwell gates (the
pattern of ``ingestion/admission.StormMode``): sustained pressure for
``elastic_dwell_s`` scales up, sustained calm scales down, and a flapping
signal never flaps the mesh. Every target rides the divisor ladder: D'
divides the pack's ``padded_nodes`` and fits the shield's pool of
positions less the excluded ones. A step re-shards the resident state
through the shield's ``scale_mesh`` after ``prewarm`` built the target
mesh (nothing to compile: a CUDA kernel builds once).

The controller never spawns its own thread: ``observe()`` is called from
whatever cadence the host already has (a worker loop, a harness, a test
with a fake clock).
"""
from __future__ import annotations

import threading
import time

from ..config import get_settings
from ..observability import get_logger
from ..observability import metrics as obs_metrics
from ..observability import scope as obs_scope

log = get_logger("elastic")


class _HysteresisGate:
    """Two-threshold + dwell gate (the StormMode pattern, direction-
    agnostic): ``update(hot)`` feeds one boolean pressure observation and
    returns True once the pressure has been sustained for ``dwell_s``; the
    caller resets by the act of scaling (which changes the signal)."""

    def __init__(self, dwell_s: float, clock=time.monotonic) -> None:
        self.dwell_s = float(dwell_s)
        self._clock = clock
        self._since: float | None = None

    def update(self, hot: bool) -> bool:
        now = self._clock()
        if not hot:
            self._since = None
            return False
        if self._since is None:
            self._since = now
        return now - self._since >= self.dwell_s

    def reset(self) -> None:
        self._since = None


class ElasticController:
    """Load-driven D -> D' scale decisions for ONE shielded serving pack.

    ``observe()`` samples the pack's pressure signals, feeds the up/down
    hysteresis gates, and, when a gate fires and the cooldown has passed,
    pre-warms the target mesh and re-shards through
    ``shield.scale_mesh``. D' must divide ``padded_nodes`` and fit the
    non-excluded devices, so a re-shard is always exact (no re-padding).
    """

    def __init__(self, shield, settings=None, admission=None,
                 clock=time.monotonic) -> None:
        self.settings = settings or get_settings()
        self.shield = shield
        self.admission = admission
        self._clock = clock
        s = self.settings
        self.enabled = bool(s.elastic_enabled)
        self.cooldown_s = float(s.elastic_cooldown_s)
        dwell = float(s.elastic_dwell_s)
        self._up = _HysteresisGate(dwell, clock)
        self._down = _HysteresisGate(dwell, clock)
        self._lock = threading.Lock()
        self._last_scale_t: float | None = None
        self._last_stall = 0.0
        self.scale_ups = 0
        self.scale_downs = 0
        self.decisions = 0

    # -- signals -----------------------------------------------------------

    def signals(self) -> dict:
        """One pressure sample from the pack's existing telemetry: plain
        attribute and EWMA reads, no device sync."""
        sc = self.shield.scorer
        depth = max(int(getattr(sc, "pipeline_depth", 1)), 1)
        occupancy = len(getattr(sc, "_inflight", ())) / depth
        stall_total = float(getattr(sc, "stall_seconds", 0.0))
        stall_delta = max(stall_total - self._last_stall, 0.0)
        self._last_stall = stall_total
        shed = 0.0
        if self.admission is not None:
            shed = float(self.admission.stats().get("shed_ewma", 0.0))
        entry = getattr(sc, "_scope_entry", "streaming.rules_tick")
        pack = getattr(sc, "_scope_pack", "0")
        achieved = obs_scope.ROOFLINE.achieved(entry, pack)
        best = obs_scope.ROOFLINE.best(entry, pack)
        drift = (achieved / best) if best else 0.0
        return {"occupancy": occupancy, "stall_delta_s": stall_delta,
                "shed_ewma": shed, "roofline_drift": drift,
                "shards": int(sc._graph_size())}

    def _hot(self, sig: dict) -> bool:
        s = self.settings
        return (sig["occupancy"] >= float(s.elastic_up_occupancy)
                or sig["shed_ewma"] >= float(s.elastic_up_shed)
                or sig["stall_delta_s"] > 0.0
                or sig["roofline_drift"] >= float(s.elastic_up_roofline))

    def _cold(self, sig: dict) -> bool:
        s = self.settings
        return (sig["occupancy"] <= float(s.elastic_down_occupancy)
                and sig["shed_ewma"] <= float(s.elastic_down_shed)
                and sig["stall_delta_s"] == 0.0
                and (sig["roofline_drift"] <= float(s.elastic_down_roofline)
                     or sig["roofline_drift"] == 0.0))

    # -- the divisor ladder ------------------------------------------------

    def ladder(self) -> tuple[int, ...]:
        """Viable shard counts: divisors of the pack's ``padded_nodes``
        that fit within the shield's pool less its excluded positions,
        ascending."""
        sc = self.shield.scorer
        pn = int(sc.snapshot.padded_nodes)
        avail = len(self.shield.pool) - len(
            getattr(self.shield, "_mesh_excluded", ()))
        return tuple(d for d in range(1, max(avail, 1) + 1)
                     if pn % d == 0)

    def _step(self, direction: int) -> int | None:
        """Next rung of the ladder from the CURRENT shard count (+1 = up,
        -1 = down); None at the ladder's end."""
        rungs = self.ladder()
        cur = int(self.shield.scorer._graph_size())
        if direction > 0:
            bigger = [d for d in rungs if d > cur]
            return bigger[0] if bigger else None
        smaller = [d for d in rungs if d < cur]
        return smaller[-1] if smaller else None

    # -- execution ---------------------------------------------------------

    def prewarm(self, target_shards: int):
        """Build the survivor mesh at the TARGET shard count before the
        scale event, from the shield's pool less its excluded positions,
        and check it can carry the target. The JAX package compiles the
        tick variants here; a CUDA kernel builds once, so nothing else is
        warmed. Returns the mesh (None for one shard)."""
        from . import heal as heal_mod
        excluded = getattr(self.shield, "_mesh_excluded", ())
        mesh = heal_mod.survivor_mesh(int(target_shards), excluded,
                                      self.shield.pool)
        if mesh is None and int(target_shards) > 1:
            raise RuntimeError(f"prewarm: the pool cannot carry "
                               f"{target_shards} shards")
        return mesh

    def _cooled(self, now: float) -> bool:
        return (self._last_scale_t is None
                or now - self._last_scale_t >= self.cooldown_s)

    def observe(self) -> dict:
        """Feed one pressure sample; possibly execute a scale event.
        Returns the decision record (the owning SurgeServer appends a
        non-hold one to the fleet history)."""
        with self._lock:
            self.decisions += 1
            sig = self.signals()
            fire_up = self._up.update(self._hot(sig))
            fire_down = self._down.update(self._cold(sig))
            now = self._clock()
            decision = {"action": "hold", **sig}
            if not self.enabled:
                return decision
            if fire_up and self._cooled(now):
                target = self._step(+1)
                if target is not None:
                    decision = self._scale(target, "up", now, sig)
            elif fire_down and not fire_up and self._cooled(now):
                target = self._step(-1)
                if target is not None:
                    decision = self._scale(target, "down", now, sig)
            return decision

    def _scale(self, target: int, direction: str, now: float,
               sig: dict) -> dict:
        """Caller holds ``self._lock``. Pre-warm, then re-shard through the
        WAL-journaled seam; both gates reset so the next decision needs a
        fresh sustained signal."""
        self.prewarm(target)
        plan = self.shield.scale_mesh(target)
        self._up.reset()
        self._down.reset()
        self._last_scale_t = now
        if plan is None:
            return {"action": "hold", **sig}
        if direction == "up":
            self.scale_ups += 1
        else:
            self.scale_downs += 1
        obs_metrics.ELASTIC_SCALE_DECISIONS.inc(direction=direction)
        log.warning("elastic_scale", direction=direction,
                    from_shards=plan["from_shards"],
                    to_shards=plan["shards"],
                    occupancy=round(sig["occupancy"], 3),
                    shed_ewma=round(sig["shed_ewma"], 4))
        return {"action": f"scale_{direction}", "plan": plan, **sig}

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled,
                    "decisions": self.decisions,
                    "scale_ups": self.scale_ups,
                    "scale_downs": self.scale_downs,
                    "last_scale_t": self._last_scale_t}
