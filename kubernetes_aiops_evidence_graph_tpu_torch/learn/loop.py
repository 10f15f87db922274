"""OnlineLearner — the loop that turns production verdicts into swapped
checkpoints.

The port of the JAX package's ``learn/loop.py``. One cycle (``run_once``):

1. **Harvest**: pull labels from the durable store (episodes.py), build
   one episode per attached tenant store, dedup into the replay buffer.
   Every ``learn_holdout_every``-th new episode is HELD OUT — it joins
   the gate's production holdout slice and never trains.
2. **Train**: fine-tune a candidate from the live serving params (on the
   scorer's device: the card by default) over the interleaved
   production/simulator schedule (trainer.py).
3. **Gate**: candidate holdout top-1 (simulator suite + held production
   slice) must be >= the serving params' on the same holdout, and every
   leaf finite. Failures are discarded and counted, never swapped.
4. **Swap**: hot swap into EVERY attached scorer atomically
   (``rca/surge.swap_tenants_atomically``, ordered ``serve_lock``
   acquisition). In-flight ticks complete on the old generation.
5. **Watch**: the next cycle rolls back to the previous generation if
   the serving stack surfaced non-finite verdicts
   (``aiops_shield_nonfinite_verdicts_total{path="shield"}``) or a target
   quarantined batches since the swap (counted in
   ``aiops_learn_rollbacks_total``, and a ``params_rollback`` event in the
   flight ring).

A ``FaultInjector`` (rca/faults.py) passed as ``injector`` fires at the
``harvest`` and ``swap`` stages: a faulted cycle is contained, with the
serving params and generation untouched. A target wrapped in the crash
shield (rca/shield.py) journals each swap before it applies.

The gate sets ``aiops_learn_eval_top1`` and counts
``aiops_learn_gate_rejects_total``; the fine-tune counts its steps
(``learn/trainer.py``) and the replay buffer its size and harvested
episodes (``learn/episodes.py``); the swap counts itself where it
applies (``rca/surge.py``, ``rca/gnn_streaming.py``). The learner's own
counters (``cycles``, ``swaps``, ``rollbacks``, ``gate_rejects``) are
here too.
"""
from __future__ import annotations

import logging
import threading

from ..config import Settings, get_settings
from ..observability import metrics as obs_metrics
from ..observability import scope as obs_scope
from .episodes import (ReplayBuffer, build_episode, build_replay_episode,
                       harvest_labels)
from .trainer import finetune, gate_eval, params_finite

log = logging.getLogger(__name__)


class OnlineLearner:
    """See module docstring. ``targets`` are resident GNN scorers — one per
    tenant; all swap atomically. ``db`` is the shared durable store the
    labels come from."""

    def __init__(self, db, targets, settings: "Settings | None" = None,
                 now_s: "float | None" = None, injector=None) -> None:
        self.settings = settings or get_settings()
        self.db = db
        # chaos seam (rca/faults.py LEARN_STAGES): the harvest/swap hooks
        # prove a faulted learn cycle is CONTAINED
        self.injector = injector
        # stable order — the atomic swap's deadlock-freedom rests on
        # every swapper acquiring serve_locks in one canonical order
        self.targets = list(targets if isinstance(targets, (list, tuple))
                            else [targets])
        if not self.targets:
            raise ValueError("OnlineLearner needs >= 1 serving scorer")
        self.now_s = now_s
        self.buffer = ReplayBuffer(cap=int(self.settings.learn_buffer_cap))
        self.prod_holdout: list[dict] = []
        self._holdout_counter = 0
        self._sim_train: "list | None" = None
        self._sim_holdout: "list | None" = None
        self.cycles = 0
        self.swaps = 0
        self.rollbacks = 0
        self.gate_rejects = 0
        self.last_eval: dict = {}
        self.last_cycle: dict = {}
        self._health_mark: "dict | None" = None
        self._thread: "threading.Thread | None" = None
        self._stop = threading.Event()
        self.running = False

    # -- wiring ------------------------------------------------------------

    def _scorer(self, t):
        return getattr(t, "scorer", t)   # unwrap a shielded scorer

    def _stores(self):
        for t in self.targets:
            s = self._scorer(t)
            name = getattr(t, "tenant", None) or "default"
            yield name, s.store, s

    @property
    def generation(self) -> int:
        return max(int(getattr(self._scorer(t), "params_generation", 0))
                   for t in self.targets)

    def serving_params(self):
        return self._scorer(self.targets[0])._params

    # -- simulator suites (anti-forgetting mix + gate holdout) -------------

    def _sim_episodes(self) -> tuple[list, list]:
        if self._sim_train is None:
            from ..rca.train import make_dataset
            cfg = self.settings
            n = int(cfg.learn_sim_episodes) + int(cfg.learn_sim_holdout)
            data = make_dataset(
                max(n, 1), num_pods=int(cfg.learn_sim_pods),
                num_incidents=int(cfg.learn_sim_incidents), seed=1717,
                return_snapshot=True)
            cut = int(cfg.learn_sim_episodes)
            self._sim_train = data[:cut]
            self._sim_holdout = data[cut:] or data[:1]
        return self._sim_train, self._sim_holdout

    # -- the cycle ---------------------------------------------------------

    def harvest(self) -> int:
        """Labels → episodes → buffer/holdout. Live windows build from
        each tenant's evidence-graph store; incidents the workflow has
        already CLOSED replay from their persisted evidence instead
        (build_replay_episode). Returns the number of NEW (non-duplicate)
        episodes absorbed."""
        if self.injector is not None:
            self.injector.at("harvest")
        labels = harvest_labels(
            self.db, weak=bool(self.settings.learn_weak_labels),
            weak_confidence=float(self.settings.learn_weak_confidence))
        if not labels:
            return 0
        fresh = 0
        live_covered: set[str] = set()
        episodes: list[dict] = []
        for tenant, store, scorer in self._stores():
            now_s = (self.now_s if self.now_s is not None
                     else getattr(scorer, "now_s", None))
            live = {iid for iid in labels
                    if store.get_node(f"incident:{iid}") is not None}
            live_covered |= live
            if live:
                ep = build_episode(store,
                                   {i: labels[i] for i in live},
                                   self.settings, now_s=now_s,
                                   tenant=tenant)
                if ep is not None:
                    episodes.append(ep)
        closed = {i: labels[i] for i in labels if i not in live_covered}
        if closed:
            ep = build_replay_episode(self.db, closed, self.settings,
                                      now_s=self.now_s)
            if ep is not None:
                episodes.append(ep)
        for ep in episodes:
            # an episode already training OR held out must not re-enter
            # through the other door: the gate would grade the candidate
            # on its own training data
            if ep["fingerprint"] in self.buffer or any(
                    ep["fingerprint"] == h["fingerprint"]
                    for h in self.prod_holdout):
                self.buffer.duplicates += 1
                continue
            self._holdout_counter += 1
            every = max(int(self.settings.learn_holdout_every), 0)
            if every and self._holdout_counter % every == 0:
                self.prod_holdout.append(ep)
                del self.prod_holdout[:-16]   # bounded holdout slice
                fresh += 1
            else:
                fresh += int(self.buffer.add(ep))
        return fresh

    def _holdout(self) -> list:
        _, sim_hold = self._sim_episodes()
        return list(sim_hold) + list(self.prod_holdout)

    def train_candidate(self) -> dict:
        sim_train, _ = self._sim_episodes()
        return finetune(
            self.serving_params(), self.buffer.episodes(), sim_train,
            steps=int(self.settings.learn_steps),
            lr=float(self.settings.learn_lr),
            anchor_weight=float(self.settings.learn_anchor_weight),
            mesh_shards=int(self.settings.learn_mesh_shards),
            pallas_grads=bool(self.settings.learn_pallas_grads))

    def gate(self, candidate) -> tuple[bool, dict]:
        """(passes, evals). The candidate must be finite AND match-or-beat
        the serving params on the shared holdout."""
        holdout = self._holdout()
        cand = gate_eval(candidate, holdout) if holdout else 0.0
        serve = gate_eval(self.serving_params(), holdout) if holdout else 0.0
        finite = params_finite(candidate)
        evals = {"candidate_top1": cand, "serving_top1": serve,
                 "holdout_episodes": len(holdout), "finite": finite}
        self.last_eval = evals
        obs_metrics.LEARN_EVAL_TOP1.set(cand, params="candidate")
        obs_metrics.LEARN_EVAL_TOP1.set(serve, params="serving")
        ok = finite and bool(holdout) and cand >= serve
        if not ok:
            self.gate_rejects += 1
            obs_metrics.LEARN_GATE_REJECTS.inc()
            log.warning("learn gate rejected the candidate: %s", evals)
        return ok, evals

    def swap(self, params, source: str = "finetune") -> int:
        """Atomic hot swap into every target (see module docstring);
        arms the post-swap health watch."""
        if self.injector is not None:
            # fires BEFORE any target swaps: a faulted swap leaves every
            # tenant on the old generation
            self.injector.at("swap")
        from ..rca.surge import swap_tenants_atomically
        gen = swap_tenants_atomically(self.targets, params, source=source)
        self.swaps += 1
        self._health_mark = self._health_counters()
        log.info("learn swapped to generation %d on %d target(s)", gen,
                 len(self.targets))
        return gen

    def _health_counters(self) -> dict:
        """Post-swap regression signals: non-finite verdicts and
        quarantines observed by the serving stack since the swap."""
        out = {"nonfinite": obs_metrics.SHIELD_NONFINITE_VERDICTS.value(
            path="shield")}
        for i, t in enumerate(self.targets):
            out[f"quarantined_{i}"] = int(
                getattr(t, "quarantined_batches", 0))
        return out

    def maybe_rollback(self) -> bool:
        """Roll back to the previous generation when the serving stack
        surfaced poison since the last swap. Cheap (counter compares);
        called at the top of every cycle and safe to call ad hoc."""
        if self._health_mark is None:
            return False
        now = self._health_counters()
        if all(now[k] <= v for k, v in self._health_mark.items()):
            return False
        self._health_mark = None
        gens = []
        for t in self.targets:
            rb = getattr(t, "rollback_params", None)
            if rb is not None:
                gen = rb()
                if gen is not None:
                    gens.append(gen)
        if not gens:
            # the shield's own params_rollback rung already healed it (or
            # there was never a previous generation to restore)
            return False
        self.rollbacks += 1
        obs_scope.FLIGHT_RECORDER.note_event(
            "params_rollback", generations=gens)
        log.error("learn rolled back to generations %s", gens)
        return True

    def run_once(self) -> dict:
        """One synchronous cycle; the background thread calls this on the
        ``learn_interval_s`` cadence."""
        self.cycles += 1
        out: dict = {"cycle": self.cycles, "swapped": False,
                     "rolled_back": False, "trained": False}
        out["rolled_back"] = self.maybe_rollback()
        out["harvested"] = self.harvest()
        out["buffer"] = len(self.buffer)
        if len(self.buffer) < max(int(self.settings.learn_min_episodes), 1):
            self.last_cycle = out
            return out
        result = self.train_candidate()
        out["trained"] = True
        out["train_steps"] = result["steps"]
        out["final_loss"] = result["final_loss"]
        ok, evals = self.gate(result["params"])
        out["gate"] = evals
        if ok:
            out["generation"] = self.swap(result["params"])
            out["swapped"] = True
        self.last_cycle = out
        return out

    # -- background thread -------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self.running = True
        # non-daemon: stop() bounds shutdown to one in-flight cycle
        self._thread = threading.Thread(target=self._loop,
                                        name="kaeg-learn", daemon=False)
        self._thread.start()

    def _loop(self) -> None:
        interval = max(float(self.settings.learn_interval_s), 0.5)
        while not self._stop.is_set():
            try:
                self.run_once()
            except Exception:  # graft-audit: allow[broad-except] per-cycle isolation: one failed learn cycle must not kill the loop thread; serving is untouched (candidates only reach it through the gate)
                log.exception("learn cycle failed")
            self._stop.wait(interval)
        self.running = False

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join()
        self._thread = None
        self.running = False

    # -- inspection --------------------------------------------------------

    def status(self) -> dict:
        return {
            "running": self.running,
            "generation": self.generation,
            "buffer_size": len(self.buffer),
            "buffer_duplicates": self.buffer.duplicates,
            "prod_holdout": len(self.prod_holdout),
            "cycles": self.cycles,
            "swaps": self.swaps,
            "rollbacks": self.rollbacks,
            "gate_rejects": self.gate_rejects,
            "last_eval": self.last_eval,
            "last_cycle": {k: v for k, v in self.last_cycle.items()
                           if k != "gate"},
            "tenants": len(self.targets),
        }
