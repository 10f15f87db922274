"""Remediation executor — dispatches approved actions to the cluster.

Parity with the reference RemediationExecutor (executor.py:45-307): the same
dispatch table (restart_pod → delete the unhealthy-or-first pod, :86-134;
restart_deployment, :136-175; rollback to previous revision, :177-234;
scale with default current+1 clamped at remediation_max_scale_replicas,
:236-281; cordon, :283-307) — issued through the ClusterAdminBackend
interface, plus a dry-run mode and idempotent execution the reference
lacked.

graft-saga: execution is TWO-PHASE against the durable
``action_executions`` ledger when a Database is supplied. An intent row
(idempotency key + pre-action probe + verification baseline) commits
BEFORE the cluster mutation dispatches; the result row commits after. On
resume, a result row answers the execution from the ledger (the mutation
fired exactly once — never re-dispatched), and an intent WITHOUT a result
is IN-DOUBT: the crash landed between the mutation and the commit, so the
executor RECONCILES by probing cluster state (observed replicas / node
unschedulable / deployment revision / pod health) and only re-fires when
the probe proves the mutation never landed. The legacy in-memory
``_executed_keys`` set remains the dedup for ledgerless callers.
"""
from __future__ import annotations

from typing import Any, Callable

from ..config import Settings, get_settings
from ..models import ActionStatus, ActionType, RemediationAction
from ..observability import get_logger
from ..observability import metrics as obs_metrics
from ..utils.timeutils import utcnow

log = get_logger("remediation.executor")

# action classes for reconciliation/compensation: restart-class mutations
# are convergent (the controller re-creates what was deleted) and their
# compensation is a self-healing no-op
RESTART_CLASS = frozenset({
    ActionType.RESTART_POD, ActionType.DELETE_POD,
    ActionType.RESTART_DEPLOYMENT,
})


class RemediationExecutor:
    def __init__(self, backend: Any, settings: Settings | None = None,
                 db: Any = None,
                 fault_hook: "Callable[[str], None] | None" = None) -> None:
        self.backend = backend
        self.settings = settings or get_settings()
        self.db = db                    # action_executions ledger (storage)
        self.fault_hook = fault_hook    # chaos seam (rca/faults.py)
        self._executed_keys: set[str] = set()
        self.reconciliations = 0
        self._dispatch = {
            ActionType.RESTART_POD: self._restart_pod,
            ActionType.DELETE_POD: self._restart_pod,
            ActionType.RESTART_DEPLOYMENT: self._restart_deployment,
            ActionType.ROLLBACK_DEPLOYMENT: self._rollback_deployment,
            ActionType.SCALE_REPLICAS: self._scale_replicas,
            ActionType.CORDON_NODE: self._cordon_node,
            ActionType.UNCORDON_NODE: self._uncordon_node,
        }

    def _fault(self, stage: str) -> None:
        if self.fault_hook is not None:
            self.fault_hook(stage)

    def execute(self, action: RemediationAction,
                baseline: dict | None = None) -> RemediationAction:
        """Execute (or replay, or reconcile) one action. ``baseline`` is
        the pre-action verification snapshot — persisted into the intent
        row so a resumed run sees the PRE-mutation baseline instead of
        re-probing the already-mutated cluster."""
        handler = self._dispatch.get(action.action_type)
        if handler is None:
            action.status = ActionStatus.SKIPPED
            action.status_reason = f"no executor for {action.action_type.value}"
            return action
        if self.db is not None:
            return self._execute_ledgered(action, handler, baseline)
        if action.idempotency_key in self._executed_keys:
            action.status = ActionStatus.SKIPPED
            action.status_reason = "duplicate idempotency key"
            return action
        # graft-audit: allow[ledger-order] ledger-less mode (db=None): there is no intent store to write; the in-memory idempotency set above dedups within the process
        self._dispatch_one(action, handler)
        self._executed_keys.add(action.idempotency_key)
        return action

    def ledger_baseline(self, action: RemediationAction) -> dict | None:
        """The verification baseline captured when this key's intent was
        journaled (None when no intent exists yet)."""
        if self.db is None:
            return None
        intent = self.db.execution_state(action.idempotency_key)["intent"]
        if intent is None:
            return None
        return intent["detail"].get("baseline")

    # -- two-phase path ----------------------------------------------------

    def _execute_ledgered(self, action: RemediationAction, handler,
                          baseline: dict | None) -> RemediationAction:
        key = action.idempotency_key
        state = self.db.execution_state(key)
        if state["result"] is not None:
            # exactly-once: the mutation already fired and its outcome is
            # durable — adopt the recorded outcome instead of re-firing
            # (a SKIPPED answer here would derail the replayed workflow's
            # verify/close conditions)
            rec = state["result"]
            action.status = ActionStatus(rec["status"])
            action.execution_result = rec["detail"].get("result")
            action.error_message = rec["detail"].get("error")
            action.status_reason = "replayed from action ledger"
            action.completed_at = utcnow()
            obs_metrics.ACTION_DUP_PREVENTED.inc()
            self._executed_keys.add(key)
            return action
        if state["intent"] is not None:
            # IN-DOUBT: intent journaled, no result — the crash landed
            # somewhere between dispatch and commit. Probe, never re-fire
            # blindly.
            return self._reconcile(action, handler, state["intent"])
        # fresh execution: intent (+ probe + baseline) BEFORE dispatch
        detail = {"pre": self._probe(action), "baseline": baseline}
        if action.action_type == ActionType.SCALE_REPLICAS:
            detail["target_replicas"] = self._scale_target(action)
        self.db.execution_intent(key, str(action.id),
                                 str(action.incident_id),
                                 action.action_type.value, detail)
        obs_metrics.ACTION_INTENTS.inc(
            action_type=action.action_type.value)
        self._dispatch_one(action, handler)
        self._fault("wf_execute")  # chaos: crash between mutation and commit
        self.db.execution_result(key, action.status.value, {
            "result": action.execution_result,
            "error": action.error_message,
        })
        self._executed_keys.add(key)
        return action

    def _dispatch_one(self, action: RemediationAction, handler) -> None:
        action.executed_at = utcnow()
        action.status = ActionStatus.EXECUTING
        if self.settings.remediation_dry_run:
            action.status = ActionStatus.COMPLETED
            action.completed_at = utcnow()
            action.execution_result = {"dry_run": True}
            return
        try:
            result = handler(action)
            action.execution_result = result
            action.status = (ActionStatus.COMPLETED if result.get("ok")
                             else ActionStatus.FAILED)
            if not result.get("ok"):
                action.error_message = result.get("error", "action failed")
        except Exception as exc:  # graft-audit: allow[broad-except] action-handler isolation: any failure marks the action FAILED
            action.status = ActionStatus.FAILED
            action.error_message = str(exc)
        action.completed_at = utcnow()

    # -- reconciliation (in-doubt intents) ---------------------------------

    def _probe(self, action: RemediationAction) -> dict:
        """Cluster-state observations reconciliation (and compensation)
        will compare against: replicas, deployment revision/image, node
        schedulability, unhealthy pod names."""
        ns = action.target_namespace
        pre: dict[str, Any] = {}
        try:
            if action.action_type in (ActionType.SCALE_REPLICAS,
                                      ActionType.ROLLBACK_DEPLOYMENT):
                deploys = self.backend.list_deployments(ns,
                                                        action.target_resource)
                if deploys:
                    pre["replicas"] = int(deploys[0].replicas)
                    pre["revision"] = int(getattr(deploys[0], "revision", 0))
                    pre["image"] = getattr(deploys[0], "image", None)
            elif action.action_type in (ActionType.CORDON_NODE,
                                        ActionType.UNCORDON_NODE):
                pre["unschedulable"] = self._node_unschedulable(
                    action.target_resource)
            elif action.action_type in RESTART_CLASS:
                pods = self.backend.list_pods(ns, action.target_resource)
                pre["unhealthy"] = sorted(
                    p.name for p in pods
                    if not p.ready or p.waiting_reason or p.terminated_reason)
        except (AttributeError, KeyError, TypeError, ValueError) as exc:
            pre["probe_error"] = str(exc)
        return pre

    def _node_unschedulable(self, name: str) -> bool | None:
        for node in self.backend.list_nodes():
            if node.name == name:
                return node.conditions.get("Unschedulable") == "True"
        return None

    def _reconcile(self, action: RemediationAction, handler,
                   intent: dict) -> RemediationAction:
        """Settle an in-doubt execution by probing whether the mutation
        landed. Landed → record the completed result (the crash ate only
        the commit). Provably not landed → re-fire ONCE through the
        normal dispatch (recorded as refired). Unknowable → fail the
        action and let compensation/escalation take it; a duplicate
        cluster mutation is the one outcome this path may never produce."""
        pre = intent["detail"].get("pre") or {}
        landed, result = self._probe_landed(action, pre)
        self.reconciliations += 1
        if landed:
            obs_metrics.ACTION_RECONCILED.inc(outcome="completed")
            log.info("action_reconciled_landed",
                     key=action.idempotency_key,
                     action_type=action.action_type.value)
            action.status = ActionStatus.COMPLETED
            action.execution_result = result
            action.completed_at = utcnow()
            action.status_reason = "reconciled: mutation had landed"
            self.db.execution_result(action.idempotency_key,
                                     action.status.value,
                                     {"result": result, "error": None,
                                      "reconciled": "landed"})
            self._executed_keys.add(action.idempotency_key)
            return action
        if landed is None:
            obs_metrics.ACTION_RECONCILED.inc(outcome="failed")
            log.warning("action_reconcile_unknowable",
                        key=action.idempotency_key)
            action.status = ActionStatus.FAILED
            action.error_message = "in-doubt execution not reconcilable"
            action.completed_at = utcnow()
            self.db.execution_result(action.idempotency_key,
                                     action.status.value,
                                     {"result": None,
                                      "error": action.error_message,
                                      "reconciled": "unknowable"})
            self._executed_keys.add(action.idempotency_key)
            return action
        obs_metrics.ACTION_RECONCILED.inc(outcome="refired")
        log.info("action_reconciled_refire", key=action.idempotency_key,
                 action_type=action.action_type.value)
        self._dispatch_one(action, handler)
        self.db.execution_result(action.idempotency_key,
                                 action.status.value,
                                 {"result": action.execution_result,
                                  "error": action.error_message,
                                  "reconciled": "refired"})
        self._executed_keys.add(action.idempotency_key)
        return action

    def _probe_landed(self, action: RemediationAction,
                      pre: dict) -> tuple[bool | None, dict | None]:
        """(landed, equivalent-result). landed=None means the probe could
        not decide (fail safe: no re-fire)."""
        ns = action.target_namespace
        at = action.action_type
        if self.settings.remediation_dry_run:
            return True, {"dry_run": True}
        try:
            if at == ActionType.SCALE_REPLICAS:
                deploys = self.backend.list_deployments(
                    ns, action.target_resource)
                if not deploys or "replicas" not in pre:
                    return None, None
                target = int(action.parameters.get(
                    "replicas", self._clamped(pre["replicas"] + 1)))
                if int(deploys[0].replicas) == target != int(pre["replicas"]):
                    return True, {"ok": True, "replicas": target,
                                  "prev_replicas": int(pre["replicas"])}
                return False, None
            if at == ActionType.CORDON_NODE:
                unsched = self._node_unschedulable(action.target_resource)
                if unsched is None:
                    return None, None
                if unsched and pre.get("unschedulable") is False:
                    return True, {"ok": True,
                                  "cordoned": action.target_resource}
                return (None, None) if pre.get("unschedulable") else \
                    (False, None)
            if at == ActionType.UNCORDON_NODE:
                unsched = self._node_unschedulable(action.target_resource)
                if unsched is None:
                    return None, None
                if not unsched and pre.get("unschedulable") is True:
                    return True, {"ok": True,
                                  "uncordoned": action.target_resource}
                return (None, None) if pre.get("unschedulable") is False \
                    else (False, None)
            if at == ActionType.ROLLBACK_DEPLOYMENT:
                deploys = self.backend.list_deployments(
                    ns, action.target_resource)
                if not deploys or "revision" not in pre:
                    return None, None
                if int(getattr(deploys[0], "revision", 0)) > pre["revision"]:
                    return True, {"ok": True,
                                  "rolled_back": action.target_resource}
                return False, None
            if at in RESTART_CLASS:
                # convergent: landed iff the previously-unhealthy pods
                # healed; a no-heal probe re-fires safely (deleting an
                # already-replaced pod is a no-op at the controller)
                pods = self.backend.list_pods(ns, action.target_resource)
                unhealthy = sorted(
                    p.name for p in pods
                    if not p.ready or p.waiting_reason or p.terminated_reason)
                if pre.get("unhealthy") and not unhealthy:
                    deleted = pre["unhealthy"][0]
                    if at == ActionType.RESTART_DEPLOYMENT:
                        return True, {"ok": True,
                                      "restarted": action.target_resource}
                    return True, {"ok": True, "deleted": deleted}
                return False, None
        except (AttributeError, KeyError, TypeError, ValueError) as exc:
            log.warning("reconcile_probe_failed", error=str(exc))
            return None, None
        return None, None

    # -- handlers ---------------------------------------------------------

    def _restart_pod(self, action: RemediationAction) -> dict:
        ns = action.target_namespace
        pods = self.backend.list_pods(ns, action.target_resource)
        if not pods:
            # target may be a pod name rather than a service
            ok = self.backend.delete_pod(ns, action.target_resource)
            return {"ok": ok, "deleted": action.target_resource if ok else None}
        unhealthy = [p for p in pods if not p.ready or p.waiting_reason
                     or p.terminated_reason]
        victim = (unhealthy or pods)[0]  # unhealthy-or-first (:86-134)
        ok = self.backend.delete_pod(ns, victim.name)
        return {"ok": ok, "deleted": victim.name}

    def _restart_deployment(self, action: RemediationAction) -> dict:
        ok = self.backend.restart_deployment(action.target_namespace,
                                             action.target_resource)
        return {"ok": ok, "restarted": action.target_resource}

    def _rollback_deployment(self, action: RemediationAction) -> dict:
        ok = self.backend.rollback_deployment(action.target_namespace,
                                              action.target_resource)
        return {"ok": ok, "rolled_back": action.target_resource}

    def _clamped(self, target: int) -> int:
        cap = max(int(getattr(self.settings,
                              "remediation_max_scale_replicas", 10)), 1)
        return min(int(target), cap)

    def _scale_target(self, action: RemediationAction) -> int | None:
        deploys = self.backend.list_deployments(action.target_namespace,
                                                action.target_resource)
        if not deploys:
            return None
        return int(action.parameters.get(
            "replicas", self._clamped(deploys[0].replicas + 1)))

    def _scale_replicas(self, action: RemediationAction) -> dict:
        ns = action.target_namespace
        deploys = self.backend.list_deployments(ns, action.target_resource)
        if not deploys:
            return {"ok": False, "error": "deployment not found"}
        prev = int(deploys[0].replicas)
        # default current+1 (:236-281), CLAMPED: an unbounded default let a
        # flapping workflow walk replicas upward one approved action at a
        # time. prev_replicas is recorded for saga compensation.
        target = int(action.parameters.get("replicas",
                                           self._clamped(prev + 1)))
        ok = self.backend.scale_deployment(ns, deploys[0].name, target)
        return {"ok": ok, "replicas": target, "prev_replicas": prev}

    def _cordon_node(self, action: RemediationAction) -> dict:
        ok = self.backend.cordon_node(action.target_resource)
        return {"ok": ok, "cordoned": action.target_resource}

    def _uncordon_node(self, action: RemediationAction) -> dict:
        ok = self.backend.uncordon_node(action.target_resource)
        return {"ok": ok, "uncordoned": action.target_resource}
