"""The 12-step incident workflow.

Step-for-step parity with the reference IncidentWorkflow
(incident_workflow.py:19-31 docstring, :55-292 body) and its activities
(activities.py:25-363), with the reference's timeout budget:

 1 collect_evidence   5m   collectors (actually parallel) + persist
 2 build_graph        2m   batch ingest into the in-memory store
 3 generate_hypotheses 3m  rca_backend plugin (cpu|tpu) + optional LLM
 4 rank_hypotheses    30s  (constant-folded; recorded for parity)
 5 generate_runbook   30s
 6 calculate_blast_radius 30s
 7 evaluate_policy    30s  proposes the top hypothesis' MACHINE action —
                           never prose (fixes SURVEY.md §3.6 item 6)
 8 request_approval   4h   dev auto-approve; else ApprovalBroker (real
                           response path, unlike the reference's stub)
 9 execute_remediation 5m
10 verify_remediation 2m wait + 2m verify
11 create_ticket      30s  iff not allowed or verification failed
12 close_incident     30s  resolved/closed by verification outcome

The port's copy of the JAX package's workflow. Its scoring seams run on
the port's scorers on an explicit device (``run_incident_workflow``'s
``device``, the worker's): the resident ``StreamingScorer`` (rules,
kernels/rules_fold) or ``GnnStreamingScorer`` (learned, kernels/gms and
the serving ticks) at the verdict boundary, and ``get_backend(name,
device=ctx.device)`` on the snapshot path.
"""
from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Any

from ..collectors import collect_all, default_collectors
from ..config import Settings, get_settings
from ..device import resolve_device
from ..graph import GraphBuilder, build_snapshot
from ..integrations import JiraClient, SlackClient
from ..models import (
    ActionStatus,
    ApprovalRequest,
    Hypothesis,
    HypothesisCategory,
    HypothesisSource,
    Incident,
    IncidentStatus,
    RemediationAction,
)
from ..observability import (
    HYPOTHESES_GENERATED,
    INCIDENTS_RESOLVED,
    RCA_DURATION,
    REMEDIATION_ATTEMPTS,
    get_logger,
)
from ..rca import get_backend
from ..rca.llm import LLMSummarizer
from ..remediation import (
    RemediationCompensator,
    RemediationExecutor,
    RemediationOrchestrator,
    RemediationVerifier,
)
from ..runbook import RunbookGenerator
from ..storage import Database
from ..utils.timeutils import utcnow
from .engine import Step, StepFailed, WorkflowEngine, WorkflowFenced

log = get_logger("incident_workflow")


@dataclass
class IncidentContext:
    """Everything a workflow run needs; results accumulate per step."""
    incident: Incident
    cluster: Any                       # ClusterBackend (+ admin surface)
    db: Database
    builder: GraphBuilder
    settings: Settings = field(default_factory=get_settings)
    results: dict[str, Any] = field(default_factory=dict)
    # transient (not journal-serialized; rehydrated from DB on replay)
    evidence_dicts: list[dict] = field(default_factory=list)
    hypotheses: list[Hypothesis] = field(default_factory=list)
    scorer: Any = None                 # resident StreamingScorer (serving path)
    tenant: str = "default"            # graft-surge: this incident's tenant
    #                                    (names its region on a multi-tenant
    #                                    pack; SLO samples carry the label)
    action: RemediationAction | None = None
    baseline: dict = field(default_factory=dict)
    slack: SlackClient | None = None
    jira: JiraClient | None = None
    dedup: Any = None  # AlertDeduplicator; fingerprint released on close
    # graft-saga chaos seam: a rca/faults.FaultInjector whose lifecycle
    # hooks (collect | journal_put | wf_execute | verify | compensate |
    # crash_restart) fire at the stage boundaries below
    faults: Any = None
    # the device the scorers run on (resolved by run_incident_workflow)
    device: Any = None


def _fault(ctx: IncidentContext, stage: str) -> None:
    if ctx.faults is not None:
        ctx.faults.at(stage)


def _ensure_hypotheses(ctx: IncidentContext) -> list[Hypothesis]:
    """Rehydrate hypotheses from storage after a journal replay skipped
    generate_hypotheses (resume-after-crash durability)."""
    if ctx.hypotheses:
        return ctx.hypotheses
    rows = ctx.db.hypotheses_for(ctx.incident.id)
    ctx.hypotheses = [
        Hypothesis.model_validate(dict(
            id=r["id"], incident_id=r["incident_id"],
            category=HypothesisCategory(r["category"]), title=r["title"],
            description=r["description"] or "", confidence=r["confidence"],
            rank=r["rank"], final_score=r["final_score"], rule_id=r["rule_id"],
            backend=r["backend"],
            recommended_actions=r["recommended_actions"],
            generated_by=HypothesisSource(r["generated_by"]),
        )) for r in rows
    ]
    return ctx.hypotheses


def _ensure_action(ctx: IncidentContext) -> RemediationAction | None:
    """Rehydrate the proposed action from storage after replay."""
    if ctx.action is not None:
        return ctx.action
    rows = ctx.db.actions_for(ctx.incident.id)
    if not rows:
        return None
    import json as _json
    # compensation rows ride the same table under suffixed idempotency
    # keys — the WORKFLOW action is the newest non-derived row
    primary = [r for r in rows
               if ":" not in (r["idempotency_key"] or "")] or rows
    r = primary[-1]
    ctx.action = RemediationAction.model_validate(dict(
        id=r["id"], incident_id=r["incident_id"],
        hypothesis_id=r["hypothesis_id"],
        idempotency_key=r["idempotency_key"],
        action_type=r["action_type"], target_resource=r["target_resource"],
        target_namespace=r["target_namespace"],
        # parameters + execution_result were dropped by the pre-saga
        # rehydration — compensation needs prev_replicas and the executor
        # needs the requested replica target, so a replayed context must
        # carry both
        parameters=_json.loads(r["parameters"] or "{}"),
        risk_level=r["risk_level"],
        blast_radius_score=r["blast_radius_score"],
        environment=r["environment"], status=ActionStatus(r["status"]),
        status_reason=r["status_reason"],
        requires_approval=bool(r["requires_approval"]),
        approved_by=r["approved_by"],
        execution_result=(_json.loads(r["execution_result"])
                          if r["execution_result"] else None),
        error_message=r["error_message"],
    ))
    return ctx.action


# -- step implementations (activities.py analogs) --------------------------

def collect_evidence(ctx: IncidentContext) -> dict:
    _fault(ctx, "collect")
    collectors = default_collectors(ctx.cluster, ctx.settings)
    results = collect_all(ctx.incident, collectors, parallel=True)
    all_ev = [e for r in results for e in r.evidence]
    ctx.db.insert_evidence(all_ev)  # one batch, not per-row (activities.py:61-84)
    ctx.evidence_dicts = [e.model_dump(mode="json") for e in all_ev]
    ctx.results["_collector_results"] = results  # for build_graph (in-memory)
    return {
        "evidence_count": len(all_ev),
        "collectors": {r.collector_name: r.success for r in results},
        "errors": [err for r in results for err in r.errors],
        # graft-saga replay fidelity: the collector-emitted graph payload
        # (topology entities/relations) existed only in memory, so a
        # crash after this step rebuilt a THINNER graph than the original
        # run saw — journal it with the step so build_graph's replay
        # re-ingests the exact same graph (bounded: collectors only emit
        # this incident's service/namespace neighborhood)
        "graph": {
            "entities": [e.model_dump(mode="json")
                         for r in results for e in r.entities],
            "relations": [rel.model_dump(mode="json")
                          for r in results for rel in r.relations],
        },
    }


def build_graph(ctx: IncidentContext) -> dict:
    results = ctx.results.pop("_collector_results", None)
    if results is None:  # replayed run: rebuild from persisted evidence
        from ..models import (
            CollectorResult, Evidence, GraphEntity, GraphRelation)
        known = Evidence.model_fields
        evs = [Evidence.model_validate({k: v for k, v in row.items()
                                        if k in known})
               for row in _evidence_rows(ctx)]
        graph = (ctx.results.get("collect_evidence") or {}).get("graph") or {}
        results = [CollectorResult(
            collector_name="replay", evidence=evs,
            entities=[GraphEntity.model_validate(d)
                      for d in graph.get("entities", [])],
            relations=[GraphRelation.model_validate(d)
                       for d in graph.get("relations", [])])]
    stats = ctx.builder.ingest(ctx.incident, results)
    out = {k: v for k, v in stats.items() if k != "incident_node"}
    # graft-surge: feed the webhook's delta batch into the resident
    # scorer's bounded tick_async queue RIGHT HERE — the device executes
    # (or coalesces, under burst) while the workflow's host steps
    # continue, and generate_hypotheses later pays only a deferred
    # newest-tick fetch instead of a synchronous dispatch+fetch
    # round-trip. absorb() is non-blocking (journal drain + jit enqueue);
    # this step already runs on an executor thread.
    if ctx.scorer is not None and hasattr(ctx.scorer, "absorb"):
        try:
            tick = ctx.scorer.absorb()
            out["absorbed"] = bool(tick.get("dispatched")
                                   or tick.get("coalesced"))
        except Exception as exc:  # graft-audit: allow[broad-except] advisory pre-tick: the verdict boundary re-syncs, and a poisoned absorb must not fail graph ingest
            log.warning("absorb_failed", incident=str(ctx.incident.id),
                        error=str(exc))
            out["absorbed"] = False
    return out


def _evidence_rows(ctx: IncidentContext) -> list[dict]:
    rows = ctx.db.evidence_for(ctx.incident.id)
    for r in rows:
        r.setdefault("incident_id", str(ctx.incident.id))
    return rows


def _ensure_evidence(ctx: IncidentContext) -> list[dict]:
    """Rehydrate evidence dicts from storage after a journal replay (the
    transient ctx.evidence_dicts dies with the crashed worker; runbooks
    and tickets generated on the resumed run must see the same evidence
    the original run saw)."""
    if not ctx.evidence_dicts:
        ctx.evidence_dicts = _evidence_rows(ctx)
    return ctx.evidence_dicts


def _streaming_hypotheses(ctx: IncidentContext,
                          backend_name: str) -> list[Hypothesis] | None:
    """Score via the resident scorer: journal sync + fused tick — no
    per-incident snapshot rebuild (VERDICT r2 item 2; replaces the
    reference's per-incident collect→Cypher→score, activities.py:26-164).
    One protocol for both resident backends — rules (StreamingScorer) and
    learned (GnnStreamingScorer, VERDICT r4 ask 2): serve() coalesces
    concurrent callers onto shared ticks, the batched raw dict contains
    every live incident's row, and only the row-slice keys differ per
    backend. None = incident not in the graph, caller falls back to the
    snapshot path.

    graft-surge: ``serve(newest=True)`` makes this the ASYNC verdict
    boundary — build_graph already absorbed the webhook deltas into the
    pipelined tick queue, so in steady state the generation fetches the
    newest in-flight tick's result (one readback, zero fresh dispatches)
    instead of a synchronous per-incident rescore round-trip. On a
    multi-tenant pack (rca/surge.MultiTenantScorer) the same call serves
    EVERY tenant's concurrent incidents from one device pass; this
    incident's row is addressed by its tenant-namespaced slot id and
    sliced back to the local id for results()."""
    nid = f"incident:{ctx.incident.id}"
    sid = ctx.scorer.serving_node_id(nid, tenant=ctx.tenant)
    raw = ctx.scorer.serve(newest=True)
    try:
        i = raw["incident_ids"].index(sid)
    except ValueError:
        return None
    # key off the RESULT surface, not the configured backend: a
    # checkpoint-unusable worker serves rca_backend=gnn from the rules
    # tier (worker._build_gnn_scorer), whose raw dict carries
    # matched/scores instead of probs — slicing must follow the verdict
    # that was actually produced
    if backend_name == "gnn" and "probs" in raw:
        one = {"incident_ids": [nid], "probs": raw["probs"][i:i + 1]}
        return get_backend("gnn", device=ctx.device).results(
            None, raw=one)[0].hypotheses
    one = {  # slice this incident's row; results() is row-wise
        "incident_ids": [nid],
        "matched": raw["matched"][i:i + 1],
        "scores": raw["scores"][i:i + 1],
        "any_match": raw["any_match"][i:i + 1],
    }
    return get_backend("tpu", device=ctx.device).results(
        raw=one)[0].hypotheses


def generate_hypotheses(ctx: IncidentContext) -> dict:
    import time as _t
    t0 = _t.perf_counter()
    backend_name = ctx.settings.rca_backend
    mode = backend_name
    hyps = None
    if backend_name in ("tpu", "gnn") and ctx.scorer is not None:
        hyps = _streaming_hypotheses(ctx, backend_name)
        if hyps is not None:
            mode = "streaming"
    if hyps is None:
        if backend_name in ("tpu", "gnn"):   # snapshot-scoring backends
            snapshot = build_snapshot(ctx.builder.store, ctx.settings)
            backend = get_backend(backend_name, device=ctx.device)
            if backend_name == "tpu":
                # graft-fleet satellite (ROADMAP item 2 slice): the
                # narrowed verdict fetch is the DEFAULT — the wide
                # conditions/matched/scores tables never leave the device
                # unless settings.workflow_verdict_fields asks for them
                # ("full"/"all" restores every-matched-rule hypotheses)
                mode = getattr(ctx.settings, "workflow_verdict_fields",
                               "top")
                fields = "full" if mode in ("full", "all") else "top"
                all_results = backend.results(
                    raw=backend.score_snapshot(snapshot, fields=fields))
            else:
                all_results = backend.results(snapshot)
            mine = [r for r in all_results
                    if str(r.incident_id) == str(ctx.incident.id)]
            hyps = mine[0].hypotheses if mine else []
        else:
            hyps = get_backend("cpu").score_incident(
                ctx.incident.id, ctx.evidence_dicts or _evidence_rows(ctx)).hypotheses
    llm = LLMSummarizer(ctx.settings)
    if llm.enabled:
        hyps = llm.enhance_hypotheses(ctx.incident, hyps, ctx.evidence_dicts)
    ctx.hypotheses = hyps
    # graft-scope SLO boundary: the hypotheses ARE the verdict — close
    # the webhook→verdict latency sample this incident opened at the
    # ingestion edge (no-op for incidents that never passed a webhook)
    from ..observability.scope import SCOPE
    SCOPE.verdict_served(
        str(ctx.incident.id), backend=backend_name,
        shards=int(getattr(ctx.settings, "serve_graph_shards", 1)))
    RCA_DURATION.observe(_t.perf_counter() - t0, backend=backend_name)
    for h in hyps:
        HYPOTHESES_GENERATED.inc(category=getattr(h.category, "value", str(h.category)))
    ctx.db.insert_hypotheses(hyps)
    return {
        "count": len(hyps),
        "backend": backend_name,
        "mode": mode,
        "top_rule": hyps[0].rule_id if hyps else None,
        "top_confidence": hyps[0].confidence if hyps else None,
    }


def rank_hypotheses(ctx: IncidentContext) -> dict:
    # ranking is constant-folded into generation (ruleset.py); recorded for
    # lifecycle parity with activities.py:164-173. _ensure_hypotheses, not
    # ctx.hypotheses: a resume whose crash ate only this step's commit
    # must re-rank the PERSISTED hypotheses, not an empty transient list.
    hyps = _ensure_hypotheses(ctx)
    return {"ranked": [h.rule_id for h in hyps],
            "top_score": hyps[0].final_score if hyps else None}


def generate_runbook(ctx: IncidentContext) -> dict:
    if not _ensure_hypotheses(ctx):
        return {"generated": False}
    rb = RunbookGenerator().generate(ctx.incident, ctx.hypotheses[0],
                                     evidence=_ensure_evidence(ctx))
    ctx.db.insert_runbook(rb)
    return {"generated": True, "title": rb.title, "steps": len(rb.steps)}


def calculate_blast_radius(ctx: IncidentContext) -> dict:
    orch = RemediationOrchestrator(ctx.cluster, ctx.settings)
    blast = orch.calculate_blast_radius(ctx.incident)
    return blast.model_dump(mode="json")


def evaluate_policy(ctx: IncidentContext) -> dict:
    """Propose the top hypothesis' machine action (activities.py:207-246 —
    but using the structured ``action`` field, not recommended_actions[0]
    prose)."""
    hyps = _ensure_hypotheses(ctx)
    top = hyps[0] if hyps else None
    machine_action = _machine_action(top)
    if machine_action is None:
        return {"proposed": False, "reason": "no machine-executable action"}
    orch = RemediationOrchestrator(ctx.cluster, ctx.settings)
    target = (ctx.incident.service or ctx.incident.namespace)
    if machine_action == "cordon_node":
        pods = ctx.cluster.list_pods(ctx.incident.namespace, ctx.incident.service)
        target = pods[0].node if pods else target
    action = orch.propose_action(ctx.incident, machine_action, target)
    action.hypothesis_id = top.id if top else None
    ctx.action = action
    ctx.db.upsert_action(action)
    return {
        "proposed": True,
        "action_type": action.action_type.value,
        "target": action.target_resource,
        "allowed": action.status == ActionStatus.PROPOSED,
        "requires_approval": action.requires_approval,
        "reason": action.status_reason,
    }


def _machine_action(top: Hypothesis | None) -> str | None:
    if top is None:
        return None
    from ..rca import RULE_INDEX, RULES
    if top.rule_id in RULE_INDEX:
        rule = RULES[RULE_INDEX[top.rule_id]]
        return rule.action.value if rule.action else None
    return None


def request_approval(ctx: IncidentContext) -> dict:
    action = _ensure_action(ctx)
    assert action is not None
    if not action.requires_approval:
        action.status = ActionStatus.APPROVED
        action.approved_by = "auto-dev"  # activities.py:251-252
        ctx.db.upsert_action(action)
        return {"approved": True, "by": "auto-dev"}
    slack = ctx.slack or SlackClient(ctx.settings)
    # graft-saga satellite: rehydrate via _ensure_hypotheses — a
    # resume-after-crash context has empty ctx.hypotheses, and the
    # approver was being asked to sign off on a blank summary
    hyps = _ensure_hypotheses(ctx)
    req = ApprovalRequest(
        action_id=action.id, incident_id=ctx.incident.id,
        incident_title=ctx.incident.title, action_type=action.action_type,
        target_resource=action.target_resource,
        target_namespace=action.target_namespace,
        risk_level=action.risk_level,
        blast_radius_score=action.blast_radius_score,
        hypothesis_summary=hyps[0].description if hyps else "",
    )
    timeout = ctx.settings.approval_timeout_seconds
    resp = slack.request_approval(req, timeout_s=timeout)
    approved = bool(resp and resp.approved)
    action.status = ActionStatus.APPROVED if approved else ActionStatus.REJECTED
    if approved:
        action.approved_by = resp.responder
    else:
        action.rejection_reason = "timeout" if resp is None else (resp.notes or "rejected")
    ctx.db.upsert_action(action)
    return {"approved": approved,
            "by": resp.responder if resp else None,
            "timed_out": resp is None}


def execute_remediation(ctx: IncidentContext) -> dict:
    """graft-saga two-phase execution: the executor journals an intent
    row (idempotency key + pre-action probe + verification baseline)
    into the durable ``action_executions`` ledger BEFORE the cluster
    mutation and a result row after. A crash anywhere in between leaves
    an in-doubt intent that the resumed run RECONCILES against observed
    cluster state — the mutation fires exactly once, never twice. The
    baseline rides the intent row, so a resumed run compares against the
    true pre-action snapshot instead of re-probing the mutated cluster."""
    action = _ensure_action(ctx)
    assert action is not None
    verifier = RemediationVerifier(ctx.cluster)
    executor = RemediationExecutor(
        ctx.cluster, ctx.settings, db=ctx.db,
        fault_hook=(ctx.faults.at if ctx.faults is not None else None))
    baseline = executor.ledger_baseline(action)
    if baseline is None:
        baseline = verifier.capture_baseline(ctx.incident)
    ctx.baseline = baseline
    REMEDIATION_ATTEMPTS.inc(action_type=action.action_type.value)
    executed = executor.execute(action, baseline=baseline)
    ctx.db.upsert_action(executed)
    return {"status": executed.status.value,
            "result": executed.execution_result,
            "error": executed.error_message,
            "baseline": baseline}  # journaled: survives resume


async def verify_remediation(ctx: IncidentContext) -> dict:
    action = _ensure_action(ctx)
    if action is None:
        # graft-saga satellite: a replay whose actions table lost its row
        # (foreign journal, manual surgery) used to crash the verifier —
        # journal a SKIPPED verification instead: success=None is neither
        # the ticket trigger (False) nor a resolved close (True)
        log.warning("verify_skipped_no_action",
                    incident=str(ctx.incident.id))
        return {"success": None, "skipped": "no persisted action"}
    _fault(ctx, "verify")
    await asyncio.sleep(min(ctx.settings.verification_wait_seconds, 120))
    verifier = RemediationVerifier(ctx.cluster)
    baseline = ctx.baseline or (
        ctx.results.get("execute_remediation") or {}).get("baseline") or {}
    result = verifier.verify(ctx.incident, action, baseline)
    ctx.db.insert_verification(result)
    return {"success": result.success,
            "metrics_improved": result.metrics_improved,
            "pods_healthy_after": result.pods_healthy_after}


def compensate_remediation(ctx: IncidentContext) -> dict:
    """graft-saga compensation: verification FAILED on an executed
    action — roll its cluster effect back (scale → restore the
    pre-action replica count, cordon → uncordon, rollback →
    re-rollback; restart-class self-heals), policy-gated and journaled,
    with bounded attempts and escalate-to-human on exhaustion. Runs
    through the same two-phase ledger, so a crash mid-compensation
    reconciles on resume instead of double-firing."""
    action = _ensure_action(ctx)
    if action is None:
        return {"compensated": False, "skipped": "no persisted action"}
    _fault(ctx, "compensate")
    comp = RemediationCompensator(
        ctx.cluster, ctx.settings, db=ctx.db,
        fault_hook=(ctx.faults.at if ctx.faults is not None else None))
    return comp.compensate(action)


def create_ticket(ctx: IncidentContext) -> dict:
    jira = ctx.jira or JiraClient(ctx.settings)
    hyps = _ensure_hypotheses(ctx)
    return jira.create_incident_ticket(ctx.incident, hyps[0] if hyps else None,
                                       evidence=_ensure_evidence(ctx))


def close_incident(ctx: IncidentContext) -> dict:
    verified = (ctx.results.get("verify_remediation") or {}).get("success")
    status = IncidentStatus.RESOLVED if verified else IncidentStatus.CLOSED
    ctx.db.update_incident_status(ctx.incident.id, status, resolved_at=utcnow())
    INCIDENTS_RESOLVED.inc(status=status.value)
    if ctx.dedup is not None:  # allow re-alerting for recurring faults
        ctx.dedup.release(ctx.incident.fingerprint)
    return {"status": status.value}


# -- pipeline assembly ------------------------------------------------------

def _action_allowed(ctx: IncidentContext) -> bool:
    # journal-derived so it survives replay (ctx.action rehydrates lazily)
    policy = ctx.results.get("evaluate_policy") or {}
    return bool(policy.get("proposed") and policy.get("allowed"))


def _approved(ctx: IncidentContext) -> bool:
    return (_action_allowed(ctx)
            and bool((ctx.results.get("request_approval") or {}).get("approved")))


def _needs_ticket(ctx: IncidentContext) -> bool:
    policy = ctx.results.get("evaluate_policy") or {}
    verify = ctx.results.get("verify_remediation") or {}
    return (not policy.get("allowed", False)
            or not (ctx.results.get("request_approval") or {}).get("approved", False)
            or verify.get("success") is False)  # incident_workflow.py:246-250


def _compensation_due(ctx: IncidentContext) -> bool:
    """Saga trigger: the action EXECUTED but verification said the
    cluster did not get better — undo the mutation before ticketing."""
    if not getattr(ctx.settings, "remediation_compensation", False):
        return False
    execute = ctx.results.get("execute_remediation") or {}
    verify = ctx.results.get("verify_remediation") or {}
    return (execute.get("status") == "completed"
            and verify.get("success") is False)


# canonical step order for inspection surfaces (the 13-step lifecycle:
# the reference's 12 + the graft-saga compensation step); kept in sync
# with incident_steps() below
STEP_NAMES = (
    "collect_evidence", "build_graph", "generate_hypotheses",
    "rank_hypotheses", "generate_runbook", "calculate_blast_radius",
    "evaluate_policy", "request_approval", "execute_remediation",
    "verify_remediation", "compensate_remediation", "create_ticket",
    "close_incident",
)


def incident_steps(settings: Settings | None = None) -> list[Step]:
    s = settings or get_settings()
    remediation_on = s.remediation_enabled
    return [
        Step("collect_evidence", collect_evidence, timeout_s=300),
        Step("build_graph", build_graph, timeout_s=120),
        Step("generate_hypotheses", generate_hypotheses, timeout_s=180),
        Step("rank_hypotheses", rank_hypotheses, timeout_s=30),
        Step("generate_runbook", generate_runbook, timeout_s=30),
        Step("calculate_blast_radius", calculate_blast_radius, timeout_s=30),
        Step("evaluate_policy", evaluate_policy, timeout_s=30,
             condition=lambda ctx: remediation_on),
        Step("request_approval", request_approval,
             timeout_s=s.approval_timeout_seconds + 5,
             condition=_action_allowed),
        Step("execute_remediation", execute_remediation, timeout_s=300,
             condition=_approved),
        Step("verify_remediation", verify_remediation,
             timeout_s=s.verification_wait_seconds + 120,
             condition=lambda ctx: (ctx.results.get("execute_remediation") or {}
                                    ).get("status") == "completed"),
        Step("compensate_remediation", compensate_remediation, timeout_s=300,
             condition=_compensation_due),
        Step("create_ticket", create_ticket, timeout_s=30,
             condition=_needs_ticket),
        Step("close_incident", close_incident, timeout_s=30),
    ]


async def run_incident_workflow(
    incident: Incident,
    cluster: Any,
    db: Database,
    builder: GraphBuilder | None = None,
    settings: Settings | None = None,
    engine: WorkflowEngine | None = None,
    slack: SlackClient | None = None,
    jira: JiraClient | None = None,
    dedup: Any = None,
    scorer: Any = None,
    tenant: str = "default",
    faults: Any = None,
    device: Any = None,
) -> dict:
    """Entry point: the reference's `start_workflow("IncidentWorkflow",
    id=f"incident-{id}")` (main.py:406-413).

    graft-saga: the run claims a fenced lease on the workflow id before
    touching the incident. A held lease means another worker is live on
    this workflow — return without driving it. A crash (worker death)
    leaves the lease to EXPIRE, at which point the resumer sweep
    (worker.resume_orphans) reclaims it and re-enters here through the
    journal-replay path; the fencing token keeps a paused-then-woken
    zombie from double-driving the journal.

    ``device`` is where the scorers run: ``None`` is the CUDA device (it
    raises without one), ``"cpu"`` the plain versions of the kernels."""
    s = settings or get_settings()
    ctx = IncidentContext(
        incident=incident, cluster=cluster, db=db,
        builder=builder or GraphBuilder(), settings=s,
        slack=slack, jira=jira, dedup=dedup, scorer=scorer,
        tenant=tenant, faults=faults, device=resolve_device(device),
    )
    engine = engine or WorkflowEngine(db)
    wf_id = f"incident-{incident.id}"
    lease = None
    ttl = float(getattr(s, "workflow_lease_ttl_s", 60.0))
    if getattr(s, "workflow_lease_enabled", False):
        import os
        from uuid import uuid4 as _uuid4
        owner = f"{os.getpid()}:{_uuid4().hex[:8]}"
        token = db.lease_acquire(wf_id, owner, ttl)
        if token is None:
            log.info("workflow_lease_held", workflow=wf_id)
            return {"lease_held": True}
        lease = (owner, token)
        if token > 1:
            _fault(ctx, "crash_restart")  # chaos: die again right away
    db.update_incident_status(incident.id, IncidentStatus.INVESTIGATING)
    released_ok = False
    try:
        results = await engine.run(wf_id, incident_steps(s), ctx,
                                   lease=lease, lease_ttl_s=ttl)
        released_ok = True
        return results
    except WorkflowFenced:
        # benign: the lease expired mid-run and another worker owns the
        # workflow now — do NOT audit a failure, do NOT release (the
        # owner+token match makes a late release a no-op anyway)
        log.warning("workflow_fenced_out", workflow=wf_id)
        return {"lease_fenced": True}
    except StepFailed as exc:
        log.error("workflow_failed", incident=str(incident.id), error=str(exc))
        db.audit(str(incident.id), "workflow_failed", {"error": str(exc)})
        # graft-saga satellite: a StepFailed leaves the incident open with
        # only an audit row — stamp the stalled gauge so the resumer sweep
        # and GET /api/v1/workflows surface it instead of it vanishing
        # into INVESTIGATING forever
        released_ok = True
        from ..observability import metrics as obs_metrics
        obs_metrics.WORKFLOW_STALLED.set(float(len(db.stalled_workflows(
            max_resumes=int(getattr(s, "workflow_max_resumes", 5))))))
        raise
    except Exception as exc:
        log.error("workflow_failed", incident=str(incident.id), error=str(exc))
        db.audit(str(incident.id), "workflow_failed", {"error": str(exc)})
        released_ok = True
        raise
    finally:
        # a CRASH (BaseException, e.g. rca/faults.WorkflowCrash) skips the
        # release on purpose — a dead worker cannot release, the lease
        # must EXPIRE into the resumer's hands
        if lease is not None and released_ok:
            db.lease_release(wf_id, *lease)
