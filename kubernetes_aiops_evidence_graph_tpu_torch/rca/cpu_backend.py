"""CPU reference RCA backend — the accuracy oracle and the 40× denominator.

Reproduces the reference pipeline generate_hypotheses → rank
(rules_engine.py:200-234, hypothesis_ranker.py:13-80) as pure functions over
evidence dicts: signal fold → all-conditions rule match → constant-folded
confidence/ranking from the shared ruleset. The TPU backend must produce
identical top-1 rule ids and scores on the same snapshot (parity tests).
"""
from __future__ import annotations

import time
from typing import Iterable, Sequence
from uuid import UUID, uuid4

from ..models import Hypothesis, HypothesisCategory, HypothesisSource, RCAResult
from .ruleset import (
    RULES,
    Rule,
    UNKNOWN_ACTIONS,
    UNKNOWN_CONFIDENCE,
    UNKNOWN_FINAL_SCORE,
)
from .signals import Signals, condition_vector, extract_signals


def match_rules(signals: Signals) -> list[Rule]:
    """All-conditions-AND matching (rules_engine.py:359-378)."""
    conds = condition_vector(signals)
    return [r for r in RULES if all(conds[c] for c in r.conditions)]


def _hypothesis_from_rule(incident_id: UUID, rule: Rule, signals: Signals) -> Hypothesis:
    return Hypothesis(
        id=uuid4(),
        incident_id=incident_id,
        category=rule.category,
        title=rule.name,
        description=rule.description,
        confidence=rule.confidence,
        final_score=rule.final_score,
        support_count=len(rule.conditions),
        signal_strength=rule.evidence_strength,
        supporting_evidence_ids=[UUID(e) for e in signals.evidence_ids[:5] if _is_uuid(e)],
        recommended_actions=rule.recommended_actions,
        rule_id=rule.id,
        backend="cpu",
        generated_by=HypothesisSource.RULES_ENGINE,
    )


def _is_uuid(s: str) -> bool:
    try:
        UUID(s)
        return True
    except (ValueError, AttributeError, TypeError):
        return False


def _unknown_hypothesis(incident_id: UUID, signals: Signals) -> Hypothesis:
    """Fallback when nothing matches (rules_engine.py:426-447)."""
    return Hypothesis(
        id=uuid4(),
        incident_id=incident_id,
        category=HypothesisCategory.UNKNOWN,
        title="Unknown Issue",
        description="No specific pattern matched. Manual investigation required.",
        confidence=UNKNOWN_CONFIDENCE,
        final_score=UNKNOWN_FINAL_SCORE,
        rank=1,
        supporting_evidence_ids=[UUID(e) for e in signals.evidence_ids[:5] if _is_uuid(e)],
        recommended_actions=list(UNKNOWN_ACTIONS),
        rule_id="unknown",
        backend="cpu",
        generated_by=HypothesisSource.RULES_ENGINE,
    )


def rank(hypotheses: list[Hypothesis]) -> list[Hypothesis]:
    """Sort by final_score desc, assign 1-based ranks (hypothesis_ranker.py:67-71).

    Ties broken by rule-table order (stable sort), matching the CPU fold order.
    """
    ranked = sorted(hypotheses, key=lambda h: h.final_score, reverse=True)
    for i, h in enumerate(ranked):
        h.rank = i + 1
    return ranked


class CpuRcaBackend:
    """rca_backend="cpu" — scores incidents one at a time from evidence lists."""

    name = "cpu"

    def score_incident(self, incident_id: UUID, evidence: Iterable[dict]) -> RCAResult:
        t0 = time.perf_counter()
        signals = extract_signals(evidence)
        matched = match_rules(signals)
        if matched:
            hyps = [_hypothesis_from_rule(incident_id, r, signals) for r in matched]
        else:
            hyps = [_unknown_hypothesis(incident_id, signals)]
        hyps = rank(hyps)
        return RCAResult(
            incident_id=incident_id,
            hypotheses=hyps,
            top_hypothesis=hyps[0],
            rules_matched=[r.id for r in matched],
            analysis_duration_seconds=time.perf_counter() - t0,
            backend="cpu",
        )

    def score_batch(
        self, incidents: Sequence[tuple[UUID, Sequence[dict]]]
    ) -> list[RCAResult]:
        """Sequential per-incident loop — deliberately the reference's cost
        model (one Temporal activity per incident), used as the benchmark
        baseline."""
        return [self.score_incident(iid, ev) for iid, ev in incidents]
