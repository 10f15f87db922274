"""Optional LLM hypothesis enrichment.

Parity with the reference LLMSummarizer (llm_summarizer.py:22-190): enhances
the top-3 hypotheses with reasoning / additional steps / alternatives via a
provider backend (gemini | openai | ollama REST), JSON extracted by brace
scan, evidence summarized as a ≤20-bullet list. Failures always fall back
to the rules-only hypotheses (activities.py:144-152). Provider "none"
disables enrichment (this environment has zero egress).
"""
from __future__ import annotations

import json
import urllib.request
from typing import Iterable

from ..config import Settings, get_settings
from ..models import Hypothesis, HypothesisSource, Incident
from ..observability import get_logger

log = get_logger("llm")


def _extract_json(text: str) -> dict | None:
    """Brace-scan extraction (llm_summarizer.py:117-126)."""
    start = text.find("{")
    if start < 0:
        return None
    depth = 0
    for i in range(start, len(text)):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                try:
                    return json.loads(text[start:i + 1])
                except json.JSONDecodeError:
                    return None
    return None


def _summarize_evidence(evidence: Iterable[dict], limit: int = 20) -> str:
    bullets = []
    for ev in list(evidence)[:limit]:
        data = ev.get("data", {}) or {}
        key = (data.get("waiting_reason") or data.get("terminated_reason")
               or data.get("query_name") or ev.get("evidence_type"))
        bullets.append(f"- {ev.get('evidence_type')}: {ev.get('entity_name')} ({key})")
    return "\n".join(bullets)


class LLMSummarizer:
    def __init__(self, settings: Settings | None = None) -> None:
        self.settings = settings or get_settings()

    @property
    def enabled(self) -> bool:
        return self.settings.llm_provider not in ("", "none")

    def enhance_hypotheses(
        self,
        incident: Incident,
        hypotheses: list[Hypothesis],
        evidence: list[dict],
        top_n: int = 3,
    ) -> list[Hypothesis]:
        if not self.enabled:
            return hypotheses
        out = list(hypotheses)
        for i, h in enumerate(out[:top_n]):
            try:
                prompt = self._build_prompt(incident, h, evidence)
                raw = self._complete(prompt)
                parsed = _extract_json(raw or "")
                if not parsed:
                    continue
                h.reasoning = parsed.get("reasoning") or h.reasoning
                extra = parsed.get("additional_steps") or []
                h.recommended_actions = list(h.recommended_actions) + [
                    s for s in extra if s not in h.recommended_actions]
                if parsed.get("enhanced_description"):
                    h.description = parsed["enhanced_description"]
                h.why_not_notes = parsed.get("alternatives") or h.why_not_notes
                h.generated_by = HypothesisSource.HYBRID
            except Exception as exc:  # graft-audit: allow[broad-except] fall back silently (activities.py:144-152)
                log.warning("llm_enhancement_failed", hypothesis=h.rule_id,
                            error=str(exc))
        return out

    def _build_prompt(self, incident: Incident, h: Hypothesis,
                      evidence: list[dict]) -> str:
        return (
            "You are an SRE assistant. Given this incident and hypothesis, "
            "reply with JSON {\"reasoning\": str, \"additional_steps\": [str], "
            "\"alternatives\": str, \"enhanced_description\": str}.\n"
            f"Incident: {incident.title} (severity {incident.severity.value}, "
            f"namespace {incident.namespace}, service {incident.service})\n"
            f"Hypothesis: {h.title} — {h.description} "
            f"(confidence {h.confidence})\n"
            f"Evidence:\n{_summarize_evidence(evidence)}"
        )

    # -- providers (llm_summarizer.py:92-190) -----------------------------

    def _complete(self, prompt: str) -> str | None:
        provider = self.settings.llm_provider
        if provider == "gemini":
            return self._gemini(prompt)
        if provider == "openai":
            return self._openai(prompt)
        if provider == "ollama":
            return self._ollama(prompt)
        raise ValueError(f"unknown llm provider {provider!r}")

    def _post_json(self, url: str, payload: dict, headers: dict) -> dict:
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json", **headers})
        with urllib.request.urlopen(req, timeout=30) as resp:  # noqa: S310
            return json.loads(resp.read())

    def _gemini(self, prompt: str) -> str | None:
        model = self.settings.llm_model or "gemini-1.5-flash"
        body = self._post_json(
            f"https://generativelanguage.googleapis.com/v1beta/models/"
            f"{model}:generateContent?key={self.settings.llm_api_key}",
            {"contents": [{"parts": [{"text": prompt}]}]}, {})
        candidates = body.get("candidates") or []
        if candidates:
            parts = candidates[0].get("content", {}).get("parts", [])
            return "".join(p.get("text", "") for p in parts)
        return None

    def _openai(self, prompt: str) -> str | None:
        body = self._post_json(
            "https://api.openai.com/v1/chat/completions",
            {"model": self.settings.llm_model or "gpt-4o-mini",
             "messages": [{"role": "user", "content": prompt}]},
            {"Authorization": f"Bearer {self.settings.llm_api_key}"})
        choices = body.get("choices") or []
        return choices[0]["message"]["content"] if choices else None

    def _ollama(self, prompt: str) -> str | None:
        body = self._post_json(
            "http://localhost:11434/api/generate",
            {"model": self.settings.llm_model or "llama3", "prompt": prompt,
             "stream": False}, {})
        return body.get("response")
