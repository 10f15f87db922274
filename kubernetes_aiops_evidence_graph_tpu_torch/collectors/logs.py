"""Log collector — pattern scanning over backend log lines.

Parity with the reference LogsCollector (logs_collector.py:20-39 pattern
catalog, :167-241 scanning and signal heuristic): the same 10 error-pattern
categories plus an explicit ``timeout`` category (the reference's
network_error rule referenced raw phrases no collector ever emitted —
SURVEY.md §3.6; here patterns_found speaks the same category vocabulary the
ruleset matches on), ≤10 sample errors, and the >10-errors/0.95-critical
signal heuristic. Emits one LOG_SIGNAL evidence per incident.
"""
from __future__ import annotations

import re

from ..models import CollectorResult, EvidenceSource, EvidenceType, Incident
from .base import BaseCollector

# category -> compiled regex (reference logs_collector.py:20-31, + timeout)
ERROR_PATTERNS: dict[str, re.Pattern] = {
    "error": re.compile(r"\b(error|err)\b", re.I),
    "critical": re.compile(r"\b(critical|fatal|panic)\b", re.I),
    "oom": re.compile(r"out of memory|oom[- ]?kill", re.I),
    "network": re.compile(r"\b(network unreachable|no route to host|dial tcp)\b", re.I),
    "auth": re.compile(r"\b(unauthorized|forbidden|permission denied|auth)\b", re.I),
    "missing": re.compile(r"\b(not found|no such file|missing)\b", re.I),
    "null_pointer": re.compile(r"(nil pointer|null pointer|NoneType)", re.I),
    "connection": re.compile(r"connection (refused|reset|closed)", re.I),
    "disk": re.compile(r"\b(no space left|disk full|i/o error)\b", re.I),
    "tls": re.compile(r"\b(tls|x509|certificate)\b", re.I),
    "timeout": re.compile(r"\btime[d]? ?out\b", re.I),
}

_NETWORK_CATEGORIES = ("network", "connection", "timeout")

STACK_TRACE_PATTERNS = (
    re.compile(r"^\s+at [\w.$]+\(.*\)"),              # Java
    re.compile(r'^\s*File ".*", line \d+'),           # Python
    re.compile(r"^goroutine \d+ \["),                 # Go
    re.compile(r"^\s+at .* \(.*:\d+:\d+\)"),          # Node
)


def scan_python(lines: list[str]):
    """The plain version of ``LogsCollector._scan``: the regex catalog
    over each line (reference logs_collector.py:167-219)."""
    patterns_found: list[str] = []
    error_count = 0
    network_error_count = 0
    samples: list[str] = []
    for line in lines:
        matched_any = False
        for category, rx in ERROR_PATTERNS.items():
            if rx.search(line):
                if category not in patterns_found:
                    patterns_found.append(category)
                matched_any = True
                if category in _NETWORK_CATEGORIES:
                    network_error_count += 1
        if matched_any:
            error_count += 1
            if len(samples) < 10:  # :205-219
                samples.append(line[:500])
    return patterns_found, error_count, network_error_count, samples


class LogsCollector(BaseCollector):
    name = "logs"
    source = EvidenceSource.LOKI

    def _scan(self, lines: list[str]):
        """Pattern scan through the native single-pass scanner
        (kernels/kaeg_native.cpp ``scan_logs``): (patterns_found in
        first-seen order, error_count, network_error_count, up to 10
        sample lines), the same as :func:`scan_python` gives, which the
        tests and ``chip_smoke.py`` hold it to. A library that cannot be
        built raises ``kernels._build.KernelError``."""
        from .. import native as _native
        _counts, flags = _native.scan_logs_native(lines)
        patterns_found: list[str] = []
        error_count = 0
        network_error_count = 0
        samples: list[str] = []
        cats = [c for c, _a, _b in _native.LOG_CATEGORIES]
        net_mask = sum(1 << i for i, c in enumerate(cats)
                       if c in _NETWORK_CATEGORIES)
        for i, line in enumerate(lines):
            bits = int(flags[i])
            if not bits:
                continue
            for ci, cat in enumerate(cats):
                if bits >> ci & 1 and cat not in patterns_found:
                    patterns_found.append(cat)
            error_count += 1
            network_error_count += (bits & net_mask).bit_count()
            if len(samples) < 10:
                samples.append(line[:500])
        return patterns_found, error_count, network_error_count, samples

    def collect(self, incident: Incident) -> CollectorResult:
        result = CollectorResult(collector_name=self.name)
        if not incident.service:
            return result
        lines = self.backend.query_logs(
            incident.namespace, incident.service, limit=self.settings.max_log_lines)
        if not lines:
            return result

        patterns_found, error_count, network_error_count, samples = (
            self._scan(lines))
        traces: list[str] = []
        for line in lines:
            for trx in STACK_TRACE_PATTERNS:
                if trx.match(line) and len(traces) < 5:
                    traces.append(line[:500])

        # signal heuristic (:221-241)
        strength = 0.5
        if error_count > 10:
            strength = 0.9
        if "oom" in patterns_found or "critical" in patterns_found:
            strength = 0.95

        result.evidence.append(self.make_evidence(
            incident, EvidenceType.LOG_SIGNAL, incident.service,
            {
                "patterns_found": patterns_found,
                "error_count": error_count,
                "network_error_count": network_error_count,
                "sample_errors": samples,
                "stack_traces": traces,
                "lines_scanned": len(lines),
            },
            signal_strength=strength, is_anomaly=error_count > 10,
        ))
        return result
