"""Pass 4, the sentinel: concurrency & durability static analysis.

The serving stack is concurrent and crash-consistent: WAL-before-mutate
shield discipline, intent-before-mutation remediation ledgers, swap/heal
generation boundaries under ``serve_lock``. This module runs the pass:
it parses each source file once, hands the :class:`SentinelFile` to
the rule-family checkers, and adds the
waiver-hygiene gate.

Rule families (each in its own module):

* :mod:`.locks`: ``lock-guard`` / ``lock-order``. The
  :data:`~.locks.GUARDED_BY` registry maps resident-state attributes to
  their lock; accesses outside a ``with <lock>`` scope fail, nested
  acquisitions follow the declared order (the
  ``surge.swap_tenants_atomically`` convention), and a leaf lock is
  never held while another is taken.
* :mod:`.ordering`: ``wal-order`` / ``ledger-order``. Registered
  mutation calls must be dominated by the matching journal-append /
  intent-row call in the same function (WAL-before-mutate).

Plus the hygiene gate here: ``waiver-no-reason``. Every ``# graft-audit:
allow[rule]`` pragma must carry a reason; a bare waiver is a hard
failure (it is also the one rule that cannot itself be waived).

The reference's ``use-after-donate`` (torch donates nothing) and its
four ``dma-*`` rules (the port's async copies live in CUDA C++, outside
a Python AST) have no counterpart here (``findings.NO_COUNTERPART``).

Fixture trees can extend the central registries inline with a
module-level literal::

    GRAFT_SENTINEL = {
        "guarded_by": {"serve_lock": ["_params"]},
        "held_fns": ["_swap_locked"],
        "lock_order": ["outer_lock", "inner_lock"],
        "leaf_locks": ["_table_lock"],
        "ordering": {"rule": "wal-order", "journal": ["append"],
                     "mutate": ["apply"], "exempt": "replay|recover"},
    }

This pass is stdlib-only (it never imports torch).
"""
from __future__ import annotations

import ast
import io
import tokenize
from pathlib import Path

from .ast_lint import _WAIVER_RE, _inline_literal, package_root
from .findings import Finding, Report


def _comment_waivers(source: str) -> dict[int, tuple[set, str]]:
    """line -> (rules, reason) for every waiver pragma in a REAL comment
    token; docstrings quoting the pragma syntax don't count."""
    out: dict[int, tuple[set, str]] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = _WAIVER_RE.search(tok.string)
            if m:
                rules = {r.strip() for r in m.group(1).split(",")}
                out[tok.start[0]] = (rules, m.group(2).strip())
    except (tokenize.TokenError, IndentationError):
        pass
    return out


class SentinelFile:
    """One parsed source file shared by the checkers."""

    def __init__(self, rel: str, source: str):
        self.rel = rel
        self.tree = ast.parse(source)
        self.findings: list[Finding] = []
        self.waivers = _comment_waivers(source)
        self.inline = self._inline_registry()

    def _inline_registry(self) -> dict:
        """Module-level ``GRAFT_SENTINEL = {...}`` literal (fixtures)."""
        value = _inline_literal(self.tree, "GRAFT_SENTINEL")
        return value if isinstance(value, dict) else {}

    def hit(self, rule: str, line: int, message: str,
            waivable: bool = True) -> None:
        waived, reason = False, ""
        if waivable:
            for ln in (line, line - 1):
                w = self.waivers.get(ln)
                if w and (rule in w[0] or "all" in w[0]):
                    waived, reason = True, w[1]
                    break
        self.findings.append(Finding(
            rule=rule, where=f"{self.rel}:{line}", message=message,
            pass_name="sentinel", waived=waived, waiver_reason=reason))


def collect_waivers(root: "Path | str | None" = None) -> list[dict]:
    """Every waiver pragma under ``root``: the ``--waivers`` CLI mode."""
    base = Path(root) if root is not None else package_root()
    out: list[dict] = []
    for path in sorted(base.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(base).as_posix()
        for i, (rules, reason) in sorted(
                _comment_waivers(path.read_text()).items()):
            out.append({"where": f"{rel}:{i}",
                        "rules": sorted(rules),
                        "reason": reason})
    return out


def _waiver_hygiene(sf: SentinelFile) -> None:
    """``waiver-no-reason``: a bare pragma silently hides a rule with no
    recorded justification: a hard failure, never itself waivable."""
    for line, (rules, reason) in sorted(sf.waivers.items()):
        if not reason:
            sf.hit("waiver-no-reason", line,
                   f"waiver for [{', '.join(sorted(rules))}] carries no "
                   "reason: `# graft-audit: allow[rule] why` is the "
                   "contract; a bare allow hides the rule with no "
                   "recorded justification", waivable=False)


def run_sentinel(root: "Path | str | None" = None) -> Report:
    """Run the sentinel checkers + waiver hygiene over ``root``
    (default: the port's package)."""
    from . import locks, ordering
    base = Path(root) if root is not None else package_root()
    report = Report()
    for path in sorted(base.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(base).as_posix()
        try:
            sf = SentinelFile(rel, path.read_text())
        except SyntaxError:
            continue    # pass 2 already reports syntax-error
        locks.check(sf)
        ordering.check(sf)
        _waiver_hygiene(sf)
        report.findings.extend(sf.findings)
    return report
