"""Sentinel rule family 3: ``wal-order`` / ``ledger-order``.

Crash consistency in this codebase is one invariant wearing two hats:
the durable record of an intent hits disk BEFORE the mutation it
describes. The shield WAL-journals every delta batch, params swap, and
mesh heal before applying it (``wal-order``); the remediation executor
writes an intent row before dispatching a cluster mutation
(``ledger-order``). Replay correctness depends on the order: a
mutation that can execute before its record means a crash in the gap
replays into a state that never existed.

The checker is a per-function must-dominance analysis over the
:data:`ORDERED_SITES` registry: every call whose trailing name is in the
file's ``mutate`` set must be dominated (reached on EVERY path) by a
call matching the ``journal`` suffix earlier in the same function.

Mechanics:

* statements execute in source order; a journal call flips the
  "journaled" fact for everything after it (and for later calls in the
  same statement, by position);
* ``if``/``else`` merge by AND over the branches that fall through
  (a branch ending in ``return``/``raise`` does not reach the merge);
* the **vacuous-empty** special case: ``if recs: journal.append(recs)``
  with no ``else``: when the test is a bare name, the implicit else
  means the batch is empty, so the un-journaled path mutates nothing;
  the merge keeps "journaled";
* loop bodies may run zero times, so a journal inside a loop never
  satisfies a mutation after it;
* functions whose name matches the file's ``exempt`` regex (replay /
  recovery / reconcile paths, which re-apply already-durable records)
  are skipped entirely.

Journal AND mutate matching are by dotted-suffix (``journal.append``
will not match a ``list.append``; ``s.rollback_params`` matches the
scorer-level mutation but not the shield's own journaling wrapper
``self.rollback_params``). Fixture trees declare the registry inline via
``GRAFT_SENTINEL["ordering"]``.
"""
from __future__ import annotations

import ast
import re

from .ast_lint import _call_name

# rel path -> {rule, journal (dotted suffixes), mutate (trailing names),
#              exempt (regex over function names)}
ORDERED_SITES: dict[str, dict] = {
    # WAL-before-mutate: delta batches, params swaps, heals and
    # re-expansions journal (fsync) before the scorer mutates. `s` is the
    # shield's scorer handle; the suffixes name the scorer-level mutation
    # seams, not the shield's journaling wrappers. The heal paths journal
    # through ShieldedScorer._journal_mesh, which always appends its
    # mesh_heal record with force_sync=True (no early return), so a call
    # to it counts as the journal append
    "rca/shield.py": {
        "rule": "wal-order",
        "journal": ("journal.append", "self._journal_mesh"),
        "mutate": ("s._apply_records", "s._apply_edge_records",
                   "s.swap_params", "s.rollback_params", "s.adopt_mesh",
                   "s._swap_params_locked"),
        "exempt": r"replay|recover|restore|reconcile|rebuild",
    },
    # the atomic multi-tenant swap journals each shielded tenant before
    # installing the generation through its locked seam; a migration
    # likewise appends the fleet-WAL intent record before the source
    # repack / destination adopt mutate either pack
    "rca/surge.py": {
        "rule": "wal-order",
        "journal": ("journal.append",),
        "mutate": ("scorer._swap_params_locked",
                   "pack.remove_tenant", "pack.add_tenant"),
        "exempt": r"replay|recover|restore",
    },
    # intent-before-mutation: the executor writes the intent row before
    # any cluster dispatch; _reconcile probes in-doubt intents and is the
    # sanctioned re-fire path
    "remediation/executor.py": {
        "rule": "ledger-order",
        "journal": ("execution_intent",),
        "mutate": ("self._dispatch_one",),
        "exempt": r"reconcile|replay|recover",
    },
}


class _Dominance:
    def __init__(self, sf, cfg: dict):
        self.sf = sf
        self.rule = cfg["rule"]
        self.journal = tuple(cfg["journal"])
        self.mutate = set(cfg["mutate"])

    def run(self, fn: ast.FunctionDef) -> None:
        self.block(fn.body, journaled=False)

    def block(self, stmts, journaled: bool) -> tuple[bool, bool]:
        """Returns (journaled-at-exit, definitely-terminated)."""
        for stmt in stmts:
            journaled, terminated = self.stmt(stmt, journaled)
            if terminated:
                return journaled, True
        return journaled, False

    def stmt(self, stmt, journaled: bool) -> tuple[bool, bool]:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return journaled, False    # nested defs: own analysis pass
        if isinstance(stmt, (ast.Return, ast.Raise)):
            self.calls(stmt, journaled)
            return journaled, True
        if isinstance(stmt, ast.If):
            self.calls(stmt.test, journaled)
            j_b, t_b = self.block(stmt.body, journaled)
            j_e, t_e = self.block(stmt.orelse, journaled)
            if t_b and t_e:
                return True, True
            if t_b:
                return j_e, False
            if t_e:
                return j_b, False
            if (not stmt.orelse and j_b
                    and isinstance(stmt.test, ast.Name)):
                # vacuous-empty: `if recs: journal.append(recs)`: the
                # implicit else carries an empty batch, so the
                # un-journaled path mutates nothing
                return True, False
            return j_b and j_e, False
        if isinstance(stmt, (ast.For, ast.While)):
            self.calls(getattr(stmt, "iter", None)
                       or getattr(stmt, "test", None), journaled)
            self.block(stmt.body, journaled)
            j, _t = self.block(stmt.orelse, journaled)
            return j, False            # body may run zero times
        if isinstance(stmt, ast.With):
            for item in stmt.items:
                journaled = self.calls(item.context_expr, journaled)
            return self.block(stmt.body, journaled)
        if isinstance(stmt, ast.Try):
            j_b, t_b = self.block(stmt.body, journaled)
            outs = [] if t_b else [j_b]
            for h in stmt.handlers:
                # the exception may fire before the journal call landed
                j_h, t_h = self.block(h.body, journaled)
                if not t_h:
                    outs.append(j_h)
            if not t_b:
                j_o, t_o = self.block(stmt.orelse, j_b)
                if stmt.orelse and not t_o:
                    outs[0] = j_o
            merged = bool(outs) and all(outs)
            j_f, t_f = self.block(stmt.finalbody, merged)
            return (j_f if stmt.finalbody else merged), t_f
        return self.calls(stmt, journaled), False

    def calls(self, node, journaled: bool) -> bool:
        """Process every call in source order; flag un-dominated
        mutations, absorb journal appends."""
        if node is None:
            return journaled
        found = [n for n in ast.walk(node) if isinstance(n, ast.Call)]
        for call in sorted(found, key=lambda c: (c.lineno, c.col_offset)):
            dotted = _call_name(call)
            if any(dotted.endswith(suffix) for suffix in self.journal):
                journaled = True
            elif any(dotted.endswith(suffix) for suffix in self.mutate) \
                    and not journaled:
                trailing = dotted.rsplit(".", 1)[-1]
                self.sf.hit(
                    self.rule, call.lineno,
                    f"mutation '{trailing}' is reachable before its "
                    f"{'intent row' if self.rule == 'ledger-order' else 'WAL append'}"
                    f" ({' / '.join(self.journal)}): the durable record "
                    "must hit disk first or a crash in the gap replays "
                    "into a state that never existed")
        return journaled


def check(sf) -> None:
    cfg = ORDERED_SITES.get(sf.rel) or sf.inline.get("ordering")
    if not cfg:
        return
    exempt = re.compile(cfg.get("exempt") or r"$^")
    dom = _Dominance(sf, cfg)
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.FunctionDef) \
                and not exempt.search(node.name):
            dom.run(node)
