"""Sentinel rule family 2: ``lock-guard`` / ``lock-order``.

``lock-guard``: the :data:`GUARDED_BY` registry maps resident-state
attributes to the lock that owns them: the swap/heal generation seam
under ``serve_lock``, the fleet's placement under the server's
``_lock``. Any access (read or write) to a guarded attribute outside a
lexical ``with <lock>:`` scope is a finding. Exemptions are explicit,
not inferred: ``__init__`` (no concurrency before construction
returns), the ``held_fns`` set (functions documented to run with the
lock already held, e.g. ``_swap_params_locked``), and the normal waiver
pragma for advisory reads whose race is argued harmless in the reason.

``lock-order``: nested acquisitions follow the declared order, the
convention pinned by ``surge.swap_tenants_atomically``: coarse container
locks (a server's ``_lock``) are acquired BEFORE any tenant/scorer
``serve_lock``, never inside one. A leaf lock (:data:`LEAF_LOCKS`, the
port's own module and instance locks) is never held while another lock
is taken. Acquiring an earlier-ranked lock while holding a later-ranked
one is the deadlock shape the runtime
:class:`~.runtime_guards.LockOrderGuard` hunts dynamically; this is the
static half.

Scope: lexical analysis only. ``with self.serve_lock:`` blocks are
recognized by the final attribute name of the context expression;
manual ``acquire()``/``release()`` choreography (the async tick seam)
is exempted via ``held_fns``. The held-set flows lexically into nested
function definitions (helpers defined and called inside the guarded
block). Fixture trees declare registries inline via ``GRAFT_SENTINEL``
(keys ``guarded_by``, ``held_fns``, ``lock_order``, ``leaf_locks``).
"""
from __future__ import annotations

import ast
import re

from .ast_lint import _dotted

# rel path -> {"locks": {lock attr -> guarded attrs},
#              "held_fns": functions that run with the lock already held}
GUARDED_BY: dict[str, dict] = {
    # the learned scorer's generation seam: swap/rollback flip the triple
    # under serve_lock; _swap_params_locked is the documented
    # already-held seam, and dispatch (with the sharded mirror's
    # _dispatch_sharded, which dispatch alone calls) runs under the tick
    # caller's serve_lock (StreamingScorer.tick_async / rescore / serve)
    "rca/gnn_streaming.py": {
        "locks": {"serve_lock": {"_params", "_params_prev",
                                 "params_generation"}},
        "held_fns": {"_swap_params_locked", "_resident_arrays",
                     "_adopt_resident", "dispatch", "_dispatch_sharded"},
    },
    # the heal bookkeeping: the exclusion set and heal generation move
    # only inside the scorer's serve_lock (mesh_heal / reexpand /
    # scale_mesh); _journal_mesh is their write-ahead helper, called only
    # from inside those `with s.serve_lock:` blocks
    "rca/shield.py": {
        "locks": {"serve_lock": {"_mesh_excluded", "_heal_gen",
                                 "_mesh_home"}},
        "held_fns": {"_journal_mesh"},
    },
    # fleet state: tenant placement, per-tenant load EWMAs and the
    # scale/migration history ring are mutated by migrate()/register()
    # and read by the fleet API from HTTP threads
    "rca/surge.py": {
        "locks": {"_lock": {"_placement", "_loads", "_history"}},
        "held_fns": {"_place_locked", "_tenants_of_locked",
                     "_recover_placement", "_build_pack_locked"},
    },
}

# rel path -> acquisition order (earlier entries must be taken first);
# the swap_tenants_atomically convention: container locks before any
# scorer serve_lock
LOCK_ORDER: dict[str, tuple[str, ...]] = {
    "rca/surge.py": ("_lock", "serve_lock"),
    "rca/shield.py": ("_lock", "serve_lock"),
}

# rel path -> leaf locks: no other lock is taken while one is held (the
# port's own module and instance locks; the runtime LockOrderGuard
# witnesses the same locks across calls)
LEAF_LOCKS: dict[str, frozenset] = {
    # the position-stream table (one stream per pool position)
    "parallel/compat.py": frozenset({"_STREAMS_LOCK"}),
    # one kernel build and load at a time
    "kernels/_build.py": frozenset({"_lock"}),
    # one backend build per (name, device)
    "rca/__init__.py": frozenset({"_BUILD_LOCK"}),
    # the worker's resident scorer, built once
    "workflow/worker.py": frozenset({"_scorer_lock"}),
    # the app's persistence spill ring
    "app.py": frozenset({"_spill_lock"}),
}

_LOCKISH = re.compile(r"(?i)lock$")


def _config(sf):
    cfg = GUARDED_BY.get(sf.rel, {})
    locks = {k: set(v) for k, v in cfg.get("locks", {}).items()}
    held_fns = set(cfg.get("held_fns", ()))
    for lock, attrs in sf.inline.get("guarded_by", {}).items():
        locks.setdefault(lock, set()).update(attrs)
    held_fns.update(sf.inline.get("held_fns", ()))
    order = tuple(sf.inline.get("lock_order", ())) \
        or LOCK_ORDER.get(sf.rel, ())
    leaves = set(LEAF_LOCKS.get(sf.rel, ())) | set(
        sf.inline.get("leaf_locks", ()))
    return locks, held_fns, order, leaves


class _LockWalk:
    def __init__(self, sf, locks: dict, held_fns: set, order: tuple,
                 leaves: set):
        self.sf, self.locks, self.held_fns, self.order, self.leaves = \
            sf, locks, held_fns, order, leaves
        self.attr_to_lock = {a: lk for lk, attrs in locks.items()
                             for a in attrs}
        self.known = set(locks) | set(order) | leaves

    def run(self) -> None:
        for node in self.sf.tree.body:
            self.walk(node, held=frozenset(), exempt=False)

    def walk(self, node, held: frozenset, exempt: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name == "__init__" or node.name in self.held_fns:
                exempt = True
            for child in node.body:
                self.walk(child, held, exempt)
            return
        if isinstance(node, ast.With):
            acquired = []
            for item in node.items:
                name = _dotted(item.context_expr).rsplit(".", 1)[-1]
                if name in self.known or (self.leaves
                                          and _LOCKISH.search(name)):
                    self.check_order(name, held, item.context_expr.lineno)
                    acquired.append(name)
                else:
                    self.visit_exprs(item.context_expr, held, exempt)
            inner = held.union(acquired)
            for child in node.body:
                self.walk(child, inner, exempt)
            return
        self.visit_exprs(node, held, exempt)

    def visit_exprs(self, node, held: frozenset, exempt: bool) -> None:
        """Flag guarded-attribute accesses; recurse through compound
        statements so nested With blocks keep extending the held set."""
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.With)):
                self.walk(child, held, exempt)
                continue
            if isinstance(child, ast.Attribute):
                lock = self.attr_to_lock.get(child.attr)
                if lock is not None and lock not in held and not exempt:
                    self.sf.hit(
                        "lock-guard", child.lineno,
                        f"'{child.attr}' is guarded by '{lock}' "
                        f"(GUARDED_BY) but accessed outside a `with "
                        f"{lock}` scope: torn reads/lost updates across "
                        "the serve/swap seam; hold the lock, move the "
                        "access into a held_fns seam, or waive an "
                        "advisory read with the race argument")
            self.visit_exprs(child, held, exempt)

    def check_order(self, name: str, held: frozenset, line: int) -> None:
        for h in sorted(held & self.leaves - {name}):
            self.sf.hit(
                "lock-order", line,
                f"'{name}' acquired while holding the leaf lock '{h}' "
                "(LEAF_LOCKS): a leaf lock is never held while another "
                "lock is taken")
        if name not in self.order:
            return
        rank = self.order.index(name)
        for h in held:
            if h in self.order and self.order.index(h) > rank:
                self.sf.hit(
                    "lock-order", line,
                    f"'{name}' acquired while holding '{h}' inverts the "
                    f"declared order {self.order} (the "
                    "swap_tenants_atomically convention: container locks "
                    "before scorer serve_locks): this is the static "
                    "half of the deadlock-cycle guard")


def check(sf) -> None:
    locks, held_fns, order, leaves = _config(sf)
    if not locks and not order and not leaves:
        return
    _LockWalk(sf, locks, held_fns, order, leaves).run()
