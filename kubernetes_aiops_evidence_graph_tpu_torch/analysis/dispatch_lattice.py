"""Pass 5, dispatch half: every serving tier the port declares is
reachable by some setting (``lattice-unreachable``).

The learned scorer picks its tier per dispatch in
``GnnStreamingScorer._call_gnn_tick`` (``rca/gnn_streaming.py``): the
streamed tier (B4; f32, bf16 or int8 feature table) when ``_dma_ok``,
else the fused tier (B3) when ``_fused_ok``, else the composed tick
(B2). ``_tick_entrypoint`` labels the choice for the roofline, the
sharded mirror serves the sharded composed tick, and the rules tick (B1)
serves beside every one of them (``StreamingScorer._scope_entrypoint``).

This module re-derives that choice statically. :func:`resolve_entry`
mirrors the gate chain over the settings axes, :func:`reachable_entries`
runs it over every combination, and :func:`check_unreachable` reads the
tier labels the source declares (the string constants
``_tick_entrypoint`` and ``_scope_entrypoint`` return) and flags:

* a declared label no settings combination reaches (a dead tier, or
  the mirror below stopped agreeing with the dispatcher);
* a declared tier whose tick function :data:`TIER_CALLS` names is no
  longer reached from ``_call_gnn_tick`` through the module's own
  functions (the dispatcher stopped selecting it).

The reference's ``warm-gap`` (warm-path coverage) and ``retrace-*``
rules have no counterpart: a kernel compiles once, before its first
launch, and nothing retraces.

Fixture trees participate via a module-level literal::

    GRAFT_LATTICE = {
        "reachable": ["tick.a", "tick.b"],   # serve-reachable entries
        "declared": ["tick.a", "tick.b"],    # declared entries
    }

and a declared entry absent from ``reachable`` is a
``lattice-unreachable``. Stdlib-only.
"""
from __future__ import annotations

import ast
from itertools import product
from pathlib import Path

from .ast_lint import _call_name, _inline_literal, package_root
from .findings import Finding, Report
from .sentinel import _comment_waivers

# settings axes the serve path dispatches over
QUANTS = ("", "bfloat16", "int8")                   # gnn_feature_quant
COMPUTE_DTYPES = (None, "bfloat16")                 # gnn_compute_dtype
SHARDS = (1, 2)                                     # serve_graph_shards

# the module that chooses the learned tier, its seam, and the module
# that labels the rules tick
GNN_MODULE = "rca/gnn_streaming.py"
SEAM = "_call_gnn_tick"
LABELERS = ((GNN_MODULE, "_tick_entrypoint"),
            ("rca/streaming.py", "_scope_entrypoint"))

# declared tier -> the function _call_gnn_tick must reach to serve it
TIER_CALLS = {
    "streaming.gnn_tick.bucketed": "_gnn_tick",
    "streaming.gnn_tick.fused": "_gnn_fused_tick",
    "streaming.gnn_tick.fused.bf16": "_gnn_fused_tick",
    "streaming.gnn_tick.dma": "_gnn_dma_tick",
    "streaming.gnn_tick.dma.bf16": "_gnn_dma_tick_q",
    "streaming.gnn_tick.dma.int8": "_gnn_dma_tick_q",
}


def resolve_entry(*, fused: bool, dma: bool, compute: "str | None",
                  quant: str, sharded: bool) -> str:
    """The label of the learned tick one settings combination serves: the
    static mirror of ``_call_gnn_tick`` + ``_tick_entrypoint``. A quant
    table without ``gnn_tick_dma`` selects nothing (f32 features); both
    kernel tiers need compute None or bf16."""
    if sharded:
        return "streaming.gnn_tick.sharded"
    kernel_ok = compute in (None, "bfloat16")
    if dma and kernel_ok:
        suffix = {"int8": ".int8", "bfloat16": ".bf16"}.get(quant, "")
        return f"streaming.gnn_tick.dma{suffix}"
    if fused and kernel_ok:
        return ("streaming.gnn_tick.fused.bf16" if compute == "bfloat16"
                else "streaming.gnn_tick.fused")
    return "streaming.gnn_tick.bucketed"


def reachable_entries() -> set[str]:
    """Every label some settings combination serves: the learned tick's,
    and the rules tick's, which serves alongside it, sharded or not."""
    out = {resolve_entry(fused=fused, dma=dma, compute=compute, quant=quant,
                         sharded=shards > 1)
           for fused, dma, compute, quant, shards in product(
               (False, True), (False, True), COMPUTE_DTYPES, QUANTS, SHARDS)}
    return out | {"streaming.rules_tick", "streaming.rules_tick.sharded"}


def declared_entries(base: Path) -> dict[str, tuple[str, int]]:
    """label -> (module, source line), for every string constant the
    labelers return."""
    out: dict[str, tuple[str, int]] = {}
    for rel, fn in LABELERS:
        path = base / rel
        if not path.is_file():
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.FunctionDef) and node.name == fn:
                for ret in ast.walk(node):
                    if not isinstance(ret, ast.Return) or ret.value is None:
                        continue
                    for c in ast.walk(ret.value):
                        if isinstance(c, ast.Constant) and isinstance(
                                c.value, str) and c.value.startswith(
                                "streaming."):
                            out.setdefault(c.value, (rel, c.lineno))
    return out


def _seam_reaches(source: str) -> set[str]:
    """Bare names of every call reachable from :data:`SEAM` through the
    module's own functions."""
    defs: dict[str, set] = {}
    for n in ast.walk(ast.parse(source)):
        if isinstance(n, ast.FunctionDef):
            defs.setdefault(n.name, set()).update(
                _call_name(c).rsplit(".", 1)[-1]
                for c in ast.walk(n) if isinstance(c, ast.Call))
    seen, todo, calls = set(), [SEAM], set()
    while todo:
        fn = todo.pop()
        if fn in seen or fn not in defs:
            continue
        seen.add(fn)
        calls |= defs[fn]
        todo.extend(defs[fn])
    return calls


def check_unreachable(base: "Path | None" = None) -> list[Finding]:
    """``lattice-unreachable`` over the port's tree (``base``, default the
    package)."""
    base = Path(base) if base is not None else package_root()
    declared = declared_entries(base)
    reached = reachable_entries()
    gnn = base / GNN_MODULE
    calls = _seam_reaches(gnn.read_text()) if gnn.is_file() else set()
    out: list[Finding] = []

    def hit(label: str, message: str) -> None:
        rel, line = declared[label]
        waivers = _comment_waivers((base / rel).read_text())
        waived, reason = False, ""
        for ln in (line, line - 1):
            w = waivers.get(ln)
            if w and ("lattice-unreachable" in w[0] or "all" in w[0]):
                waived, reason = True, w[1]
                break
        out.append(Finding(
            rule="lattice-unreachable", where=f"{rel}:{line}",
            message=message, pass_name="lattice", waived=waived,
            waiver_reason=reason))

    for label in sorted(declared):
        if label not in reached:
            hit(label, f"declared tier '{label}' is reachable by no "
                       "enumerated settings combination: a dead tier, or "
                       "dispatch_lattice.resolve_entry no longer mirrors "
                       "the dispatcher")
        elif label in TIER_CALLS and TIER_CALLS[label] not in calls:
            hit(label, f"declared tier '{label}' needs "
                       f"'{TIER_CALLS[label]}', which {SEAM} no longer "
                       "reaches: the dispatcher stopped selecting it")
    return out


def _check_fixture_tree(base: Path) -> list[Finding]:
    out: list[Finding] = []
    for path in sorted(base.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        source = path.read_text()
        if "GRAFT_LATTICE" not in source:
            continue
        try:
            tree = ast.parse(source)
        except SyntaxError:
            continue
        decl = _inline_literal(tree, "GRAFT_LATTICE")
        if not isinstance(decl, dict):
            continue
        lineno = next(n.lineno for n in tree.body
                      if isinstance(n, ast.Assign)
                      and getattr(n.targets[0], "id", "") == "GRAFT_LATTICE")
        rel = path.relative_to(base).as_posix()
        waivers = _comment_waivers(source)
        reachable = set(decl.get("reachable", ()))
        for entry in decl.get("declared", ()):
            if entry in reachable:
                continue
            waived, reason = False, ""
            for ln in (lineno, lineno - 1):
                w = waivers.get(ln)
                if w and ("lattice-unreachable" in w[0] or "all" in w[0]):
                    waived, reason = True, w[1]
                    break
            out.append(Finding(
                rule="lattice-unreachable", where=f"{rel}:{lineno}",
                message=f"declared entry '{entry}' is not reachable",
                pass_name="lattice", waived=waived, waiver_reason=reason))
    return out


def run_lattice(root: "Path | str | None" = None) -> Report:
    """The port's tree (``root`` None, or a copy of the package that
    holds its gnn_streaming module) or the ``GRAFT_LATTICE`` literals of
    a fixture tree."""
    report = Report()
    if root is None or (Path(root) / GNN_MODULE).is_file():
        report.findings.extend(check_unreachable(root))
    else:
        report.findings.extend(_check_fixture_tree(Path(root)))
    return report
