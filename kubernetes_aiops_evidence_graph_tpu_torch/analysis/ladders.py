"""Pass 5, ladder half: the contracts of every bucket ladder of the port.

The rungs themselves live in the port's ``ladders.py`` (the one declared
set every padded shape is drawn from, equal to the reference's
registry). A CUDA kernel takes its sizes at launch and compiles once, so
here a ladder bounds host staging buffers and the padding the kernels
walk, and its tile quanta decide whether a kernel's tiles straddle a
capacity. The checks:

* ``ladder-gap``: a ladder is strictly increasing, its
  consecutive-rung ratio bounded (worst-case padding inflation), and
  its top rung either covers the declared 500k-pod scale target or
  declares a reachable above-ladder escalation (the rebuild path, the
  ``REL_SLICE_STEP`` rounding rule).
* ``ladder-divisibility``: tiling quanta divide every capacity drawn
  from the ladder: ``EDGE_TILE`` divides every relation-slice rung AND
  the above-ladder step (the fused tick requires tile-aligned slices),
  and the streamed tick's node block aligns with every node rung
  (``pn % min(node_block, pn) == 0``).

Fixture trees declare ladders inline with a module-level literal::

    GRAFT_LADDERS = {
        "my_ladder": {"rungs": [64, 256], "max_gap_ratio": 4.0,
                      "covers": 500, "escalation": "none",
                      "divisor": 64, "step": 0},
    }

Stdlib-only: the port's ``ladders.py`` holds constants and imports
nothing.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path

from .. import ladders as rungs
from .findings import Finding, Report

# scale target the topology ladders must reach
MAX_PODS = 500_000


@dataclass(frozen=True)
class Ladder:
    """One declared bucket ladder and its contracts.

    ``escalation`` names the above-ladder path: ``"rebuild"`` (bucket
    overflow escalates to the store-derived rebuild, NeedsRebuild),
    ``"step"`` (counts beyond the top rung round to ``step`` multiples,
    the rel_slice_offsets rule), or ``"none"`` (the top rung must cover
    ``covers`` outright). ``divisor`` must divide every rung;
    ``divisor_min`` relaxes it to the ``min(divisor, rung)`` alignment
    rule the streamed tier checks."""
    name: str
    rungs: tuple
    defined_in: str               # "module.py:ATTR" provenance
    max_gap_ratio: float = 4.0
    covers: int = 0               # 0 = no coverage target
    escalation: str = "none"      # "rebuild" | "step" | "none"
    step: int = 0                 # above-ladder rounding (escalation="step")
    divisor: int = 0              # 0 = no divisibility contract
    divisor_min: bool = False     # min(divisor, rung) alignment semantics


# every ladder of the port, with its contracts (the reference's, minus
# the snapshot-path edge ladders the port does not carry)
LADDERS: tuple[Ladder, ...] = (
    Ladder("delta", rungs.DELTA_BUCKETS, "ladders.py:DELTA_BUCKETS",
           covers=MAX_PODS, escalation="rebuild"),
    Ladder("row", rungs.ROW_BUCKETS, "ladders.py:ROW_BUCKETS",
           escalation="rebuild"),
    Ladder("width", rungs.WIDTH_BUCKETS, "ladders.py:WIDTH_BUCKETS",
           max_gap_ratio=2.0, escalation="rebuild"),
    Ladder("pair_width", rungs.PAIR_WIDTH_BUCKETS,
           "ladders.py:PAIR_WIDTH_BUCKETS", max_gap_ratio=2.0,
           escalation="rebuild"),
    Ladder("pack", rungs.PACK_BUCKETS, "ladders.py:PACK_BUCKETS",
           escalation="rebuild"),
    Ladder("rel_slice", rungs.REL_SLICE_BUCKETS,
           "ladders.py:REL_SLICE_BUCKETS", max_gap_ratio=2.0,
           covers=8 * MAX_PODS, escalation="step",
           step=rungs.REL_SLICE_STEP, divisor=rungs.EDGE_TILE),
    Ladder("node", rungs.NODE_BUCKET_SIZES, "ladders.py:NODE_BUCKET_SIZES",
           covers=MAX_PODS, divisor=rungs.DMA_NODE_BLOCK, divisor_min=True),
    Ladder("incident", rungs.INCIDENT_BUCKET_SIZES,
           "ladders.py:INCIDENT_BUCKET_SIZES", escalation="rebuild"),
)


def check_ladder(lad: Ladder, where: str) -> list[Finding]:
    """The static contracts for ONE ladder (pure, stdlib-only)."""
    out: list[Finding] = []

    def hit(rule: str, msg: str) -> None:
        out.append(Finding(rule=rule, where=where,
                           message=f"ladder '{lad.name}': {msg}",
                           pass_name="lattice"))

    steps = tuple(int(r) for r in lad.rungs)
    if not steps:
        hit("ladder-gap", "declared with no rungs")
        return out
    if steps[0] <= 0:
        hit("ladder-gap", f"rung {steps[0]} is not positive")
    for lo, hi in zip(steps[:-1], steps[1:]):
        if hi <= lo:
            hit("ladder-gap",
                f"rungs not strictly increasing at {lo} -> {hi} "
                "(bucket_for would never select the shadowed rung)")
        elif lo > 0 and hi / lo > lad.max_gap_ratio:
            hit("ladder-gap",
                f"rung gap {lo} -> {hi} exceeds the {lad.max_gap_ratio:g}x "
                "padding-inflation bound: a count just past the lower "
                f"rung pads to more than {lad.max_gap_ratio:g}x its live "
                "size")
    if lad.covers:
        top = steps[-1]
        if lad.escalation == "step":
            if lad.step <= 0:
                hit("ladder-gap",
                    "declares step escalation with no rounding step: "
                    "counts beyond the top rung have no planned capacity")
        elif lad.escalation == "none" and top < lad.covers:
            hit("ladder-gap",
                f"top rung {top} does not cover the declared scale "
                f"target {lad.covers} and no above-ladder escalation is "
                "declared")
    elif lad.escalation == "step" and lad.step <= 0:
        hit("ladder-gap", "step escalation with no rounding step")
    if lad.divisor:
        for r in steps:
            if lad.divisor_min:
                ok = (r % lad.divisor == 0 if r >= lad.divisor
                      else lad.divisor % r == 0)
            else:
                ok = r % lad.divisor == 0
            if not ok:
                hit("ladder-divisibility",
                    f"rung {r} does not align with the declared quantum "
                    f"{lad.divisor} (tiles/blocks would straddle a "
                    "capacity boundary)")
        if lad.step and lad.step % lad.divisor != 0:
            hit("ladder-divisibility",
                f"above-ladder step {lad.step} is not a multiple of the "
                f"quantum {lad.divisor}: beyond-top capacities would lose "
                "tile alignment exactly when slices are largest")
    return out


def _fixture_ladders(path: Path, rel: str) -> list[tuple[Ladder, str]]:
    """Module-level ``GRAFT_LADDERS = {...}`` literals (fixture trees)."""
    try:
        tree = ast.parse(path.read_text())
    except SyntaxError:
        return []
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "GRAFT_LADDERS"):
            try:
                decl = ast.literal_eval(node.value)
            except (ValueError, SyntaxError):
                return []
            if not isinstance(decl, dict):
                return []
            where = f"{rel}:{node.lineno}"
            return [(Ladder(
                name=str(name), rungs=tuple(spec.get("rungs", ())),
                defined_in=where,
                max_gap_ratio=float(spec.get("max_gap_ratio", 4.0)),
                covers=int(spec.get("covers", 0)),
                escalation=str(spec.get("escalation", "none")),
                step=int(spec.get("step", 0)),
                divisor=int(spec.get("divisor", 0)),
                divisor_min=bool(spec.get("divisor_min", False)),
            ), where) for name, spec in sorted(decl.items())]
    return []


def run_ladders(root: "Path | str | None" = None) -> Report:
    """Check the port's ladders (default) or every ``GRAFT_LADDERS``
    literal under a fixture ``root``."""
    report = Report()
    if root is None:
        for lad in LADDERS:
            report.findings.extend(check_ladder(lad, lad.defined_in))
        return report
    for path in sorted(Path(root).rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(root).as_posix()
        for lad, where in _fixture_ladders(path, rel):
            report.findings.extend(check_ladder(lad, where))
    return report
