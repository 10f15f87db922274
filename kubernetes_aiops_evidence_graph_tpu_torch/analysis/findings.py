"""Finding/Report model shared by the audit's passes.

A Finding is one rule hit at one location; a Report aggregates findings
across passes, separates waived sites (explicit ``# graft-audit:
allow[rule] reason`` pragmas) from violations, and serializes to the
JSON shape the CLI prints.

The rule table has three parts. :data:`RULES` holds every rule this
audit runs over the port: the reference's rules it carries unchanged
(:data:`CARRIED`) and the ones it rewrites for torch (:data:`REWRITTEN`,
each naming the reference rule it stands for). :data:`NO_COUNTERPART`
names every reference rule the port does not run, each with the reason;
``RULES`` and ``NO_COUNTERPART`` together cover the reference's table.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

# Canonical rule-id registry: id -> (pass name, one-line description).
# Every Finding(rule=...) literal in analysis/ resolves here, and
# ``--report json`` embeds the table so the report is self-describing.
RULES: dict[str, tuple[str, str]] = {
    # pass 2: AST lint
    "syntax-error": ("ast", "file failed to parse"),
    "wall-clock": ("ast", "time.time() used for durations (non-monotonic under NTP steps)"),
    "host-sync": ("ast", "device->host sync (.item/.tolist/.cpu/.numpy, float/int/bool or np.asarray of a tensor, a synchronize) in a hot module outside a declared fetch seam"),
    "broad-except": ("ast", "broad except swallows all errors"),
    "recovery-no-broad-except": ("ast", "broad except in a recovery function that neither re-raises nor escalates"),
    "kernel-undeclared": ("ast", "kernel launch entry in kernels/ missing from KERNEL_DECLARATIONS"),
    "kernel-fallback": ("ast", "a kernel's plain twin called outside a CPU-device branch or from an except handler"),
    # pass 4: sentinel (concurrency & durability)
    "lock-guard": ("sentinel", "GUARDED_BY attribute accessed outside a `with <lock>` scope"),
    "lock-order": ("sentinel", "nested lock acquisition violates the declared acquisition order"),
    "wal-order": ("sentinel", "resident-state mutation reachable before its WAL journal append"),
    "ledger-order": ("sentinel", "cluster mutation reachable before its intent-ledger row"),
    "waiver-no-reason": ("sentinel", "# graft-audit: allow[...] pragma with no reason text"),
    # pass 5: lattice (ladders and the dispatch tiers)
    "ladder-gap": ("lattice", "bucket ladder violates a declared shape contract (non-monotone, gap ratio, or coverage without escalation)"),
    "ladder-divisibility": ("lattice", "ladder rung breaks a declared divisibility contract (tile/block alignment)"),
    "lattice-unreachable": ("lattice", "declared serving tier reachable by no settings combination (dead tier)"),
}

# reference rules this audit runs exactly as the reference does: on the
# reference's own fixture trees both give the same (file, rule) set
CARRIED: frozenset = frozenset({
    "syntax-error", "wall-clock", "broad-except", "recovery-no-broad-except",
    "lock-guard", "lock-order", "wal-order", "ledger-order",
    "waiver-no-reason", "ladder-gap", "ladder-divisibility",
    "lattice-unreachable",
})

# rules rewritten for torch -> the reference rule each stands for
REWRITTEN: dict[str, str] = {
    "host-sync": "host-sync",
    "kernel-undeclared": "jit-undeclared",
    "kernel-fallback": "jit-signature",
}

# every reference rule the port does not run, with the reason
NO_COUNTERPART: dict[str, str] = {
    # pass 1 walks jaxprs; the port traces nothing
    "trace-error": "no jaxpr: the port traces nothing (pass 1 has no counterpart)",
    "no-f64": "no jaxpr: pass 1 has no counterpart; the kernels take float32 by their checks",
    "forbidden-primitive": "no jaxpr: pass 1 has no counterpart",
    "no-2d-scatter": "no jaxpr: the message pass is the hand kernel B2, which writes each destination once",
    "byte-budget": "no jaxpr: pass 1 has no counterpart",
    "bf16-accum": "no jaxpr: the kernels sum in float32 by construction (their bf16 paths round operands only)",
    "sorted-scatter-lost": "no jaxpr: the kernels' order does not depend on a sorted layout (dst-CSR built per layout)",
    # pass 2 rules keyed to jit tracing
    "tracer-branch": "nothing is traced: a Python branch runs on host values",
    "np-in-traced": "nothing is traced: numpy on the host is the host path",
    "missing-static": "no jit static arguments: a kernel takes its sizes at launch",
    "jit-undeclared": "no jit sites; rewritten as kernel-undeclared over kernels/ launch entries",
    "jit-signature": "no jit signatures; rewritten as kernel-fallback (the plain twin only on the CPU)",
    "tick-donation": "torch donates nothing; the runtime check resident_pointers() holds every resident tensor's data_ptr() across ticks",
    # pass 4 rules keyed to donation and the Pallas DMA protocol
    "use-after-donate": "torch donates nothing: a tensor stays valid after a call",
    "dma-start-no-wait": "the port's async copies (cp.async) live in CUDA C++, outside a Python AST",
    "dma-wait-no-start": "the port's async copies (cp.async) live in CUDA C++, outside a Python AST",
    "dma-double-buffer": "the port's async copies (cp.async) live in CUDA C++, outside a Python AST",
    "dma-alias": "no pallas_call input_output_aliases: the kernels write the caller's tensors in place",
    # pass 5 rules keyed to compiles
    "retrace-unbounded-static": "no jit: a kernel compiles once, so no value mints an executable",
    "retrace-weak-type": "no jit: no weak-type promotion mints an executable",
    "warm-gap": "no warm paths: a kernel compiles once, before its first launch; the runtime BuildFence stands in",
    # the cost pass prices jaxprs
    "cost-flops": "no jaxpr to price; the port's roofline is observability/scope.py and the bounds of chip_smoke.py",
    "cost-bytes": "no jaxpr to price; the port's roofline is observability/scope.py and the bounds of chip_smoke.py",
    "cost-collective-bytes": "no jaxpr to price; collectives are host-driven (parallel/compat.py)",
    "cost-baseline-missing": "no cost baseline (no jaxpr to price)",
    "cost-baseline-stale": "no cost baseline (no jaxpr to price)",
    "forbidden-collective": "no jaxpr collectives: collectives are host-driven calls in parallel/compat.py",
    "collective-count": "no jaxpr collectives: collectives are host-driven calls in parallel/compat.py",
    "collective-bytes": "no jaxpr collectives: collectives are host-driven calls in parallel/compat.py",
}


@dataclass(frozen=True)
class Finding:
    rule: str            # a key of RULES, e.g. "host-sync"
    where: str           # "path:line"
    message: str
    pass_name: str       # "ast" | "sentinel" | "lattice"
    waived: bool = False
    waiver_reason: str = ""

    def to_dict(self) -> dict:
        d = {"rule": self.rule, "where": self.where,
             "message": self.message, "pass": self.pass_name}
        if self.waived:
            d["waived"] = True
            d["waiver_reason"] = self.waiver_reason
        return d


@dataclass
class Report:
    findings: list[Finding] = field(default_factory=list)

    def extend(self, other: "Report | list[Finding]") -> None:
        self.findings.extend(other.findings if isinstance(other, Report)
                             else other)

    @property
    def violations(self) -> list[Finding]:
        return [f for f in self.findings if not f.waived]

    @property
    def waivers(self) -> list[Finding]:
        return [f for f in self.findings if f.waived]

    @property
    def exit_code(self) -> int:
        return 1 if self.violations else 0

    def to_dict(self) -> dict:
        return {
            "tool": "graft-audit",
            "ok": not self.violations,
            "summary": {"violations": len(self.violations),
                        "waived": len(self.waivers)},
            "violations": [f.to_dict() for f in self.violations],
            "waived": [f.to_dict() for f in self.waivers],
            "rules": {rid: {"pass": p, "description": d}
                      for rid, (p, d) in sorted(RULES.items())},
            "no_counterpart": dict(sorted(NO_COUNTERPART.items())),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    def to_text(self) -> str:
        lines = [f"VIOLATION [{f.pass_name}/{f.rule}] {f.where}: {f.message}"
                 for f in self.violations]
        lines += [f"waived    [{f.pass_name}/{f.rule}] {f.where}: "
                  f"{f.waiver_reason or f.message}" for f in self.waivers]
        lines.append(f"graft-audit: {len(self.violations)} violation(s), "
                     f"{len(self.waivers)} waived site(s)")
        return "\n".join(lines)
