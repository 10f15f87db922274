"""graft-audit for the port: the reference's static passes, with torch
rules where the reference's key on a JAX idiom, and the runtime guards
that only a run can exercise.

The reference (``kubernetes_aiops_evidence_graph_tpu/analysis``) holds the
hot path and the serving state to machine-checked rules. The port copied
the locking, the journals and the ladders; this package checks that it
still keeps them:

* **Pass 2, AST lint** (:mod:`.ast_lint`): wall-clock durations, broad
  excepts (and the stricter recovery rule), torch ``host-sync`` (every
  device->host sync in the hot dirs outside a declared fetch seam), and
  the kernel rules (``kernel-undeclared``: every launch entry in
  ``kernels/`` is declared with its plain twin; ``kernel-fallback``: the
  twin runs only for CPU tensors, never from an except handler).
* **Pass 3, runtime guards** (:mod:`.runtime_guards`): the sync guard
  over a tick's dispatch, the build fence, the resident-pointer check
  and the lock-order witness; ``chip_smoke.py`` drives them on the card.
* **Pass 4, sentinel** (:mod:`.sentinel`, :mod:`.locks`,
  :mod:`.ordering`): the GUARDED_BY lock discipline, the acquisition
  order and leaf locks, WAL/ledger write-ahead-of-mutation dominance, and
  the waiver-hygiene gate.
* **Pass 5, lattice** (:mod:`.ladders`, :mod:`.dispatch_lattice`): the
  ladders' shape contracts and the reachability of every serving tier.

Pass 1 (jaxpr audit), the cost ratchet and the reference's rules keyed
to tracing, donation, compiles and the Pallas DMA protocol have no
counterpart here: ``findings.NO_COUNTERPART`` names each with its reason.

CLI: ``python -m kubernetes_aiops_evidence_graph_tpu_torch.analysis
[--report json]`` exits non-zero on an unwaived finding. The static
passes are stdlib-only: importing this package imports no torch.
"""
from __future__ import annotations

from .findings import Finding, Report

__all__ = ["Finding", "Report", "run_audit"]


def run_audit(root=None, sentinel: bool = True,
              lattice: bool = True) -> Report:
    """Run the static passes over ``root`` (default: the port's package;
    a fixture tree in tests) and return the combined Report."""
    from .ast_lint import lint_tree
    report = Report()
    report.extend(lint_tree(root))
    if sentinel:
        from .sentinel import run_sentinel
        report.extend(run_sentinel(root))
    if lattice:
        from .dispatch_lattice import run_lattice
        from .ladders import run_ladders
        report.extend(run_ladders(root))
        report.extend(run_lattice(root))
    return report
