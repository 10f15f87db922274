"""graft-audit CLI for the port.

    python -m kubernetes_aiops_evidence_graph_tpu_torch.analysis [--report json]
    python -m kubernetes_aiops_evidence_graph_tpu_torch.analysis --waivers

Exit status 0 = zero unwaived findings; 1 = findings. Runs pass 2 (AST
lint), pass 4 (sentinel: lock discipline and WAL/ledger order) and pass
5 (lattice: ladder contracts and tier reachability) over the port's
package, or over ``--root`` (a fixture tree). ``--waivers`` lists every
``# graft-audit: allow[rule] reason`` pragma and exits non-zero if any
lacks a reason. Stdlib-only: it imports no torch.
"""
from __future__ import annotations

import argparse
import json


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="graft-audit", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--report", choices=("text", "json"), default="text")
    ap.add_argument("--root", default=None,
                    help="audit this tree instead of the port's package")
    ap.add_argument("--skip-sentinel", action="store_true",
                    help="skip pass 4 (lock discipline, WAL/ledger order)")
    ap.add_argument("--skip-lattice", action="store_true",
                    help="skip pass 5 (ladder contracts, tier reachability)")
    ap.add_argument("--waivers", action="store_true",
                    help="list every waiver pragma with its location, rules "
                         "and reason, then exit (non-zero if any waiver "
                         "has no reason)")
    args = ap.parse_args(argv)

    if args.waivers:
        from .sentinel import collect_waivers
        entries = collect_waivers(args.root)
        bare = [e for e in entries if not e["reason"]]
        if args.report == "json":
            print(json.dumps({"waivers": entries,
                              "missing_reason": len(bare)}, indent=2))
        else:
            for e in entries:
                flag = "" if e["reason"] else "  <-- MISSING REASON"
                print(f"{e['where']} [{', '.join(e['rules'])}] "
                      f"{e['reason']}{flag}")
            print(f"graft-audit: {len(entries)} waiver(s), "
                  f"{len(bare)} missing a reason")
        return 1 if bare else 0

    from . import run_audit
    report = run_audit(args.root, sentinel=not args.skip_sentinel,
                       lattice=not args.skip_lattice)
    print(report.to_json() if args.report == "json" else report.to_text())
    return report.exit_code


if __name__ == "__main__":
    raise SystemExit(main())
