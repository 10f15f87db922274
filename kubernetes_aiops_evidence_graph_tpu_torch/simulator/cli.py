"""Simulator CLI — fault injection + end-to-end RCA, hermetically.

The reference CLI (incident_simulator.py:274-314) applies failing workloads
to a live cluster and the operator watches Temporal. Here the same verbs run
the whole pipeline in-process: ``list`` shows scenarios, ``run`` injects one
or more scenarios into a generated cluster, collects evidence, builds the
graph, scores RCA on the chosen backend, and prints a JSON report.

    python -m kubernetes_aiops_evidence_graph_tpu_torch.simulator.cli run \
        -s crashloop_deploy -s oom --pods 200 --backend both

The port's copy of the JAX package's ``kaeg-sim``: the same verbs, flags
and report. ``run`` scores the ``tpu`` backend with the rules kernel
(``kernels/rules_fold``) on ``--device`` (default: the CUDA device, which
raises without one; ``--device cpu`` runs the kernel's plain version).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _cmd_list() -> int:
    from .scenarios import SCENARIOS
    for name, s in sorted(SCENARIOS.items()):
        print(f"{name:20s} alert={s.alertname:22s} expected_rule={s.expected_rule}")
    return 0


def _cmd_run(args: argparse.Namespace) -> int:
    from ..collectors import collect_all, default_collectors
    from ..config import load_settings
    from ..graph import GraphBuilder, build_snapshot
    from ..rca import RULES, get_backend
    from .scenarios import SCENARIOS, inject
    from .topology import generate_cluster

    for s in args.scenario:
        if s not in SCENARIOS:
            print(f"unknown scenario {s!r}; see `list`", file=sys.stderr)
            return 2
    # the device before any work: no card and no --device cpu raises here
    backend = (get_backend("tpu", device=args.device)
               if args.backend in ("tpu", "both") else None)

    settings = load_settings()
    cluster = generate_cluster(num_pods=args.pods, seed=args.seed)
    deploy_keys = sorted(cluster.deployments)
    rng = np.random.default_rng(args.seed)

    incidents = [
        inject(cluster, name, deploy_keys[(i * 7) % len(deploy_keys)], rng)
        for i, name in enumerate(args.scenario)
    ]
    builder = GraphBuilder()
    evidence = {}
    for inc in incidents:
        results = collect_all(inc, default_collectors(cluster, settings))
        builder.ingest(inc, results)
        evidence[inc.id] = [ev.model_dump(mode="json") for r in results for ev in r.evidence]

    report: dict = {"pods": args.pods, "incidents": []}
    snapshot = None
    if backend is not None:
        snapshot = build_snapshot(builder.store, settings, now_s=cluster.now.timestamp())
        raw = backend.score_snapshot(snapshot)
        report["graph"] = {
            "nodes": snapshot.num_nodes, "edges": snapshot.num_edges,
            "padded_nodes": snapshot.padded_nodes,
            "device_seconds": round(raw["device_seconds"], 4),
        }
    for i, inc in enumerate(incidents):
        entry = {
            "scenario": inc.labels.get("scenario"),
            "incident": str(inc.id),
            "expected_rule": SCENARIOS[inc.labels["scenario"]].expected_rule,
        }
        if args.backend in ("cpu", "both"):
            top = get_backend("cpu").score_incident(inc.id, evidence[inc.id]).top_hypothesis
            entry["cpu_top1"] = {"rule": top.rule_id, "confidence": top.confidence,
                                 "score": top.final_score}
        if backend is not None:
            row = list(raw["incident_ids"]).index(f"incident:{inc.id}")
            rule = RULES[int(raw["top_rule_index"][row])].id if raw["any_match"][row] else "unknown"
            entry["tpu_top1"] = {"rule": rule,
                                 "confidence": round(float(raw["top_confidence"][row]), 3),
                                 "score": round(float(raw["top_score"][row]), 4)}
        report["incidents"].append(entry)
    print(json.dumps(report, indent=2))
    return 0


def _live_injector(args: argparse.Namespace):
    from ..collectors.live import LiveClusterBackend
    from ..config import load_settings
    from .live_faults import LiveFaultInjector

    backend = LiveClusterBackend(load_settings(),
                                 k8s_url=args.k8s_url or None)
    return LiveFaultInjector(backend)


def _cmd_create(args: argparse.Namespace) -> int:
    created = _live_injector(args).create(args.scenario, args.namespace)
    print(json.dumps({"created": created}))
    return 0 if created else 1


def _cmd_cleanup(args: argparse.Namespace) -> int:
    removed = _live_injector(args).cleanup(args.namespace)
    print(json.dumps({"removed": removed}))
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="kaeg-sim", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="list fault scenarios")
    run = sub.add_parser("run", help="inject scenarios and run RCA hermetically")
    run.add_argument("-s", "--scenario", action="append", required=True)
    run.add_argument("--pods", type=int, default=200)
    run.add_argument("--seed", type=int, default=0)
    run.add_argument("--backend", choices=("cpu", "tpu", "both"), default="both")
    run.add_argument("--device", default=None,
                     help="device of the tpu backend (default: cuda; "
                          "cpu runs the rules kernel's plain version)")
    # live-cluster fault injection (reference incident_simulator.py:274-314)
    create = sub.add_parser("create", help="apply a failing workload to a live cluster")
    create.add_argument("-s", "--scenario", required=True,
                        choices=("crashloop", "oom", "imagepull", "slowapp"))
    create.add_argument("-n", "--namespace", default="default")
    create.add_argument("--k8s-url", default="")
    cleanup = sub.add_parser("cleanup", help="remove injected workloads (label simulator=kaeg-test)")
    cleanup.add_argument("-n", "--namespace", default="default")
    cleanup.add_argument("--k8s-url", default="")
    args = parser.parse_args(argv)
    if args.cmd == "list":
        return _cmd_list()
    if args.cmd == "create":
        return _cmd_create(args)
    if args.cmd == "cleanup":
        return _cmd_cleanup(args)
    return _cmd_run(args)


if __name__ == "__main__":
    raise SystemExit(main())
