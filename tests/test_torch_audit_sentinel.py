"""The port's sentinel and lattice passes (``kubernetes_aiops_evidence_graph_
tpu_torch/analysis``, passes 4 and 5) against the reference's, and the
port's self-audit.

* Parity: on the reference's sentinel and lattice fixture trees the
  port's passes give the reference's (file, rule) set for every carried
  rule (lock-guard, lock-order, wal-order, ledger-order,
  waiver-no-reason; ladder-gap, ladder-divisibility,
  lattice-unreachable), and none of the rules the port does not run
  (use-after-donate, the dma-* rules, warm-gap, retrace-*).
* Seeded and mutated port code: a heal that adopts its mesh before
  ``_journal_mesh``, a leaf lock held round another, ``with
  self.serve_lock`` stripped from the learned scorer's swap seam, a
  ``journal.append`` moved below its swap in the shield, and a tier
  dropped from ``_call_gnn_tick`` are each caught.
* The port audits clean (every waiver carries its reason), its ladders
  keep their contracts and equal the reference's rungs, and the CLI
  exits 0 on the port and non-zero on the bad fixtures.
"""
import json
import shutil
from pathlib import Path

import pytest

from kubernetes_aiops_evidence_graph_tpu.analysis import ladders as jax_ladders
from kubernetes_aiops_evidence_graph_tpu.analysis.ladders import (
    run_ladders as jax_run_ladders)
from kubernetes_aiops_evidence_graph_tpu.analysis.sentinel import (
    run_sentinel as jax_run_sentinel)
from kubernetes_aiops_evidence_graph_tpu.analysis.warm_check import (
    run_warm_check as jax_run_warm_check)
from kubernetes_aiops_evidence_graph_tpu_torch.analysis import run_audit
from kubernetes_aiops_evidence_graph_tpu_torch.analysis.__main__ import (
    main as audit_main)
from kubernetes_aiops_evidence_graph_tpu_torch.analysis.ast_lint import (
    package_root)
from kubernetes_aiops_evidence_graph_tpu_torch.analysis.dispatch_lattice import (
    TIER_CALLS, declared_entries, reachable_entries, run_lattice)
from kubernetes_aiops_evidence_graph_tpu_torch.analysis.findings import (
    CARRIED, NO_COUNTERPART)
from kubernetes_aiops_evidence_graph_tpu_torch.analysis.ladders import (
    LADDERS, run_ladders)
from kubernetes_aiops_evidence_graph_tpu_torch.analysis.sentinel import (
    collect_waivers, run_sentinel)

FIXTURES = Path(__file__).parent / "fixtures"

HEAL_BEFORE_JOURNAL = '''
class ShieldedScorer:
    def _journal_mesh(self, shards, excluded, d_old):
        seq = int(self.scorer._synced_seq)
        self.journal.append((), seq, seq, kind="mesh_heal", shards=shards)
        return seq

    def reexpand(self, mesh, d_new, d_old):
        s = self.scorer
        with s.serve_lock:
            s.adopt_mesh(mesh)              # the mesh moves first
            return self._journal_mesh(d_new, (), d_old)

    def mesh_heal(self, mesh, d_new, d_old):
        s = self.scorer
        with s.serve_lock:
            gen = self._journal_mesh(d_new, (), d_old)
            s.adopt_mesh(mesh)              # journaled first: fine
            return gen
'''

LEAF_NESTING = '''
import threading

GRAFT_SENTINEL = {"leaf_locks": ["_table_lock"]}

_table_lock = threading.Lock()


class Pool:
    def __init__(self):
        self.serve_lock = threading.Lock()

    def take(self):
        with self.serve_lock:
            with _table_lock:               # a leaf inside: fine
                return 1

    def broken(self):
        with _table_lock:
            with self.serve_lock:           # another lock under the leaf
                return 2
'''


def _carried(report, waived: bool) -> set:
    return {(f.where.rsplit(":", 1)[0], f.rule) for f in report.findings
            if f.rule in CARRIED and f.waived == waived}


def _line_of(source: str, marker: str) -> int:
    return next(i for i, line in enumerate(source.splitlines(), start=1)
                if marker in line)


def _copy_into(tmp_path: Path, rel: str) -> Path:
    dst = tmp_path / rel
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(package_root() / rel, dst)
    return dst


@pytest.mark.parametrize("tree", ["sentinel/bad", "sentinel/clean"])
def test_carried_sentinel_rules_match_the_reference(tree):
    root = FIXTURES / tree
    mine, ref = run_sentinel(root), jax_run_sentinel(root)
    assert _carried(mine, False) == _carried(ref, False)
    assert _carried(mine, True) == _carried(ref, True)
    assert {f.rule for f in mine.findings} <= CARRIED
    if tree == "sentinel/bad":
        # the reference's donation and DMA fixtures find no port rule
        assert {f.rule for f in ref.findings} - CARRIED <= set(NO_COUNTERPART)
        assert len(mine.violations) == 5


@pytest.mark.parametrize("tree", ["lattice/bad", "lattice/clean"])
def test_carried_lattice_rules_match_the_reference(tree):
    root = FIXTURES / tree
    mine = run_ladders(root)
    mine.extend(run_lattice(root))
    ref = jax_run_ladders(root)
    ref.extend(jax_run_warm_check(root))
    assert _carried(mine, False) == _carried(ref, False)
    assert {f.rule for f in mine.findings} <= CARRIED
    if tree == "lattice/bad":
        assert {r for _, r in _carried(mine, False)} == {
            "ladder-gap", "ladder-divisibility", "lattice-unreachable"}


def test_a_heal_that_adopts_its_mesh_before_journaling_is_caught(tmp_path):
    dst = tmp_path / "rca" / "shield.py"
    dst.parent.mkdir()
    dst.write_text(HEAL_BEFORE_JOURNAL)
    found = run_sentinel(tmp_path).findings
    assert [(f.where, f.rule) for f in found] == [
        (f"rca/shield.py:{_line_of(HEAL_BEFORE_JOURNAL, 'moves first')}",
         "wal-order")]


def test_another_lock_taken_under_a_leaf_lock_is_caught(tmp_path):
    (tmp_path / "pool.py").write_text(LEAF_NESTING)
    found = run_sentinel(tmp_path).findings
    assert [(f.where, f.rule) for f in found] == [
        (f"pool.py:{_line_of(LEAF_NESTING, 'under the leaf')}",
         "lock-order")]


def test_stripping_a_serve_lock_from_gnn_streaming_is_caught(tmp_path):
    """The learned scorer's swap seam flips ``_params`` and
    ``params_generation`` under ``serve_lock`` (the lock the tick caller
    holds round ``dispatch``): deleting the first ``with
    self.serve_lock:`` is the mutation GUARDED_BY exists to catch."""
    dst = _copy_into(tmp_path, "rca/gnn_streaming.py")
    assert run_sentinel(tmp_path).violations == []   # faithful copy: clean
    src = dst.read_text()
    assert src.count("with self.serve_lock:") >= 2
    dst.write_text(src.replace("with self.serve_lock:", "if True:", 1))
    violations = run_sentinel(tmp_path).violations
    assert violations and {f.rule for f in violations} == {"lock-guard"}


def test_moving_a_journal_append_below_its_swap_in_shield_is_caught(
        tmp_path):
    dst = _copy_into(tmp_path, "rca/shield.py")
    assert run_sentinel(tmp_path).violations == []   # faithful copy: clean
    src = dst.read_text()
    append = ('            self.journal.append((), seq, seq, kind="params_swap",\n'
              '                                force_sync=True, generation=gen,\n'
              '                                leaves=_host_leaves(params), '
              'source=source)\n')
    swap = "            s.swap_params(params, generation=gen, source=source)\n"
    assert src.count(append + swap) == 1
    dst.write_text(src.replace(append + swap, swap + append))
    violations = run_sentinel(tmp_path).violations
    assert [f.rule for f in violations] == ["wal-order"]
    assert "swap_params" in violations[0].message


def test_the_port_audits_clean_and_every_waiver_has_a_reason():
    report = run_audit()
    assert report.violations == [], report.to_text()
    # the passes bit on the real tree: the argued waivers are there
    waived = {f.rule for f in report.waivers}
    assert {"lock-guard", "wal-order", "ledger-order", "broad-except",
            "host-sync", "wall-clock"} <= waived
    entries = collect_waivers()
    assert entries and all(e["reason"] for e in entries)


def test_cli_exits_zero_on_the_port_and_nonzero_on_the_bad_fixtures(capsys):
    assert audit_main(["--report", "json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["ok"] and out["summary"]["violations"] == 0
    assert set(out["no_counterpart"]) == set(NO_COUNTERPART)
    for tree in ("sentinel/bad", "audit/ast_bad", "audit/ast_recovery",
                 "lattice/bad"):
        assert audit_main(["--root", str(FIXTURES / tree)]) == 1, tree
    assert audit_main(["--root", str(FIXTURES / "sentinel/clean")]) == 0
    assert audit_main(["--root", str(FIXTURES / "sentinel/bad"),
                       "--skip-sentinel"]) == 0
    assert audit_main(["--waivers"]) == 0
    assert audit_main(["--waivers", "--root",
                       str(FIXTURES / "sentinel/bad")]) == 1
    capsys.readouterr()


def test_every_declared_tier_is_reachable_and_dropping_one_is_caught(
        tmp_path):
    declared = declared_entries(package_root())
    assert set(declared) == {
        "streaming.gnn_tick.bucketed", "streaming.gnn_tick.fused",
        "streaming.gnn_tick.fused.bf16", "streaming.gnn_tick.dma",
        "streaming.gnn_tick.dma.bf16", "streaming.gnn_tick.dma.int8",
        "streaming.gnn_tick.sharded", "streaming.rules_tick",
        "streaming.rules_tick.sharded"}
    assert set(declared) <= reachable_entries()
    assert set(TIER_CALLS) <= set(declared)
    assert run_lattice().findings == []
    dst = _copy_into(tmp_path, "rca/gnn_streaming.py")
    assert run_lattice(tmp_path).findings == []      # faithful copy: clean
    src = dst.read_text()
    fused = ("        if self._fused_ok(offs):\n"
             "            return _gnn_fused_tick(")
    assert src.count(fused) == 1
    dst.write_text(src.replace(fused, "        if False:\n"
                                      "            return _gnn_tick("))
    found = run_lattice(tmp_path).findings
    assert {f.rule for f in found} == {"lattice-unreachable"}
    assert sorted(f.message.split("'")[1] for f in found) == [
        "streaming.gnn_tick.fused", "streaming.gnn_tick.fused.bf16"]


def test_the_port_ladders_keep_their_contracts_and_the_reference_rungs():
    assert run_ladders().findings == []
    ref = {lad.name: lad for lad in jax_ladders.LADDERS}
    for lad in LADDERS:
        want = ref[lad.name]
        assert (lad.rungs, lad.max_gap_ratio, lad.covers, lad.escalation,
                lad.step, lad.divisor, lad.divisor_min) == (
            want.rungs, want.max_gap_ratio, want.covers, want.escalation,
            want.step, want.divisor, want.divisor_min), lad.name
