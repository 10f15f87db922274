"""The port's AST lint (``kubernetes_aiops_evidence_graph_tpu_torch/analysis``,
pass 2) against the reference's (``kubernetes_aiops_evidence_graph_tpu/
analysis``).

* Parity: on the reference's own fixture trees the port's lint gives the
  reference's (file, rule) set for every rule it carries (``CARRIED``),
  violations and waivers alike, and no rule of the reference's that the
  port does not run.
* The torch rules (``host-sync``, ``kernel-undeclared``,
  ``kernel-fallback``) each trip exactly their seeded fixture, written
  into ``tmp_path`` from the strings below, and nothing on the
  reference's clean trees; mutations of the port's own ``rca/streaming``
  dispatch and ``kernels/rules_fold`` wrapper are caught.
* The port's tree lints clean, every fetch seam and kernel declaration
  names a function that exists, ``RULES`` with ``NO_COUNTERPART``
  covers the reference's rule table, and the static passes import
  neither torch nor numpy.
"""
import ast
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from kubernetes_aiops_evidence_graph_tpu.analysis.ast_lint import (
    lint_tree as jax_lint)
from kubernetes_aiops_evidence_graph_tpu.analysis.findings import (
    RULES as JAX_RULES)
from kubernetes_aiops_evidence_graph_tpu_torch.analysis.ast_lint import (
    FETCH_SEAMS, KERNEL_DECLARATIONS, lint_tree, package_root)
from kubernetes_aiops_evidence_graph_tpu_torch.analysis.findings import (
    CARRIED, NO_COUNTERPART, REWRITTEN, RULES)

FIXTURES = Path(__file__).parent / "fixtures"
TORCH_RULES = {"host-sync", "kernel-undeclared", "kernel-fallback"}

# seeded torch fixtures: rel path -> (source, the ONE rule it must trip)
SEEDED = {
    "host-sync": ("rca/sync_dispatch.py", '''
import torch


class Scorer:
    def dispatch(self):
        out = torch.ones(4, device=self.device)
        return out.cpu()              # a readback inside the dispatch
'''),
    "kernel-fallback": ("kernels/fallback.py", '''
GRAFT_KERNELS = {"fold": "fold_plain"}
launches = 0


class KernelError(RuntimeError):
    pass


def fold_plain(x):
    return x * 2


def _launch(x):
    raise KernelError("no kernel")


def fold(x):
    global launches
    if x.device.type == "cpu":
        return fold_plain(x)
    try:
        out = _launch(x)
    except KernelError:
        return fold_plain(x)          # a fallback on the card
    launches += 1
    return out
'''),
    "kernel-undeclared": ("kernels/extra.py", '''
launches = 0


def extra_plain(x):
    return x + 1


def extra(x):
    global launches
    if x.device.type == "cpu":
        return extra_plain(x)
    launches += 1
    return x
'''),
}


def _carried(report, waived: bool) -> set:
    return {(f.where.rsplit(":", 1)[0], f.rule) for f in report.findings
            if f.rule in CARRIED and f.waived == waived}


@pytest.mark.parametrize("tree", ["audit/ast_bad", "audit/ast_clean",
                                  "audit/ast_recovery"])
def test_carried_ast_rules_match_the_reference_on_its_fixtures(tree):
    root = FIXTURES / tree
    mine, ref = lint_tree(root), jax_lint(root)
    assert _carried(mine, False) == _carried(ref, False)
    assert _carried(mine, True) == _carried(ref, True)
    assert _carried(ref, False) or tree == "audit/ast_clean"
    # no reference rule the port does not run shows up in its findings,
    # and the torch rules find nothing in the reference's JAX trees
    assert {f.rule for f in mine.findings} <= CARRIED


@pytest.mark.parametrize("rule", sorted(SEEDED))
def test_seeded_torch_fixture_trips_exactly_its_rule(rule, tmp_path):
    rel, source = SEEDED[rule]
    (tmp_path / rel).parent.mkdir(parents=True)
    (tmp_path / rel).write_text(source)
    report = lint_tree(tmp_path)
    assert [(f.where.rsplit(":", 1)[0], f.rule)
            for f in report.findings] == [(rel, rule)]


def test_torch_rules_find_nothing_on_the_reference_clean_trees():
    for tree in ("audit/ast_clean", "sentinel/clean", "lattice/clean",
                 "audit/ast_recovery"):
        rules = {f.rule for f in lint_tree(FIXTURES / tree).findings}
        assert not rules & TORCH_RULES, (tree, rules)


def test_the_port_lints_clean_and_every_registry_entry_exists():
    report = lint_tree()
    assert report.violations == [], "\n".join(
        f"{f.where} {f.rule}" for f in report.violations)
    root = package_root()
    defined: dict[str, set] = {}
    for rel, fn in [*FETCH_SEAMS, *KERNEL_DECLARATIONS]:
        if rel not in defined:
            tree = ast.parse((root / rel).read_text())
            defined[rel] = {n.name for n in ast.walk(tree)
                            if isinstance(n, ast.FunctionDef)}
        assert fn in defined[rel], f"{rel}: no function {fn}"
    assert all(reason for reason in FETCH_SEAMS.values())
    # every twin is a name its kernel module binds
    for (rel, _), twin in KERNEL_DECLARATIONS.items():
        assert re.search(rf"\b{twin}\b", (root / rel).read_text()), twin


def test_rule_tables_cover_the_reference_and_every_literal_resolves():
    assert not set(RULES) & set(NO_COUNTERPART)
    assert set(JAX_RULES) <= set(RULES) | set(NO_COUNTERPART)
    assert set(RULES) - set(JAX_RULES) == {"kernel-undeclared",
                                           "kernel-fallback"}
    assert CARRIED | set(REWRITTEN) == set(RULES)
    assert set(REWRITTEN.values()) <= set(JAX_RULES)
    assert all(NO_COUNTERPART.values())
    used = set()
    for path in (package_root() / "analysis").glob("*.py"):
        used |= set(re.findall(r'''(?:rule=|hit\(\s*)"([a-z0-9-]+)"''',
                               path.read_text()))
    assert used and used <= set(RULES), used - set(RULES)


def test_a_readback_added_to_the_rules_dispatch_is_caught(tmp_path):
    """The mutation the torch host-sync rule exists for: a ``.item()`` in
    ``StreamingScorer.dispatch`` (a copy of the port's module)."""
    dst = tmp_path / "rca" / "streaming.py"
    dst.parent.mkdir()
    src = (package_root() / "rca" / "streaming.py").read_text()
    dst.write_text(src)
    assert lint_tree(tmp_path).violations == []   # faithful copy: clean
    anchor = "        self.dispatches += 1\n"
    assert src.count(anchor) == 1
    dst.write_text(src.replace(anchor, anchor
                               + "        _ = self._ev_cnt_dev.sum().item()\n"))
    found = lint_tree(tmp_path).violations
    assert [f.rule for f in found] == ["host-sync"]


def test_a_fallback_wrapped_round_a_port_kernel_is_caught(tmp_path):
    """``rules_fold`` serving its plain twin when the launch raises: the
    fallback ground rule 6 forbids (a copy of the port's module)."""
    dst = tmp_path / "kernels" / "rules_fold.py"
    dst.parent.mkdir()
    shutil.copy(package_root() / "kernels" / "rules_fold.py", dst)
    assert lint_tree(tmp_path).violations == []   # faithful copy: clean
    src = dst.read_text()
    old = "    lib = _library()\n    with torch.cuda.device(dev):\n        rc = lib.rules_fold_launch("
    assert src.count(old) == 1
    new = ("    try:\n        lib = _library()\n"
           "    except _build.KernelError:\n"
           "        return rules_fold_reference(features, ev_idx, ev_cnt, "
           "ev_pair_slot, chain, pair_width)\n"
           "    with torch.cuda.device(dev):\n        rc = lib.rules_fold_launch(")
    dst.write_text(src.replace(old, new))
    found = lint_tree(tmp_path).violations
    assert [f.rule for f in found] == ["kernel-fallback"]


def test_the_static_passes_import_no_torch():
    code = ("import sys\n"
            "from kubernetes_aiops_evidence_graph_tpu_torch.analysis import "
            "run_audit, runtime_guards, __main__\n"
            "report = run_audit()\n"
            "assert not report.violations\n"
            "print(sorted(m for m in ('torch', 'numpy', 'jax') "
            "if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=package_root().parent, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
