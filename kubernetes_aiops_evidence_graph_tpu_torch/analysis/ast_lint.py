"""Pass 2: repo-specific AST lint over the port's source (stdlib-only).

Rules (ids are what the waiver pragma names):

* ``wall-clock``: ``time.time()`` anywhere; NTP steps make it
  non-monotonic, so durations use ``monotonic()``/``perf_counter()``.
  Epoch timestamps for export are waivable.
* ``broad-except``: ``except Exception``/bare except that swallows
  (handlers that re-raise are exempt). Intentional isolation boundaries
  carry a waiver with the reason.
* ``recovery-no-broad-except``: a broad except inside a recovery
  function (name matching recover/degrad/fallback/quarantine/watchdog/
  escalat under the hot dirs) that neither re-raises nor escalates (a
  call whose name contains ``escalat``). In recovery context it replaces
  the generic ``broad-except``.
* ``host-sync``: a device->host sync in a hot module (:data:`HOT_DIRS`):
  ``.cpu()``, ``.numpy()``, ``.synchronize()`` (``torch.cuda.
  synchronize()``, a CUDA event's or stream's), and ``.item()``,
  ``.tolist()``, ``float()``/``int()``/``bool()`` and ``np.asarray()``/
  ``np.array()`` applied to a tensor. Tensors are found by a per-scope
  dataflow: names bound from ``torch.*`` calls, from the port's
  device-returning functions (:data:`DEVICE_RETURNING`), from
  ``.detach()``, from the resident ``*_dev`` attributes, and parameters
  annotated ``torch.Tensor``; shape, dtype and device metadata are host
  values. The sanctioned fetches are the functions declared in
  :data:`FETCH_SEAMS` (the counterpart of the reference's explicit
  ``jax.device_get``); any other site is removed or waived with its
  reason.
* ``kernel-undeclared``: every launch entry in ``kernels/*.py``, a public
  function from which a launch-count increment (``<name>launches +=``)
  is reachable through the module's own functions, is declared in
  :data:`KERNEL_DECLARATIONS` with its plain twin.
* ``kernel-fallback``: in ``kernels/*.py`` a declared plain twin is
  called only inside the body of a CPU-device branch (``if
  <t>.device.type == "cpu"``, ``if dev.type == "cpu"`` or a predicate of
  :data:`CPU_PREDICATES`) and never from an ``except`` handler: on a CUDA
  tensor a wrapper launches its kernel or raises.

Waiver pragma: ``# graft-audit: allow[rule] reason`` on the offending
line or the line above. Waived sites are counted and reported, never
silently dropped.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from .findings import Finding, Report

HOT_DIRS = {"rca", "ops", "parallel", "learn", "kernels"}

# (posix path relative to the package root, function) -> why a sync there
# is sanctioned: the explicit fetches and waits, each the counterpart of
# an explicit transfer of the reference (jax.device_get /
# block_until_ready). A function nested in a seam is the seam too.
FETCH_SEAMS: dict[tuple[str, str], str] = {
    # serving readbacks, once a pass at the caller boundary
    ("rca/cuda_backend.py", "fetch"):
        "the snapshot scorer's one readback (JAX tpu_backend: jax.device_get)",
    ("rca/gnn_backend.py", "score_snapshot"):
        "the learned snapshot scorer's one readback (JAX gnn_backend: "
        "jax.device_get of the softmax)",
    ("rca/streaming.py", "_fetch_verdicts"):
        "the rules tick's one readback at rescore/serve (JAX streaming: "
        "jax.device_get of the handles)",
    ("rca/streaming.py", "_wait"):
        "the tick's completion wait just before its readback (JAX "
        "streaming: jax.block_until_ready of the handles)",
    ("rca/gnn_streaming.py", "_fetch_verdicts"):
        "the learned tick's one probs readback at rescore/serve (JAX "
        "gnn_streaming: jax.device_get)",
    ("rca/gnn_streaming.py", "_quant_refresh"):
        "the int8 table's frozen scale, read once per table build (JAX "
        "gnn_streaming: jax.device_get of the scale)",
    # recovery and its journal records
    ("rca/streaming.py", "_adopt_resident"):
        "a restore re-stitches the host feature mirror from the restored "
        "tensor once (JAX streaming: jax.device_get of _features_dev)",
    ("rca/shield.py", "_attest_and_repair"):
        "the attestation's one host copy of the per-shard folds (JAX "
        "shield: jax.device_get of attest_fold)",
    ("rca/shield.py", "snapshot_now"):
        "the snapshot's one packed transfer to disk (JAX shield: "
        "jax.device_get of _snapshot_pack)",
    ("rca/shield.py", "_host_leaves"):
        "params leaves to host numpy for a journal record (JAX shield: "
        "np.asarray of the swapped leaves)",
    ("rca/surge.py", "swap_tenants_atomically"):
        "params leaves to host numpy for each shielded tenant's WAL record "
        "(JAX surge: np.asarray of the leaves)",
    # training, evaluation and the learner's gate, once a cycle or epoch
    ("rca/train.py", "_predictions"):
        "evaluation reads each batch's logits back (JAX train: "
        "jax.device_get of forward_batch)",
    ("rca/train.py", "crosscheck_holdout"):
        "the holdout cross-check reads logits back (JAX train: "
        "jax.device_get of forward_batch)",
    ("rca/train.py", "_sync"):
        "the trainer's timing brackets wait for the device (JAX train: "
        "block_until_ready before the clock)",
    ("rca/train.py", "save_checkpoint"):
        "a checkpoint writes host arrays (JAX train: orbax saves host "
        "copies)",
    ("learn/trainer.py", "_loss_and_grads"):
        "the gate's grads-parity check compares a device loss and grads "
        "with a CPU copy on the host, once a learner cycle (JAX "
        "_pallas_grads_parity_ok: float() of both losses)",
    ("learn/trainer.py", "check_grads_parity"):
        "the gate's grads-parity check builds its CPU copy of the params, "
        "once a learner cycle (JAX _pallas_grads_parity_ok)",
    ("learn/trainer.py", "finetune"):
        "the fine-tune's final loss, read once a cycle (JAX trainer: "
        "float(jax.device_get(loss)))",
    ("learn/trainer.py", "_finetune_sharded"):
        "the sharded fine-tune's final loss, read once a cycle (JAX "
        "trainer: float(jax.device_get(loss)))",
    ("learn/trainer.py", "params_finite"):
        "the gate's finiteness check of a candidate, once a cycle (JAX "
        "trainer: np.asarray(jax.device_get(leaf)))",
    # the device anchors measure a device->host round trip on purpose
    ("rca/device_metrics.py", "_clock"):
        "a timing anchor waits for its end event (JAX device_metrics: "
        "jax.device_get of the scan)",
    ("rca/device_metrics.py", "measure_fetch_rtt_ms"):
        "the fetch anchor times device->host copies (JAX device_metrics: "
        "jax.device_get)",
    ("rca/device_metrics.py", "measure_gnn_forward_per_pass_s"):
        "the forward's anchor brackets its passes with synchronizes (JAX "
        "device_metrics: jax.device_get of the output)",
}

# (kernels/ module, launch entry) -> its plain twin: the function the
# entry runs for CPU tensors, and only there (ground rule 6)
KERNEL_DECLARATIONS: dict[tuple[str, str], str] = {
    ("kernels/rules_fold.py", "rules_fold"): "rules_fold_reference",
    ("kernels/rules_fold.py", "rules_fold_partial"):
        "rules_fold_partial_reference",
    ("kernels/rules_fold.py", "rules_fold_partial_packed"):
        "rules_fold_partial_reference",
    ("kernels/rules_fold.py", "rules_tail"): "rules_tail_reference",
    ("kernels/gms.py", "gather_matmul_segment"):
        "gather_matmul_segment_reference",
    ("kernels/grad_w.py", "gms_grad_w"): "gms_grad_w_reference",
    ("kernels/fused_tick.py", "fused_gnn_tick"): "fused_gnn_tick_plain",
    ("kernels/fused_tick.py", "fused_gnn_tick_dma"):
        "fused_gnn_tick_dma_plain",
}
# module-local predicates that return ``t.device.type == "cpu"``
CPU_PREDICATES = {"_on_cpu"}

# the port's functions that return device tensors (by trailing name)
DEVICE_RETURNING = {
    "forward", "forward_batch", "gather_matmul_segment", "gms_grad_w",
    "rules_fold", "rules_fold_partial", "rules_fold_partial_packed",
    "rules_tail", "fused_gnn_tick", "fused_gnn_tick_dma", "composed_tick",
    "_tick", "_gnn_tick", "_gnn_fused_tick", "_gnn_dma_tick",
    "_gnn_dma_tick_q", "_call_gnn_tick", "_dispatch_dma", "_delta_pack",
    "_snapshot_pack", "_snapshot_unpack", "attest_fold", "segment_sum",
    "scatter_add", "k_hop_reach", "propagate_labels", "dispatch",
    "loss_fn", "train_step", "step",
}
# torch.* calls that return host objects, not tensors
_NON_TENSOR_TORCH = (
    "torch.device", "torch.cuda.", "torch.is_", "torch.get_", "torch.set_",
    "torch.no_grad", "torch.enable_grad", "torch.inference_mode",
    "torch.Size", "torch.finfo", "torch.iinfo", "torch.manual_seed",
    "torch.distributed.", "torch.backends.", "torch.utils.",
    "torch.Generator", "torch.promote_types", "torch.result_type",
    "torch.can_cast", "torch.profiler.", "torch.library.",
)
# tensor attributes and methods that read host metadata, never data
_METADATA = {"shape", "ndim", "dtype", "device", "is_cuda", "requires_grad",
             "layout", "_version", "numel", "size", "dim", "data_ptr",
             "element_size", "stride", "is_contiguous", "storage_offset",
             "nelement", "get_device", "is_pinned", "type"}
_ALWAYS_SYNC = {"cpu", "numpy", "synchronize"}
_TENSOR_SYNC = {"item", "tolist"}
HOST_SINKS = {"float", "int", "bool"}
NP_SINKS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}

_WAIVER_RE = re.compile(
    r"#\s*graft-audit:\s*allow\[([a-zA-Z0-9_,\- ]+)\]\s*(.*)")

# functions whose broad excepts fall under recovery-no-broad-except
_RECOVERY_FN_RE = re.compile(
    r"recover|degrad|fallback|quarantine|watchdog|escalat")


def _dotted(node) -> str:
    """'a.b.c' for Name/Attribute chains, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _call_name(call: ast.Call) -> str:
    return _dotted(call.func)


def _is_tensor(node, names: set[str]) -> bool:
    """Whether an expression evaluates to a tensor (see the module
    docstring's dataflow); metadata reads are host values."""
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, ast.Attribute):
        if node.attr in _METADATA:
            return False
        return node.attr.endswith("_dev") or _is_tensor(node.value, names)
    if isinstance(node, ast.Call):
        name = _call_name(node)
        if name.startswith("torch."):
            return not name.startswith(_NON_TENSOR_TORCH)
        if name.rsplit(".", 1)[-1] in DEVICE_RETURNING:
            return True
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in _METADATA:
                return False
            if node.func.attr == "detach":
                return True
            return _is_tensor(node.func.value, names)
        return False
    if isinstance(node, ast.Subscript):
        return _is_tensor(node.value, names)
    if isinstance(node, ast.Starred):
        return _is_tensor(node.value, names)
    if isinstance(node, ast.BinOp):
        return _is_tensor(node.left, names) or _is_tensor(node.right, names)
    if isinstance(node, ast.UnaryOp):
        return _is_tensor(node.operand, names)
    if isinstance(node, ast.Compare):
        return any(_is_tensor(n, names) for n in [node.left, *node.comparators])
    if isinstance(node, ast.IfExp):
        return _is_tensor(node.body, names) or _is_tensor(node.orelse, names)
    return False


def _is_cpu_test(test) -> bool:
    """``<x>.type == "cpu"`` (a device's type) or a CPU predicate call."""
    if isinstance(test, ast.Compare) and len(test.ops) == 1 \
            and isinstance(test.ops[0], ast.Eq):
        sides = [test.left, test.comparators[0]]
        has_cpu = any(isinstance(s, ast.Constant) and s.value == "cpu"
                      for s in sides)
        has_type = any(isinstance(s, ast.Attribute) and s.attr == "type"
                       for s in sides)
        return has_cpu and has_type
    if isinstance(test, ast.Call):
        return _call_name(test).rsplit(".", 1)[-1] in CPU_PREDICATES
    return False


def _inline_literal(tree: ast.Module, name: str):
    """A module-level ``NAME = {...}`` literal (fixture registries)."""
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == name):
            try:
                value = ast.literal_eval(node.value)
            except (ValueError, SyntaxError):
                return None
            return value
    return None


class _FileLint:
    def __init__(self, rel: str, source: str):
        self.rel = rel
        self.tree = ast.parse(source)
        self.findings: list[Finding] = []
        dirs = set(Path(rel).parts[:-1])
        self.in_hot = bool(dirs & HOT_DIRS)
        self.in_kernels = "kernels" in dirs
        self.waivers: dict[int, tuple[set[str], str]] = {}
        for i, line in enumerate(source.splitlines(), start=1):
            m = _WAIVER_RE.search(line)
            if m:
                rules = {r.strip() for r in m.group(1).split(",")}
                self.waivers[i] = (rules, m.group(2).strip())
        self.parents: dict[int, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[id(child)] = node

    def hit(self, rule: str, line: int, message: str) -> None:
        waived, reason = False, ""
        for ln in (line, line - 1):
            w = self.waivers.get(ln)
            if w and (rule in w[0] or "all" in w[0]):
                waived, reason = True, w[1]
                break
        self.findings.append(Finding(
            rule=rule, where=f"{self.rel}:{line}", message=message,
            pass_name="ast", waived=waived, waiver_reason=reason))

    def _ancestors(self, node):
        cur = self.parents.get(id(node))
        while cur is not None:
            yield cur
            cur = self.parents.get(id(cur))

    def _enclosing_fns(self, node) -> list[str]:
        return [a.name for a in self._ancestors(node)
                if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef))]

    # -- rules -----------------------------------------------------------

    def lint(self) -> list[Finding]:
        self._visit_excepts(self.tree, "")
        self._wall_clock()
        if self.in_hot:
            self._host_sync()
        if self.in_kernels:
            self._kernels()
        return self.findings

    def _visit_excepts(self, node, fname: str) -> None:
        """Walk handlers tracking the innermost enclosing function name:
        recovery-named functions get the stricter rule."""
        for child in ast.iter_child_nodes(node):
            nf = child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fname
            if isinstance(child, ast.ExceptHandler):
                self._check_except(child, fname)
            self._visit_excepts(child, nf)

    def _check_except(self, n: ast.ExceptHandler, fname: str) -> None:
        t = n.type
        broad = t is None or (isinstance(t, ast.Name)
                              and t.id in ("Exception", "BaseException"))
        if not broad:
            return
        reraises = any(isinstance(b, ast.Raise) for b in ast.walk(n))
        if self.in_hot and _RECOVERY_FN_RE.search(fname or ""):
            escalates = any(
                isinstance(b, ast.Call)
                and "escalat" in _call_name(b).rsplit(".", 1)[-1]
                for b in ast.walk(n))
            if not (reraises or escalates):
                self.hit("recovery-no-broad-except", n.lineno,
                         f"broad except in recovery function '{fname}' "
                         "neither re-raises nor escalates: a degradation "
                         "path that swallows turns non-transient faults "
                         "into silent wrong-tier serving")
            return
        if reraises:
            return   # catch-and-rethrow is instrumentation, not swallowing
        self.hit("broad-except", n.lineno,
                 "broad except swallows all errors; narrow the catch "
                 "or waive with the isolation reason")

    def _wall_clock(self) -> None:
        for n in ast.walk(self.tree):
            if isinstance(n, ast.Call) and _call_name(n) == "time.time":
                self.hit("wall-clock", n.lineno,
                         "time.time() is not monotonic under NTP steps; "
                         "use time.monotonic()/perf_counter() for durations")

    # -- host-sync -------------------------------------------------------

    @staticmethod
    def _scope_walk(stmt):
        """Walk one statement without descending into nested function
        scopes (each scope tracks its own tensor names)."""
        yield stmt
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return
        for child in ast.iter_child_nodes(stmt):
            yield from _FileLint._scope_walk(child)

    @staticmethod
    def _tensor_params(fn) -> set[str]:
        out = set()
        for a in [*fn.args.posonlyargs, *fn.args.args, *fn.args.kwonlyargs]:
            ann = a.annotation
            if ann is not None and "Tensor" in ast.unparse(ann):
                out.add(a.arg)
        return out

    def _host_sync(self) -> None:
        self._synced_lines: set[int] = set()
        scopes = [s for s in ast.walk(self.tree)
                  if isinstance(s, (ast.Module, ast.FunctionDef,
                                    ast.AsyncFunctionDef))]
        for scope in scopes:
            names = (set() if isinstance(scope, ast.Module)
                     else self._tensor_params(scope))
            for stmt in scope.body:
                for n in self._scope_walk(stmt):
                    if isinstance(n, (ast.Assign, ast.AnnAssign)):
                        targets = (n.targets if isinstance(n, ast.Assign)
                                   else [n.target])
                        if n.value is None:
                            continue
                        tensor = _is_tensor(n.value, names)
                        for tgt in targets:
                            elts = (tgt.elts if isinstance(tgt, (ast.Tuple,
                                                                 ast.List))
                                    else [tgt])
                            for e in elts:
                                if isinstance(e, ast.Starred):
                                    e = e.value
                                if not isinstance(e, ast.Name):
                                    continue
                                if tensor:
                                    names.add(e.id)
                                else:
                                    names.discard(e.id)
                    elif isinstance(n, (ast.For, ast.comprehension)):
                        if _is_tensor(n.iter, names) and \
                                isinstance(n.target, ast.Name):
                            names.add(n.target.id)
                    elif isinstance(n, ast.Call):
                        self._check_sync_call(n, names)

    def _check_sync_call(self, n: ast.Call, names: set[str]) -> None:
        what = ""
        name = _call_name(n)
        if isinstance(n.func, ast.Attribute):
            attr = n.func.attr
            if attr in _ALWAYS_SYNC:
                what = f".{attr}()"
            elif attr in _TENSOR_SYNC and _is_tensor(n.func.value, names):
                what = f".{attr}() on a tensor"
        if not what and (name in HOST_SINKS or name in NP_SINKS) and any(
                _is_tensor(a, names) for a in n.args):
            what = f"{name}() of a tensor"
        if not what or n.lineno in self._synced_lines:
            return
        if any((self.rel, fn) in FETCH_SEAMS
               for fn in self._enclosing_fns(n)):
            return
        self._synced_lines.add(n.lineno)
        self.hit("host-sync", n.lineno,
                 f"{what} is a device->host sync in a hot module outside "
                 "a declared fetch seam (FETCH_SEAMS): remove it from the "
                 "dispatch, declare the seam, or waive it with the reason")

    # -- kernels ---------------------------------------------------------

    def _declarations(self) -> dict[str, str]:
        decl = {fn: twin for (rel, fn), twin in KERNEL_DECLARATIONS.items()
                if rel == self.rel}
        inline = _inline_literal(self.tree, "GRAFT_KERNELS")
        if isinstance(inline, dict):
            decl.update({str(k): str(v) for k, v in inline.items()})
        return decl

    def _kernels(self) -> None:
        if Path(self.rel).name == "_build.py":
            return
        decl = self._declarations()
        fns = {n.name: n for n in self.tree.body
               if isinstance(n, ast.FunctionDef)}
        calls = {name: {_call_name(c).rsplit(".", 1)[-1]
                        for c in ast.walk(fn) if isinstance(c, ast.Call)}
                 for name, fn in fns.items()}
        counts = {name for name, fn in fns.items() if any(
            isinstance(a, ast.AugAssign) and isinstance(a.target, ast.Name)
            and a.target.id.endswith("launches") for a in ast.walk(fn))}

        def launches(start: str) -> bool:
            seen, todo = set(), [start]
            while todo:
                cur = todo.pop()
                if cur in seen:
                    continue
                seen.add(cur)
                if cur in counts:
                    return True
                todo.extend(c for c in calls.get(cur, ()) if c in fns)
            return False

        for name, fn in fns.items():
            if name.startswith("_") or name in decl or not launches(name):
                continue
            self.hit("kernel-undeclared", fn.lineno,
                     f"launch entry '{name}' is not declared in "
                     "analysis.ast_lint.KERNEL_DECLARATIONS: register it "
                     "with its plain twin (the function it runs for CPU "
                     "tensors)")
        for name in sorted(decl):
            if name not in fns:
                self.hit("kernel-undeclared", 1,
                         f"KERNEL_DECLARATIONS names '{name}', which "
                         f"{self.rel} does not define")
        twins = set(decl.values())
        for n in ast.walk(self.tree):
            if not (isinstance(n, ast.Call)
                    and _call_name(n).rsplit(".", 1)[-1] in twins):
                continue
            twin = _call_name(n).rsplit(".", 1)[-1]
            if any(isinstance(a, ast.ExceptHandler)
                   for a in self._ancestors(n)):
                self.hit("kernel-fallback", n.lineno,
                         f"plain twin '{twin}' called from an except "
                         "handler: a kernel that fails must raise, never "
                         "fall back to its plain version on the card")
            elif not self._under_cpu_branch(n):
                self.hit("kernel-fallback", n.lineno,
                         f"plain twin '{twin}' called outside a CPU-device "
                         "branch: on a CUDA tensor a wrapper launches its "
                         "kernel or raises")

    def _under_cpu_branch(self, node) -> bool:
        child = node
        for anc in self._ancestors(node):
            if isinstance(anc, ast.If) and _is_cpu_test(anc.test) and \
                    any(child is s for s in anc.body):
                return True
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return False
            child = anc
        return False


def package_root() -> Path:
    return Path(__file__).resolve().parent.parent


def lint_tree(root: "Path | str | None" = None) -> Report:
    """Lint every .py under ``root`` (default: the port's package)."""
    base = Path(root) if root is not None else package_root()
    report = Report()
    for path in sorted(base.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(base).as_posix()
        try:
            lint = _FileLint(rel, path.read_text())
        except SyntaxError as exc:
            report.findings.append(Finding(
                rule="syntax-error", where=f"{rel}:{exc.lineno or 0}",
                message=str(exc), pass_name="ast"))
            continue
        report.findings.extend(lint.lint())
    return report
