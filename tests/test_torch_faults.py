"""The port's fault injector (``rca/faults.py``) against the JAX
package's: the same stage tuples, the same seeded schedules, the same
visit bookkeeping, raises and poison. The corruptions and the ingest
seams are in ``tests/test_torch_faults_state.py``."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from kubernetes_aiops_evidence_graph_tpu.rca import faults as j_faults
from kubernetes_aiops_evidence_graph_tpu_torch.rca import faults as t_faults

STAGE_TUPLES = ("TICK_STAGES", "INGEST_STAGES", "LEARN_STAGES",
                "WORKFLOW_STAGES", "MIGRATE_STAGES", "STAGES")


@pytest.mark.parametrize("name", STAGE_TUPLES)
def test_stage_tuples_equal_jax(name):
    assert getattr(t_faults, name) == getattr(j_faults, name)


@pytest.mark.parametrize("seed,shards", [(0, 0), (7, 0), (20260804, 4),
                                         (11, 2)])
def test_seeded_schedules_equal_jax(seed, shards):
    kw = dict(ticks=12, rate=0.3, shards=shards, stall_seconds=0.5)
    got = t_faults.FaultInjector.seeded(seed, **kw)
    want = j_faults.FaultInjector.seeded(seed, **kw)
    assert [dataclasses.astuple(f) for f in got.faults] == [
        dataclasses.astuple(f) for f in want.faults]
    assert got.stall_seconds == want.stall_seconds == 0.5
    assert {f.kind for f in got.faults} <= {
        "raise", "poison", "device_loss", "shard_loss",
        "shard_corrupt_silent", "crash"}


def _visit_script(mod):
    """Drive one schedule through every hook kind; returns what each
    visit did, the injector's visit counters and its fired log."""
    inj = mod.FaultInjector([
        mod.Fault("dispatch", at=1, repeats=2),
        mod.Fault("fetch", at=0),
        mod.Fault("collect", at=1, kind="crash"),
        mod.Fault("execute", at=2, kind="stall"),
        mod.Fault("delta_values", at=1, kind="poison"),
        mod.Fault("journal_append", at=0),
    ], stall_seconds=0.0)
    seen = []
    for stage in ("dispatch",) * 4 + ("fetch",) * 2 + ("collect",) * 2 \
            + ("execute",) * 3:
        try:
            inj.at(stage)
            seen.append((stage, "ok"))
        except mod.InjectedFault as exc:
            seen.append((stage, "fault", exc.stage, exc.kind, exc.visit,
                         exc.shard, str(exc)))
        except mod.WorkflowCrash as exc:
            seen.append((stage, "crash", exc.stage, exc.visit, str(exc)))
    rows = np.arange(12, dtype=np.float32).reshape(3, 4)
    for _ in range(3):
        out = inj.poison("delta_values", rows)
        seen.append(("poison", out is rows, out.tobytes()))
    try:
        inj.journal_hook("journal_append")
    except mod.InjectedFault as exc:
        seen.append(("hook", exc.stage, exc.visit))
    return seen, dict(inj.visits), list(inj.fired)


def test_visits_raises_crashes_and_poison_equal_jax():
    got, want = _visit_script(t_faults), _visit_script(j_faults)
    assert got == want
    seen = got[0]
    assert seen[1][1] == "fault" and seen[3] == ("dispatch", "ok")
    assert ("collect", "crash") == seen[7][:2]
    assert issubclass(t_faults.WorkflowCrash, BaseException)
    assert not issubclass(t_faults.WorkflowCrash, Exception)
    poisoned = np.frombuffer(seen[12][2], np.float32)
    assert np.isinf(poisoned[0]) and np.isnan(poisoned[1:]).all()
