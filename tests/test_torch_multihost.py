"""The multi-process group of the port (``parallel/multihost.py`` over
``torch.distributed``) against tests/test_multihost_dcn.py and
tests/test_parallel.py:114: two OS processes form a gloo group through
``init_distributed``, build the (dp=2 x graph=2) mesh with dp across the
processes, and sum over dp across them (``compat.psum_dp``, an all-gather
in rank order then a sum in position order); alone, the helpers degrade
to the single-process mesh and slice."""
from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu_torch import parallel
from kubernetes_aiops_evidence_graph_tpu_torch.parallel import compat
from kubernetes_aiops_evidence_graph_tpu_torch.parallel import mesh as pmesh
from kubernetes_aiops_evidence_graph_tpu_torch.parallel import multihost

REPO = Path(__file__).resolve().parent.parent

CHILD = r"""
import numpy as np
import torch
from kubernetes_aiops_evidence_graph_tpu_torch.parallel import compat
from kubernetes_aiops_evidence_graph_tpu_torch.parallel import mesh as pmesh
from kubernetes_aiops_evidence_graph_tpu_torch.parallel.multihost import (
    host_local_incident_slice, init_distributed, make_multihost_mesh,
    process_count)
import torch.distributed as dist

pmesh.ensure_host_devices(2)
assert init_distributed(device="cpu"), "process group did not form"
assert process_count() == 2 and dist.get_backend() == "gloo"
pid = dist.get_rank()
mesh = make_multihost_mesh(graph_per_host=2, device="cpu")
assert mesh.shape == {"dp": 2, "graph": 2}, mesh.shape
assert mesh.ranks.tolist() == [[0, 0], [1, 1]], mesh.ranks
assert mesh.pool_index.ravel().tolist() == [0, 1, 2, 3]
# per-position work runs on this process's positions only
ran = compat.run(mesh, lambda pos: (pos.dp, pos.graph))
mine = [v for v in ran.ravel() if v is not None]
assert mine == [(pid, 0), (pid, 1)], mine
parts = np.empty((2, 2), dtype=object)
parts[pid, 0] = torch.tensor([float(pid + 1)])
parts[pid, 1] = torch.tensor([10.0 * (pid + 1)])
out = compat.psum_dp(parts, mesh)
assert out[1 - pid, 0] is None
total = float(out[pid, 0][0])
assert total == 3.0, total            # 1 + 2 across the processes
assert float(out[pid, 1][0]) == 30.0
sl = host_local_incident_slice(10)
assert (sl.start, sl.stop) == ((0, 5) if pid == 0 else (5, 10)), sl
dist.destroy_process_group()
print(f"child{pid}: psum={total} slice={sl.start}:{sl.stop} OK", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_group(child_src: str, timeout_s: float):
    """Two children wired to one coordinator; (returncodes, outputs). A
    child past the timeout is killed, and so is its sibling."""
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, KAEG_COORDINATOR=f"127.0.0.1:{port}",
                   KAEG_NUM_PROCESSES="2", KAEG_PROCESS_ID=str(pid),
                   PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", child_src], env=env, cwd=str(REPO),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout_s)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("the two-process group timed out\n" + "\n".join(outs))
    return [p.returncode for p in procs], outs


def test_two_process_gloo_group_psum_over_dp():
    rcs, outs = _spawn_group(CHILD, timeout_s=120)
    for pid, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"child{pid} failed:\n{out}"
        assert f"child{pid}: psum=3.0" in out, out


def test_multihost_helpers_single_process(monkeypatch):
    """Single-process degradation: no group without the KAEG_* variables,
    the mesh is ``make_mesh``'s over the pool, the slice is everything
    (tests/test_parallel.py:114)."""
    for k in ("KAEG_COORDINATOR", "KAEG_NUM_PROCESSES", "KAEG_PROCESS_ID",
              "KAEG_AUTO_DISTRIBUTED"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(pmesh, "_HOST_POOL", {"devices": 8,
                                              "committed": False})
    assert parallel.init_distributed(device="cpu") is False
    assert multihost.process_count() == 1
    mesh = parallel.make_multihost_mesh(device="cpu")
    assert mesh.devices.size == 8 and mesh.axis_names == ("dp", "graph")
    assert mesh.shape == pmesh.make_mesh(devices=["cpu"] * 8).shape
    assert mesh.ranks is None
    assert parallel.host_local_incident_slice(500) == slice(0, 500)


def test_psum_dp_sums_rows_in_position_order():
    """The sum over dp adds rows 0..dp-1 in that order (float32 addition
    is not associative: the order is the result) and hands it to every
    position of the column."""
    mesh = pmesh.make_mesh(4, 2, ["cpu"] * 8)
    vals = [1e8, 1.0, -1e8, 1.0]
    parts = compat.run(mesh, lambda pos: torch.tensor(
        [vals[pos.dp] * (pos.graph + 1)], dtype=torch.float32))
    out = compat.psum_dp(parts, mesh)
    for g in range(2):
        want = torch.tensor([vals[0] * (g + 1)], dtype=torch.float32)
        for i in range(1, 4):
            want = want + torch.tensor([vals[i] * (g + 1)],
                                       dtype=torch.float32)
        for i in range(4):
            assert torch.equal(out[i, g], want), (i, g)
    assert float(out[0, 0][0]) == 1.0      # ((1e8 + 1) - 1e8) + 1


def test_init_distributed_forms_the_group_from_the_environment(
        monkeypatch):
    """The three variables name the group: gloo for the CPU (a bare
    ``host:port`` becomes a ``tcp://`` address) or the backend asked for;
    no group without a process id; the default device is CUDA, which
    raises without one. The group's forming is stubbed."""
    calls = []
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(multihost.dist, "get_world_size", lambda: 2)
    monkeypatch.setenv("KAEG_COORDINATOR", "127.0.0.1:29512")
    monkeypatch.setenv("KAEG_NUM_PROCESSES", "2")
    monkeypatch.setenv("KAEG_PROCESS_ID", "1")
    assert multihost.init_distributed(device="cpu") is True
    kw = calls[-1]
    assert (kw["backend"], kw["init_method"], kw["world_size"],
            kw["rank"]) == ("gloo", "tcp://127.0.0.1:29512", 2, 1)
    monkeypatch.setenv("KAEG_COORDINATOR", "tcp://127.0.0.1:1")
    multihost.init_distributed(device="cpu", backend="gloo")
    assert calls[-1]["init_method"] == "tcp://127.0.0.1:1"
    monkeypatch.setenv("KAEG_PROCESS_ID", "-1")
    assert multihost.init_distributed(device="cpu") is False
    assert len(calls) == 2
    # the default device is CUDA: without it the group is not formed
    monkeypatch.setenv("KAEG_PROCESS_ID", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.init_distributed()
    assert len(calls) == 2
