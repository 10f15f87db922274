"""Multi-process bootstrap: the cross-host half of the communication
backend, over ``torch.distributed``.

The reference scales horizontally by adding worker containers against a
shared server. Here every host runs this same program,
:func:`init_distributed` forms the process group, and a mesh whose outer
axis spans the processes (:func:`make_multihost_mesh`) puts that axis's
sum (``parallel/compat.psum_dp``) across them while the inner ``graph``
axis stays on each process's own positions.

Design rule: put ``dp`` (incidents) on the process axis (its merge is one
sum a step and tolerates network latency) and keep ``graph`` (the halo
exchanges of every layer) inside a process.

Usage (same command on every host, configured by the environment)::

    KAEG_COORDINATOR=host0:9876 KAEG_NUM_PROCESSES=4 KAEG_PROCESS_ID=$i \\
        python -m kubernetes_aiops_evidence_graph_tpu_torch.serve

The group uses NCCL on CUDA and gloo on the CPU (``backend=`` picks one:
a gloo group on CUDA tensors moves them through host copies). With one
process everything here degrades to a no-op and
:func:`make_multihost_mesh` equals ``make_mesh``.
"""
from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import Mesh, device_pool, make_mesh

_GROUP_TIMEOUT = timedelta(seconds=300)


def process_count() -> int:
    """Processes in the group (1 when no group was formed)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def init_distributed(device: "str | torch.device | None" = None,
                     backend: "str | None" = None) -> bool:
    """Form the process group from ``KAEG_COORDINATOR`` (``host:port``),
    ``KAEG_NUM_PROCESSES`` and ``KAEG_PROCESS_ID``, if all three are set
    (or, with ``KAEG_AUTO_DISTRIBUTED=1``, from a launcher's ``RANK`` /
    ``WORLD_SIZE`` / ``MASTER_ADDR`` environment). The backend is NCCL for
    a CUDA ``device`` (the default) and gloo for the CPU, unless
    ``backend`` names one; an NCCL rank takes card ``rank % cards``.
    Returns True when running multi-process after the call."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator = os.environ.get("KAEG_COORDINATOR", "")
    num = int(os.environ.get("KAEG_NUM_PROCESSES", "0") or 0)
    pid = int(os.environ.get("KAEG_PROCESS_ID", "-1") or -1)
    auto = os.environ.get("KAEG_AUTO_DISTRIBUTED", "") == "1"
    if not (coordinator and num > 1 and pid >= 0) and not auto:
        return False
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {"backend": backend, "timeout": _GROUP_TIMEOUT}
    if auto:
        kw["init_method"] = "env://"
    else:
        if "://" not in coordinator:
            coordinator = f"tcp://{coordinator}"
        kw.update(init_method=coordinator, world_size=num, rank=pid)
    if backend == "nccl":
        rank = pid if not auto else int(os.environ.get("RANK", "0"))
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(**kw)
    return dist.get_world_size() > 1


def make_multihost_mesh(graph_per_host: "int | None" = None,
                        device: "str | torch.device | None" = None) -> Mesh:
    """A ``(dp x graph)`` mesh with dp spanning the processes and graph on
    each process's own positions (the default pool of ``device``'s
    platform, ``parallel/mesh.device_pool``). Positions are ordered
    host-major, each naming its rank (``Mesh.ranks``) and its index in
    the group's global pool (``Mesh.pool_index``). With one process this
    is exactly ``make_mesh()``. Every process must call it (the local
    pool sizes are exchanged)."""
    if process_count() == 1:
        return make_mesh(device=device)
    local = device_pool(device)
    graph = graph_per_host or len(local)
    if len(local) % graph:
        raise ValueError(f"graph_per_host={graph} must divide the "
                         f"{len(local)} local positions")
    pools: list = [None] * dist.get_world_size()
    dist.all_gather_object(pools, [str(d) for d in local])
    if len({len(p) for p in pools}) != 1:
        raise ValueError(f"uneven local pools across processes: {pools}")
    devices = [torch.device(d) for p in pools for d in p]
    ranks = [r for r, p in enumerate(pools) for _ in p]
    dp = len(devices) // graph
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(dp, graph), ("dp", "graph"),
                ranks=np.asarray(ranks).reshape(dp, graph))


def host_local_incident_slice(num_incidents: int) -> slice:
    """The incident rows this process feeds (dp is the process axis):
    contiguous blocks, the tail on the last process."""
    n = process_count()
    k = dist.get_rank() if n > 1 else 0
    per = -(-num_incidents // n)  # ceil
    return slice(k * per, min((k + 1) * per, num_incidents))
