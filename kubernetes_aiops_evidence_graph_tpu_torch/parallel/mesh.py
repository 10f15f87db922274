"""Device-mesh construction.

The framework's two parallel axes (SURVEY.md §2.4):

* ``dp``    — data parallelism over incidents (the reference's
  "horizontally scalable Temporal workers", worker.py:43-61, reborn as a
  sharded batch dimension);
* ``graph`` — graph parallelism over node shards: the feature table is
  split into contiguous node blocks, and the evidence fold of each block
  is summed over the axis.

A :class:`Mesh` is a grid of positions, each a ``torch.device``. The
positions may span several cards, and a device may stand at several
positions: on one card (or on the CPU) a mesh of D positions exercises
the layout, the routing, the split kernels and the per-position streams
of a D-way mesh, though not the copies between cards. So a ``torch.device``
cannot name a position: each position carries its index into the POOL
the mesh was built from (``pool_index``), the identity a heal's exclusion
bookkeeping keys on; a mesh that spans the processes of a
``torch.distributed`` group (``parallel/multihost.py``) also names the
rank of the process holding each position (``ranks``).
Placements
(:func:`replicated`, :func:`dp_sharded`, :func:`graph_sharded`) say how a
tensor splits into contiguous blocks over an axis; ``parallel/compat.py``
places tensors and runs per-position work and the collectives.

The default device pool is the real one: the CUDA devices on the card's
machine, and on the CPU a pool of host positions whose size
:func:`ensure_host_devices` raises until a mesh is first built from it
(the counterpart of JAX's ``--xla_force_host_platform_device_count``,
which must be set before the backend starts).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

log = logging.getLogger(__name__)

_HOST_POOL = {"devices": 1, "committed": False}
"""The CPU's pool of mesh positions: its size, and whether a mesh has been
built from it (after which it can no longer grow)."""


def ensure_host_devices(n: int) -> bool:
    """Make sure the CPU pool holds at least ``n`` positions, growing it
    while no mesh has been built from it. Returns True when ``n``
    positions are (or will be) available; False once the pool is
    committed at fewer."""
    if n <= 1:
        return True
    if _HOST_POOL["committed"]:
        return _HOST_POOL["devices"] >= n
    _HOST_POOL["devices"] = max(_HOST_POOL["devices"], int(n))
    return True


def host_devices() -> list[torch.device]:
    """The CPU pool's positions (commits the pool's size)."""
    _HOST_POOL["committed"] = True
    return [torch.device("cpu")] * _HOST_POOL["devices"]


def device_pool(device: "str | torch.device | None" = None
                ) -> list[torch.device]:
    """The default pool for a mesh on ``device``'s platform: every CUDA
    device (``device=None`` means CUDA and raises without it), or the
    CPU's host positions."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return host_devices()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def canonical_device(d) -> torch.device:
    """``d`` as a position names it: a CUDA device with its card's index,
    so positions compare equal to tensors' devices."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _grid(devices, shape: tuple[int, ...]) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = canonical_device(d)
    return arr.reshape(shape)


def process_index() -> int:
    """This process's rank in the ``torch.distributed`` group (0 when no
    group was formed)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class Mesh:
    """A grid of device positions with named axes (``("dp", "graph")`` or
    ``("dp",)``). ``shape`` maps each axis name to its size.
    ``pool_index`` (same shape) names each position's index in the pool
    its devices came from (default: its row-major position, the devices
    given being the pool); ``ranks`` the process holding it, or None
    (the default) for a mesh whose positions all live in this process."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...],
                 pool_index=None, ranks=None):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.pool_index = (np.arange(devices.size) if pool_index is None
                           else np.asarray(pool_index, np.int64)
                           ).reshape(devices.shape)
        self.ranks = (None if ranks is None
                      else np.asarray(ranks, np.int64).reshape(devices.shape))
        # the positions' streams, made at the first compat call
        # (``parallel/compat._streams``)
        self._streams = None

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def grid(self) -> np.ndarray:
        """The positions as a ``(dp, graph)`` grid (graph 1 on a dp-only
        mesh)."""
        return self.devices.reshape(self.shape["dp"],
                                    self.shape.get("graph", 1))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.ravel()]}, pool "
                f"{self.pool_index.ravel().tolist()})")


class MeshUnavailable(RuntimeError):
    """``serve_graph_shards`` exceeds what the device pool can carry.
    Raised only on the strict path: the serving scorer keeps its logged
    single-device fallback, but callers that must not silently degrade
    (the smoke run, operators asserting a fleet) get a clear error
    instead of a misshaped or missing mesh."""


def settings_mesh(settings, device: "str | torch.device | None" = None,
                  dp: "int | None" = None) -> "Mesh | None":
    """The serving mesh the settings ask for, from the default pool of
    ``device``'s platform: a ``(dp,)`` mesh for ``mesh_dp`` > 1 (the
    incident tables shard), a ``(dp x graph)`` one for
    ``serve_graph_shards`` > 1 (the resident features split into node
    blocks). ``dp`` overrides ``settings.mesh_dp``. None when neither
    axis is asked for, or (logged as ``serve_graph_shards_unavailable``,
    never silent) when the pool is short: single-device serving. The
    one builder of the worker and the resident scorer."""
    dp = max(int(settings.mesh_dp if dp is None else dp), 1)
    graph = max(int(settings.serve_graph_shards), 1)
    if dp <= 1 and graph <= 1:
        return None
    need = dp * graph
    if resolve_device(device).type == "cpu":
        ensure_host_devices(need)
    devices = device_pool(device)
    if len(devices) < need:
        log.warning("serve_graph_shards_unavailable: mesh_dp=%d "
                    "serve_graph_shards=%d devices=%d", dp, graph,
                    len(devices))
        return None
    if graph > 1:
        return make_mesh(dp, graph, devices[:need])
    return dp_mesh(dp, devices)


def serving_mesh(graph: int, devices=None, strict: bool = False,
                 device: "str | torch.device | None" = None
                 ) -> "Mesh | None":
    """(1 x graph) serving mesh for the graph-sharded streaming scorer
    (settings.serve_graph_shards), from ``devices`` or the default pool of
    ``device``'s platform. None when the pool cannot carry the axis —
    callers fall back to single-device serving (logged by the scorer,
    never silent). ``strict=True`` raises :class:`MeshUnavailable` (with
    the requested vs available counts) instead of returning None. The
    positions may repeat one card or span several."""
    if graph <= 1:
        return None
    if devices is None:
        if resolve_device(device).type == "cpu" and \
                not ensure_host_devices(graph):
            if strict:
                raise MeshUnavailable(
                    f"serve_graph_shards={graph} exceeds the "
                    f"{_HOST_POOL['devices']} host positions (the pool "
                    "cannot grow after a mesh was built from it)")
            return None
        devices = device_pool(device)
    if len(devices) < graph:
        if strict:
            raise MeshUnavailable(
                f"serve_graph_shards={graph} exceeds the {len(devices)} "
                "available devices")
        return None
    return Mesh(_grid(list(devices)[:graph], (1, graph)), ("dp", "graph"))


def make_mesh(dp: int | None = None, graph: int | None = None,
              devices=None, device: "str | torch.device | None" = None
              ) -> Mesh:
    """A ``(dp x graph)`` mesh over ``devices`` (default: the pool of
    ``device``'s platform); a missing size is what the devices leave."""
    devices = list(devices if devices is not None else device_pool(device))
    n = len(devices)
    if dp is None and graph is None:
        graph = 2 if n % 2 == 0 and n > 1 else 1
        dp = n // graph
    elif dp is None:
        dp = n // graph
    elif graph is None:
        graph = n // dp
    if dp * graph != n:
        raise ValueError(f"mesh {dp}x{graph} != {n} devices")
    return Mesh(_grid(devices, (dp, graph)), ("dp", "graph"))


def dp_mesh(dp: int, devices) -> Mesh:
    """A one-axis ``("dp",)`` mesh over the first ``dp`` devices."""
    return Mesh(_grid(list(devices)[:dp], (dp,)), ("dp",))


@dataclass(frozen=True)
class Placement:
    """How a tensor lies on a mesh: split along its first dimension into
    contiguous blocks over ``axis`` (each position on that axis holds its
    block, replicated over the other axis), or whole at every position
    (``axis`` None)."""
    mesh: Mesh
    axis: "str | None"


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, None)


def dp_sharded(mesh: Mesh) -> Placement:
    return Placement(mesh, "dp")


def graph_sharded(mesh: Mesh) -> Placement:
    return Placement(mesh, "graph")
