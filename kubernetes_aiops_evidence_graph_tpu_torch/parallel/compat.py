"""The port's counterpart of the ``shard_map`` seam: per-position work and
the collectives between it, driven from the host.

Every sharded path of the port goes through this module. A tensor laid
out on a mesh is a :class:`Sharded`: one block per position, on that
position's device (``place``). :func:`run` calls a per-position function
at every position in row-major order, handing it its blocks and a
:class:`Position` (its ``axis_index``); the collectives sit between such
calls:

* :func:`psum` over ``graph``: the positions' tensors summed in position
  order ``0..D-1`` (on the first position's device, then handed to every
  position of the group);
* :func:`concat_dp`: the dp positions' outputs concatenated in row order;
* the halo collectives of the learned path over ``graph``:
  :func:`ring_shift` (every position's block moves one hop,
  ``(g -> g+1) mod D``) and :func:`all_gather` (the row's blocks
  concatenated in position order, at every position). Both move blocks
  with ``.to()``, which autograd differentiates, and count themselves
  (:data:`ring_hops`, :data:`all_gathers`) so a run can show its
  collective census.

No floating-point atomics, and each sum runs in a fixed order, so results
are the same from run to run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from .mesh import Mesh, Placement

ring_hops = 0
""":func:`ring_shift` calls so far (one hop of every block of the mesh
each); a run resets it to read its census."""
all_gathers = 0
""":func:`all_gather` calls so far."""


@dataclass(frozen=True)
class Position:
    """One position of a mesh: its grid index ``(dp, graph)`` and its
    device."""
    mesh: Mesh
    dp: int
    graph: int
    device: torch.device

    def axis_index(self, axis: str) -> int:
        if axis == "dp":
            return self.dp
        if axis == "graph":
            return self.graph
        raise KeyError(axis)


def positions(mesh: Mesh) -> list[Position]:
    """Every position in row-major order."""
    grid = mesh.grid
    return [Position(mesh, i, g, grid[i, g])
            for i in range(grid.shape[0]) for g in range(grid.shape[1])]


class Sharded:
    """A tensor laid out on a mesh: ``blocks[i, g]`` is the block position
    ``(i, g)`` holds (see :class:`mesh.Placement`)."""

    def __init__(self, placement: Placement, blocks: np.ndarray):
        self.placement = placement
        self.blocks = blocks

    @property
    def mesh(self) -> Mesh:
        return self.placement.mesh

    def block(self, pos: Position) -> Any:
        return self.blocks[pos.dp, pos.graph]


def _blocks_of(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    if x.shape[0] % n:
        raise ValueError(f"dimension {x.shape[0]} not divisible by {n}")
    k = x.shape[0] // n
    return [x[j * k:(j + 1) * k] for j in range(n)]


def place(x: "torch.Tensor | np.ndarray", placement: Placement) -> Sharded:
    """Lay ``x`` out on the mesh: each position gets its own contiguous
    copy of its block (a replica per position, also where positions share
    a device: each position then updates its own copy in place)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    grid = placement.mesh.grid
    axis = placement.axis
    parts = None
    if axis is not None:
        parts = _blocks_of(x, grid.shape[0 if axis == "dp" else 1])
    blocks = np.empty(grid.shape, dtype=object)
    for pos in positions(placement.mesh):
        src = x if axis is None else parts[pos.axis_index(axis)]
        blocks[pos.dp, pos.graph] = src.to(pos.device, copy=True).contiguous()
    return Sharded(placement, blocks)


def run(mesh: Mesh, fn: Callable, *args, where: "Callable | None" = None
        ) -> np.ndarray:
    """``fn(position, *blocks)`` at every position (or those ``where``
    accepts) in row-major order; a :class:`Sharded` argument passes the
    position's block, an object grid (what ``run`` returns) the
    position's entry, anything else passes as it is. Returns the results
    as a ``(dp, graph)`` object grid (None where skipped)."""
    grid = mesh.grid

    def local(a, pos):
        if isinstance(a, Sharded):
            return a.block(pos)
        if isinstance(a, np.ndarray) and a.dtype == object:
            return a[pos.dp, pos.graph]
        return a

    out = np.empty(grid.shape, dtype=object)
    for pos in positions(mesh):
        if where is not None and not where(pos):
            continue
        blocks = [local(a, pos) for a in args]
        out[pos.dp, pos.graph] = fn(pos, *blocks)
    return out


def psum(parts: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Sum over the ``graph`` axis: for each dp row, the tensors of
    positions ``0..D-1`` added in that order on position 0's device; every
    position of the row receives the sum (on its own device)."""
    grid = mesh.grid
    out = np.empty(grid.shape, dtype=object)
    for i in range(grid.shape[0]):
        dev = grid[i, 0]
        total = parts[i, 0]
        for g in range(1, grid.shape[1]):
            total = total + parts[i, g].to(dev)
        for g in range(grid.shape[1]):
            out[i, g] = total if grid[i, g] == dev else total.to(grid[i, g])
    return out


def concat_dp(outs: np.ndarray, mesh: Mesh) -> tuple:
    """The dp positions' output tuples (graph position 0 of each dp row)
    concatenated in row order, on the mesh's first device."""
    first = mesh.grid[0, 0]
    rows = [outs[i, 0] for i in range(outs.shape[0])]
    if len(rows) == 1:
        return tuple(rows[0])
    return tuple(torch.cat([r[k].to(first) for r in rows])
                 for k in range(len(rows[0])))


def ring_shift(blocks: np.ndarray, mesh: Mesh) -> np.ndarray:
    """One hop of the ring over ``graph``: position ``(i, g)`` receives the
    block position ``(i, g - 1 mod D)`` held (on its own device), the
    host-driven counterpart of a ``ppermute`` with the ring permutation.
    ``blocks`` is a ``(dp, graph)`` object grid of tensors; returns the
    shifted grid. Counted in :data:`ring_hops`."""
    global ring_hops
    grid = mesh.grid
    g_size = grid.shape[1]
    out = np.empty(grid.shape, dtype=object)
    for i in range(grid.shape[0]):
        for g in range(g_size):
            out[i, (g + 1) % g_size] = blocks[i, g].to(grid[i, (g + 1)
                                                            % g_size])
    ring_hops += 1
    return out


def all_gather(blocks: np.ndarray, mesh: Mesh) -> np.ndarray:
    """The ``graph`` blocks of each dp row concatenated in position order,
    handed to every position of the row on its own device (a tiled
    ``all_gather``). Counted in :data:`all_gathers`."""
    global all_gathers
    grid = mesh.grid
    out = np.empty(grid.shape, dtype=object)
    for i in range(grid.shape[0]):
        for g in range(grid.shape[1]):
            dev = grid[i, g]
            out[i, g] = torch.cat([blocks[i, j].to(dev)
                                   for j in range(grid.shape[1])])
    all_gathers += 1
    return out
