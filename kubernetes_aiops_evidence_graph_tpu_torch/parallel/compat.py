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
* :func:`psum_dp`: the sum over ``dp``, also across the processes of a
  ``torch.distributed`` group (a mesh from
  ``parallel/multihost.make_multihost_mesh``): every row's tensor is
  gathered in rank order and summed in position order;
* the halo collectives of the learned path over ``graph``:
  :func:`ring_shift` (every position's block moves one hop,
  ``(g -> g+1) mod D``) and :func:`all_gather` (the row's blocks
  concatenated in position order, at every position). Both move blocks
  with ``.to()``, which autograd differentiates, and count themselves
  (:data:`ring_hops`, :data:`all_gathers`) so a run can show its
  collective census.

No floating-point atomics, and each sum runs in a fixed order, so results
are the same from run to run. On a mesh that spans processes, a process
places, runs and sums only the positions it holds (``Mesh.ranks``); the
``graph`` collectives stay inside one process, as ``make_multihost_mesh``
keeps the graph axis on each process's own positions.

**Streams.** On a CUDA mesh of two or more positions every position runs
its work on a stream of its own (:func:`stream_plan`, made once per pool
position): the first position this process holds runs on the caller's
current stream, every other on a stream of its own, so positions that
share a card overlap and positions on several cards run side by side.
Every function here forks at entry (the streams it touches wait on the
caller's stream) and joins at exit (the caller's stream waits on each of
them), so the caller's later work, and a tick's ``done`` event recorded
after it, covers every position; a tick runs its calls in one
:func:`session`, which forks each stream once and joins them once. A collective that reads one position's
tensor at another waits on the producer's stream first, and a tensor a
second stream reads on the same card is ``record_stream``-ed there, so
its memory does not go back to the allocator while that stream may
still read it. Cross-card moves run with both cards' current streams set
to the two positions' streams (PyTorch's peer copy orders itself
against exactly those). A one-position mesh and the CPU take none of
this: no stream, event or copy is added, and every function does what it
did before streams existed.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, Placement, process_index

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
    """Every position this process holds, in row-major order."""
    grid = mesh.grid
    ranks = None if mesh.ranks is None else mesh.ranks.reshape(grid.shape)
    me = process_index()
    return [Position(mesh, i, g, grid[i, g])
            for i in range(grid.shape[0]) for g in range(grid.shape[1])
            if ranks is None or ranks[i, g] == me]


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


# -- the position streams -----------------------------------------------------

_STREAMS: dict = {}
"""Each pool position's own stream, keyed by (device, pool index): made
once, so every mesh cut from one pool (a heal's or a scale's fresh mesh,
the elastic controller's prewarmed one) reuses its positions' streams."""
_STREAMS_LOCK = threading.Lock()


def stream_plan(mesh: Mesh) -> "dict[int, torch.device] | None":
    """Which positions run on a stream of their own: ``{pool index:
    device}`` for every CUDA position this process holds, on a mesh of two
    or more of them; None for a one-position mesh or a CPU one, which take
    no stream at all. The first held position's stream is the caller's
    current stream whenever the caller is on that card."""
    held = [p for p in positions(mesh) if p.device.type == "cuda"]
    if len(held) < 2:
        return None
    index = mesh.pool_index.reshape(mesh.grid.shape)
    return {int(index[p.dp, p.graph]): p.device for p in held}


def _pool_stream(device: torch.device, key: int) -> "torch.cuda.Stream":
    with _STREAMS_LOCK:
        s = _STREAMS.get((str(device), key))
        if s is None:
            s = _STREAMS[(str(device), key)] = torch.cuda.Stream(device)
        return s


def prepare_streams(mesh: Mesh) -> None:
    """Make the streams of ``mesh``'s positions now (the elastic
    controller's prewarm), not at its first tick."""
    _streams(mesh)


def _streams(mesh: Mesh) -> "tuple[np.ndarray, Any] | None":
    """``(grid of each held position's stream, the caller's stream)`` for
    one call on ``mesh``, or None where :func:`stream_plan` is None. The
    grid is cached on the mesh; only the first held position's entry
    follows the caller."""
    cached = mesh._streams
    if cached is None:
        plan = stream_plan(mesh)
        if plan is None:
            cached = (None, None)
        else:
            index = mesh.pool_index.reshape(mesh.grid.shape)
            held = positions(mesh)
            grid = np.empty(mesh.grid.shape, dtype=object)
            for p in held:
                grid[p.dp, p.graph] = _pool_stream(
                    p.device, int(index[p.dp, p.graph]))
            cached = (grid, held[0])
        mesh._streams = cached
    grid, lead = cached
    if grid is None:
        return None
    caller = _SESSION.caller or torch.cuda.current_stream()
    if caller.device == lead.device:
        grid = grid.copy()
        grid[lead.dp, lead.graph] = caller
    return grid, caller


def _fork(caller, streams) -> None:
    """Each stream waits on the caller's work so far (one event)."""
    ev = None
    for s in streams:
        if s != caller:
            if ev is None:
                ev = caller.record_event()
            s.wait_event(ev)


def _join(caller, streams) -> None:
    """The caller's stream waits on each stream's work so far: what the
    caller enqueues next (a tick's ``done`` event among it) follows every
    position."""
    for s in streams:
        if s != caller:
            caller.wait_stream(s)


class _Session(threading.local):
    """The session open on this thread (:func:`session`): its caller's
    stream and the streams it has forked (None when none is open)."""
    caller = None
    forked = None


_SESSION = _Session()


@contextlib.contextmanager
def session(mesh: Mesh):
    """One fork and one join around a run of compat calls on ``mesh`` (a
    tick, a scoring pass, a train step's forward): inside, a call forks
    only the streams the session has not forked yet and joins none, and
    the session joins every one at exit. Inside a session a position
    reads another's work only through a compat collective, which waits
    on the producer's stream, and every call comes from the caller's
    stream. A no-op where the mesh takes no streams and inside an open
    session."""
    sg = _streams(mesh)
    if sg is None or _SESSION.caller is not None:
        yield
        return
    _SESSION.caller, _SESSION.forked = sg[1], {}
    try:
        yield
    finally:
        caller, forked = _SESSION.caller, list(_SESSION.forked)
        _SESSION.caller = _SESSION.forked = None
        _join(caller, forked)


@contextlib.contextmanager
def _call(mesh: Mesh, todo: "list[Position] | None" = None):
    """One compat call on ``mesh``: yields ``(stream grid, caller's
    stream)`` (None where the mesh takes no streams), forked from the
    caller's stream at entry and joined into it at exit over the
    positions ``todo`` (default: every held position); inside a
    :func:`session` of the same caller, forked once and joined by the
    session."""
    sg = _streams(mesh)
    if sg is None:
        yield None
        return
    grid, caller = sg
    touched = list(dict.fromkeys(
        grid[p.dp, p.graph] for p in (positions(mesh) if todo is None
                                      else todo)))
    if _SESSION.caller is caller:
        new = [s for s in touched if s not in _SESSION.forked]
        _fork(caller, new)
        _SESSION.forked.update(dict.fromkeys(new))
        yield sg
        return
    _fork(caller, touched)
    try:
        yield sg
    finally:
        _join(caller, touched)


def _at(s):
    """Make ``s`` the current stream (and its card the current device); a
    no-op for None and for an open session's caller, already current."""
    if s is None or s is _SESSION.caller:
        return contextlib.nullcontext()
    return torch.cuda.stream(s)


def _move(x: torch.Tensor, dev: torch.device, src=None, dst=None,
          copy: bool = False) -> torch.Tensor:
    """``x`` (last written on stream ``src``) made readable on stream
    ``dst`` at ``dev``. Without streams this is ``x.to(dev)``. On one card
    ``dst`` waits on ``src`` and ``x`` is recorded on ``dst`` (the same
    tensor unless ``copy``); across cards the peer copy runs with ``src``
    and ``dst`` as the two cards' current streams, so it follows ``src``'s
    writes, and ``dst`` waits on it."""
    if src is None or src == dst:
        if x.device == dev and not copy:
            return x
        with _at(dst):
            return x.to(dev, copy=copy)
    if x.device == dev:
        dst.wait_stream(src)
        if x.is_cuda:
            x.record_stream(dst)
        if not copy:
            return x
        with _at(dst):
            return x.clone()
    with _at(dst), _at(src):
        return x.to(dev, copy=copy)


def _stream_at(sg, i: int, g: int):
    """Position ``(i, g)``'s stream in a :func:`_call`, None without."""
    return None if sg is None else sg[0][i, g]


def whole(x: "torch.Tensor | Sharded") -> torch.Tensor:
    """The tensor a :class:`Sharded` lays out, on its first position's
    device: the blocks of dp row 0 concatenated in ``graph`` position
    order (a graph split), of graph column 0 in ``dp`` row order (a dp
    split), or position (0, 0)'s replica. A plain tensor passes as it
    is. Read on position (0, 0)'s stream, after each block's own."""
    if not isinstance(x, Sharded):
        return x
    blocks, axis = x.blocks, x.placement.axis
    if axis is None:
        with _call(x.mesh, [p for p in positions(x.mesh)
                            if (p.dp, p.graph) == (0, 0)]):
            return blocks[0, 0]
    idx = ([(0, g) for g in range(blocks.shape[1])] if axis == "graph"
           else [(i, 0) for i in range(blocks.shape[0])])
    with _call(x.mesh, [p for p in positions(x.mesh)
                        if (p.dp, p.graph) in idx]) as streams:
        dev = blocks[0, 0].device
        lead = _stream_at(streams, 0, 0)
        parts = [_move(blocks[i, g], dev, _stream_at(streams, i, g), lead)
                 for i, g in idx]
        with _at(lead):
            return torch.cat(parts)


def _blocks_of(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    if x.shape[0] % n:
        raise ValueError(f"dimension {x.shape[0]} not divisible by {n}")
    k = x.shape[0] // n
    return [x[j * k:(j + 1) * k] for j in range(n)]


def place(x: "torch.Tensor | np.ndarray", placement: Placement) -> Sharded:
    """Lay ``x`` out on the mesh: each position gets its own contiguous
    copy of its block (a replica per position, also where positions share
    a device: each position then updates its own copy in place), made on
    the position's stream."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    mesh = placement.mesh
    grid = mesh.grid
    axis = placement.axis
    parts = None
    if axis is not None:
        parts = _blocks_of(x, grid.shape[0 if axis == "dp" else 1])
    blocks = np.empty(grid.shape, dtype=object)
    with _call(mesh) as streams:
        src_s = None if streams is None else streams[1]
        for pos in positions(mesh):
            src = x if axis is None else parts[pos.axis_index(axis)]
            dst_s = _stream_at(streams, pos.dp, pos.graph)
            if src.device.type == "cpu":
                with _at(dst_s):
                    b = src.to(pos.device, copy=True)
            else:
                b = _move(src, pos.device, src_s, dst_s, copy=True)
            with _at(dst_s):
                blocks[pos.dp, pos.graph] = b.contiguous()
    return Sharded(placement, blocks)


def upload(mesh: Mesh, host: torch.Tensor, copy: bool = False
           ) -> tuple[dict, tuple]:
    """One non-blocking copy of ``host`` to each device of the mesh, on
    the stream of that device's first position: ``({device: tensor},
    events)``, one event per CUDA device marking its copy (the host may
    rewrite ``host`` once every one has run; none on the CPU). The
    device's other positions read the copy after the exit join."""
    firsts: dict = {}
    for p in positions(mesh):
        firsts.setdefault(p.device, p)
    out: dict = {}
    done = []
    with _call(mesh, list(firsts.values())) as streams:
        for dev, p in firsts.items():
            s = _stream_at(streams, p.dp, p.graph)
            with _at(s):
                out[dev] = host.to(dev, non_blocking=True, copy=copy)
                if dev.type == "cuda":
                    ev = torch.cuda.Event()
                    ev.record(s)
                    done.append(ev)
    return out, tuple(done)


def run(mesh: Mesh, fn: Callable, *args, where: "Callable | None" = None
        ) -> np.ndarray:
    """``fn(position, *blocks)`` at every position (or those ``where``
    accepts) in row-major order, each on its position's stream; a
    :class:`Sharded` argument passes the position's block, an object grid
    (what ``run`` returns) the position's entry, anything else passes as
    it is. Returns the results as a ``(dp, graph)`` object grid (None
    where skipped)."""
    grid = mesh.grid

    def local(a, pos):
        if isinstance(a, Sharded):
            return a.block(pos)
        if isinstance(a, np.ndarray) and a.dtype == object:
            return a[pos.dp, pos.graph]
        return a

    todo = [p for p in positions(mesh) if where is None or where(p)]
    out = np.empty(grid.shape, dtype=object)
    with _call(mesh, todo) as streams:
        for pos in todo:
            blocks = [local(a, pos) for a in args]
            with _at(_stream_at(streams, pos.dp, pos.graph)):
                out[pos.dp, pos.graph] = fn(pos, *blocks)
    return out


def psum(parts: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Sum over the ``graph`` axis: for each dp row, the tensors of
    positions ``0..D-1`` added in that order on position 0's device (and
    stream); every position of the row receives the sum (on its own
    device)."""
    grid = mesh.grid
    out = np.empty(grid.shape, dtype=object)
    with _call(mesh) as streams:
        for i in range(grid.shape[0]):
            dev = grid[i, 0]
            lead = _stream_at(streams, i, 0)
            total = parts[i, 0]
            for g in range(1, grid.shape[1]):
                part = _move(parts[i, g], dev, _stream_at(streams, i, g),
                             lead)
                with _at(lead):
                    total = total + part
            for g in range(grid.shape[1]):
                out[i, g] = total if g == 0 else _move(
                    total, grid[i, g], lead, _stream_at(streams, i, g))
    return out


def psum_dp(parts: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Sum over the ``dp`` axis: for each graph column, the tensors of rows
    ``0..dp-1`` added in that order, the sum handed to every position of
    the column this process holds (on its own device). ``parts`` is a
    ``(dp, graph)`` object grid filled at this process's positions.

    Across the processes of a ``torch.distributed`` group the rows are
    first all-gathered in rank order (each rank's rows in position order,
    the host-major order of ``make_multihost_mesh``) and then summed in
    position order on every rank: neither gloo's nor NCCL's all-reduce
    fixes its order of addition, so the sum is not left to them. Gloo
    moves CUDA tensors only for broadcast and all-reduce, so on a gloo
    group the rows travel through host copies (and the sum returns to
    the positions' devices); NCCL gathers them on the card. The gather
    and the sum run on the stream of the column's first held position."""
    grid = mesh.grid
    multi = mesh.ranks is not None
    ranks = (mesh.ranks.reshape(grid.shape) if multi
             else np.zeros(grid.shape, np.int64))
    me = process_index() if multi else 0
    out = np.empty(grid.shape, dtype=object)
    with _call(mesh) as streams:
        for g in range(grid.shape[1]):
            mine = [i for i in range(grid.shape[0]) if ranks[i, g] == me]
            if not mine:
                continue
            dev = grid[mine[0], g]
            lead = _stream_at(streams, mine[0], g)
            rows = [_move(parts[i, g], dev, _stream_at(streams, i, g), lead)
                    for i in mine]
            with _at(lead):
                if multi:
                    rows = _gather_rows(rows, ranks[:, g])
                total = rows[0].to(dev)
                for r in rows[1:]:
                    total = total + r.to(dev)
            for i in mine:
                out[i, g] = total if i == mine[0] else _move(
                    total, grid[i, g], lead, _stream_at(streams, i, g))
    return out


def _gather_rows(rows: list, row_ranks: np.ndarray) -> list:
    """Every rank's ``rows`` (equal shapes), in rank order: one
    ``all_gather`` of this rank's stacked rows. Through the host on a
    gloo group, on the rows' card on NCCL."""
    local = torch.stack(rows)
    via_host = dist.get_backend() == "gloo" and local.device.type != "cpu"
    # graft-audit: allow[host-sync] gloo moves host tensors only: a CUDA position's rows cross the host on a gloo group (the NCCL path, via_host False, sends them from the card); JAX's psum has no host-driven counterpart
    send = local.cpu() if via_host else local
    counts = np.bincount(row_ranks, minlength=dist.get_world_size())
    bufs = [torch.empty((int(c),) + tuple(send.shape[1:]), dtype=send.dtype,
                        device=send.device) for c in counts]
    dist.all_gather(bufs, send)
    return [r for buf in bufs for r in buf]


def concat_dp(outs: np.ndarray, mesh: Mesh) -> tuple:
    """The dp positions' output tuples (graph position 0 of each dp row)
    concatenated in row order, on the mesh's first device (and stream)."""
    first = mesh.grid[0, 0]
    rows = [outs[i, 0] for i in range(outs.shape[0])]
    if len(rows) == 1:
        return tuple(rows[0])
    with _call(mesh, [p for p in positions(mesh) if p.graph == 0]
               ) as streams:
        lead = _stream_at(streams, 0, 0)
        moved = [[_move(t, first, _stream_at(streams, i, 0), lead)
                  for t in r] for i, r in enumerate(rows)]
        with _at(lead):
            return tuple(torch.cat([r[k] for r in moved])
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
    with _call(mesh) as streams:
        for i in range(grid.shape[0]):
            for g in range(g_size):
                nxt = (g + 1) % g_size
                out[i, nxt] = _move(blocks[i, g], grid[i, nxt],
                                    _stream_at(streams, i, g),
                                    _stream_at(streams, i, nxt))
    ring_hops += 1
    return out


def all_gather(blocks: np.ndarray, mesh: Mesh) -> np.ndarray:
    """The ``graph`` blocks of each dp row concatenated in position order,
    handed to every position of the row on its own device (a tiled
    ``all_gather``). Counted in :data:`all_gathers`."""
    global all_gathers
    grid = mesh.grid
    out = np.empty(grid.shape, dtype=object)
    with _call(mesh) as streams:
        for i in range(grid.shape[0]):
            for g in range(grid.shape[1]):
                dev = grid[i, g]
                s = _stream_at(streams, i, g)
                parts = [_move(blocks[i, j], dev, _stream_at(streams, i, j),
                               s) for j in range(grid.shape[1])]
                with _at(s):
                    out[i, g] = torch.cat(parts)
    all_gathers += 1
    return out
