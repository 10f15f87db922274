"""Serving across cards: the position streams of ``parallel/compat.py``.

On a CUDA mesh of two or more positions every position runs on a stream
of its own, every compat call forks from the caller's stream and joins
back into it, and the staged slab is reused only after every card's
upload of it ran. None of it needs a card to check here: the plan is a
function of ``torch.device`` objects, the slab pool and the joins are
driven with fake events and streams, and on CPU positions every
collective must return, bit for bit, what its stream-free definition
below returns.
"""
from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu_torch.parallel import compat
from kubernetes_aiops_evidence_graph_tpu_torch.parallel import mesh as pmesh
from kubernetes_aiops_evidence_graph_tpu_torch.rca import heal
from kubernetes_aiops_evidence_graph_tpu_torch.rca.streaming import (
    _SlabPool)

CARDS = [torch.device("cuda", i) for i in range(4)]


# -- the stream plan ----------------------------------------------------------

def test_stream_plan_one_stream_per_cuda_position_keyed_by_pool_index():
    """One entry per CUDA position, keyed by its pool index: four
    positions repeating one card, two cards, and a survivor mesh whose
    pool indices skip an excluded card."""
    one_card = pmesh.make_mesh(1, 4, [CARDS[0]] * 4)
    assert compat.stream_plan(one_card) == {k: CARDS[0] for k in range(4)}
    grid = pmesh.make_mesh(2, 2, CARDS)
    assert compat.stream_plan(grid) == dict(enumerate(CARDS))
    survivors = heal.survivor_mesh(2, (0,), CARDS[:3])
    assert compat.stream_plan(survivors) == {1: CARDS[1], 2: CARDS[2]}


@pytest.mark.parametrize("mesh", [
    pmesh.make_mesh(1, 1, [CARDS[0]]),
    pmesh.dp_mesh(1, [CARDS[1]]),
    pmesh.make_mesh(2, 2, ["cpu"] * 4),
], ids=["one_card_position", "one_dp_position", "cpu_grid"])
def test_no_stream_for_one_position_or_the_cpu(mesh):
    """D = 1 and the CPU take no stream (and nothing here asks CUDA)."""
    assert compat.stream_plan(mesh) is None
    assert compat._streams(mesh) is None


# -- the slab: every card's upload before a rewrite ----------------------------

class _Event:
    def __init__(self, log: list, name: str, ready: bool):
        self.log, self.name, self.ready = log, name, ready

    def query(self) -> bool:
        return self.ready

    def synchronize(self) -> None:
        self.log.append(self.name)


def test_slab_reuse_waits_on_every_cards_upload():
    """A slab is handed back for a rewrite only after ``synchronize`` on
    each card's upload event; a pending one counts one wait."""
    pool = _SlabPool(copies=2, pin=False)
    a, b = pool.acquire(16), pool.acquire(16)
    assert a is not b and pool.waits == 0
    log: list = []
    a.done = tuple(_Event(log, f"cuda:{i}", ready=i != 2) for i in range(4))
    assert pool.acquire(16) is a
    assert log == [f"cuda:{i}" for i in range(4)]
    assert pool.waits == 1
    b.done = tuple(_Event(log, f"b{i}", ready=True) for i in range(2))
    assert pool.acquire(16) is b
    assert log[4:] == ["b0", "b1"] and pool.waits == 1
    a.done = ()                         # the CPU: nothing to wait on
    assert pool.acquire(16) is a and len(log) == 6


# -- the joins: one done after every position --------------------------------

class _Stream:
    def __init__(self, name: str, log: list):
        self.name, self.log = name, log

    def record_event(self):
        self.log.append(("record", self.name))
        return self

    def wait_event(self, ev) -> None:       # a fork
        self.log.append(("fork", self.name, ev.name))

    def wait_stream(self, other) -> None:
        self.log.append(("wait", self.name, other.name))

    def __repr__(self) -> str:
        return self.name


@pytest.mark.parametrize("in_session", [False, True],
                         ids=["call_by_call", "session"])
def test_a_tick_records_its_done_after_every_positions_work(monkeypatch,
                                                            in_session):
    """A rules tick's calls (each position's fold, the sum over ``graph``,
    the tail, the concat over ``dp``) on fake position streams, call by
    call or in one ``compat.session``: every position waits on the caller
    before its work, the caller waits on every position after its last
    work, and so the tick's one ``done`` recorded on the caller follows
    every position. A session forks and joins each stream once."""
    log: list = []
    mesh = pmesh.make_mesh(2, 2, ["cpu"] * 4)
    caller = _Stream("caller", log)
    grid = np.empty((2, 2), dtype=object)
    for i in range(2):
        for g in range(2):
            grid[i, g] = caller if (i, g) == (0, 0) else _Stream(
                f"s{i}{g}", log)
    current = [caller]

    @contextlib.contextmanager
    def at(s):
        prev = current[0]
        current[0] = prev if s is None else s
        try:
            yield
        finally:
            current[0] = prev

    real_join = compat._join
    joins_called = []

    def join(c, streams):
        joins_called.append(len(log))
        real_join(c, streams)

    monkeypatch.setattr(compat, "_streams", lambda m: (grid, caller))
    monkeypatch.setattr(compat, "_at", at)
    monkeypatch.setattr(compat, "_join", join)

    def fold(pos, x):
        log.append(("work", current[0].name))
        return x * (pos.graph + 1)

    def tail(pos, total):
        log.append(("work", current[0].name))
        return (total + 1,)

    x = compat.place(torch.arange(8, dtype=torch.float32).reshape(4, 2),
                     pmesh.dp_sharded(mesh))
    start = len(log)
    with (compat.session(mesh) if in_session else contextlib.nullcontext()):
        folded = compat.psum(compat.run(mesh, fold, x), mesh)
        out = compat.concat_dp(compat.run(mesh, tail, folded,
                                          where=lambda p: p.graph == 0),
                               mesh)
    caller.record_event()                       # the tick's ``done``
    done = len(log) - 1
    assert torch.equal(out[0], torch.arange(8.).reshape(4, 2) * 3 + 1)
    name = {(i, g): grid[i, g].name for i in range(2) for g in range(2)}
    for (i, g), s in name.items():
        if s == "caller":
            continue
        work = [k for k, e in enumerate(log) if e == ("work", s)]
        forks = [k for k, e in enumerate(log)
                 if e == ("fork", s, "caller") and k > start]
        joins = [k for k, e in enumerate(log) if e == ("wait", "caller", s)]
        assert work and forks and forks[0] < work[0], s
        assert joins and work[-1] < joins[-1] < done, s
        if g:
            # the row's sum waits on this position's fold before the
            # row's tail reads it
            lead = name[(i, 0)]
            hand = [k for k, e in enumerate(log)
                    if e == ("wait", lead, s) and k > work[0]]
            tail_at = [k for k, e in enumerate(log)
                       if e == ("work", lead)][-1]
            assert hand and hand[0] < tail_at, s
        if in_session:
            assert len(forks) == 1, s
    assert len([k for k in joins_called if k > start]) == (
        1 if in_session else 4)


# -- every collective on CPU positions, against the stream-free definitions ---

def _ref_whole(x):
    if not isinstance(x, compat.Sharded):
        return x
    blocks, axis = x.blocks, x.placement.axis
    if axis is None:
        return blocks[0, 0]
    row = blocks[0, :] if axis == "graph" else blocks[:, 0]
    dev = row[0].device
    return torch.cat([b.to(dev) for b in row])


def _ref_place(x, placement):
    grid = placement.mesh.grid
    parts = None
    if placement.axis is not None:
        n = grid.shape[0 if placement.axis == "dp" else 1]
        k = x.shape[0] // n
        parts = [x[j * k:(j + 1) * k] for j in range(n)]
    blocks = np.empty(grid.shape, dtype=object)
    for pos in compat.positions(placement.mesh):
        src = x if parts is None else parts[pos.axis_index(placement.axis)]
        blocks[pos.dp, pos.graph] = src.to(pos.device, copy=True).contiguous()
    return compat.Sharded(placement, blocks)


def _ref_psum(parts, mesh):
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


def _ref_psum_dp(parts, mesh):
    grid = mesh.grid
    out = np.empty(grid.shape, dtype=object)
    for g in range(grid.shape[1]):
        dev = grid[0, g]
        total = parts[0, g].to(dev)
        for i in range(1, grid.shape[0]):
            total = total + parts[i, g].to(dev)
        for i in range(grid.shape[0]):
            out[i, g] = total if grid[i, g] == dev else total.to(grid[i, g])
    return out


def _ref_concat_dp(outs, mesh):
    first = mesh.grid[0, 0]
    rows = [outs[i, 0] for i in range(outs.shape[0])]
    return tuple(torch.cat([r[k].to(first) for r in rows])
                 for k in range(len(rows[0])))


def _ref_ring_shift(blocks, mesh):
    grid = mesh.grid
    d = grid.shape[1]
    out = np.empty(grid.shape, dtype=object)
    for i in range(grid.shape[0]):
        for g in range(d):
            out[i, (g + 1) % d] = blocks[i, g].to(grid[i, (g + 1) % d])
    return out


def _ref_all_gather(blocks, mesh):
    grid = mesh.grid
    out = np.empty(grid.shape, dtype=object)
    for i in range(grid.shape[0]):
        for g in range(grid.shape[1]):
            out[i, g] = torch.cat([blocks[i, j].to(grid[i, g])
                                   for j in range(grid.shape[1])])
    return out


def _grid_of(rng, shape=(3, 5)):
    out = np.empty((2, 3), dtype=object)
    for idx in np.ndindex(out.shape):
        out[idx] = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    return out


def _signature(got, inputs) -> list:
    """Each output tensor's bits, and which input it aliases (-1: none)."""
    flat = list(got.ravel() if isinstance(got, np.ndarray) else got)
    ptrs = [t.data_ptr() for t in inputs]
    return [(t.view(torch.int32).tolist(),
             ptrs.index(t.data_ptr()) if t.data_ptr() in ptrs else -1)
            for t in flat]


def _outs_of(rng):
    outs = np.empty((2, 3), dtype=object)
    for i in range(2):
        outs[i, 0] = tuple(torch.from_numpy(rng.standard_normal(
            (4, k)).astype(np.float32)) for k in (1, 3))
    return outs


@pytest.mark.parametrize("name", ["place_whole", "run_psum", "psum_dp",
                                  "concat_dp", "ring_all_gather"])
def test_cpu_collectives_equal_the_stream_free_definitions(name):
    """Every compat collective on a (2 x 3) mesh of CPU positions: the
    same bits, and the same aliasing of its inputs, as the stream-free
    definition."""
    rng = np.random.default_rng(7)
    mesh = pmesh.make_mesh(2, 3, ["cpu"] * 6)
    if name == "place_whole":
        x = torch.from_numpy(rng.standard_normal((12, 4)).astype(np.float32))
        for placement in (pmesh.replicated(mesh), pmesh.dp_sharded(mesh),
                          pmesh.graph_sharded(mesh)):
            got, want = compat.place(x, placement), _ref_place(x, placement)
            assert _signature(got.blocks, [x]) == _signature(want.blocks,
                                                             [x])
            blocks = list(got.blocks.ravel())
            assert _signature([compat.whole(got)], blocks) == _signature(
                [_ref_whole(got)], blocks)
    elif name == "run_psum":
        grid = _grid_of(rng)
        ran = compat.run(mesh, lambda p, t: t * (p.dp + 1) + p.graph, grid)
        want = np.empty(grid.shape, dtype=object)
        for p in compat.positions(mesh):
            want[p.dp, p.graph] = grid[p.dp, p.graph] * (p.dp + 1) + p.graph
        assert _signature(ran, []) == _signature(want, [])
        ins = list(ran.ravel())
        assert _signature(compat.psum(ran, mesh), ins) == _signature(
            _ref_psum(ran, mesh), ins)
    elif name == "psum_dp":
        grid = _grid_of(rng)
        ins = list(grid.ravel())
        assert _signature(compat.psum_dp(grid, mesh), ins) == _signature(
            _ref_psum_dp(grid, mesh), ins)
    elif name == "concat_dp":
        outs = _outs_of(rng)
        ins = [t for i in range(2) for t in outs[i, 0]]
        assert _signature(compat.concat_dp(outs, mesh), ins) == _signature(
            _ref_concat_dp(outs, mesh), ins)
    else:
        grid = _grid_of(rng)
        ins = list(grid.ravel())
        assert _signature(compat.ring_shift(grid, mesh), ins) == _signature(
            _ref_ring_shift(grid, mesh), ins)
        assert _signature(compat.all_gather(grid, mesh), ins) == _signature(
            _ref_all_gather(grid, mesh), ins)
