"""The port's write-ahead journal (``rca/journal.py``) against the JAX
package's: the same batches make the same bytes on disk, each package
reads the other's log, a torn tail is detected and truncated to the same
valid prefix, a crash in a snapshot write keeps the previous snapshot,
and compaction keeps the same batches. The patterns are
tests/test_shield.py:268 and :293."""
from __future__ import annotations

import io
import os

import numpy as np
import pytest
import torch

from kubernetes_aiops_evidence_graph_tpu.rca import journal as j_journal
from kubernetes_aiops_evidence_graph_tpu_torch.rca import journal as t_journal

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)

PACKAGES = {"jax": j_journal, "port": t_journal}


def _batches(seed: int = 0) -> list:
    """(recs, seq_lo, seq_hi, kind, meta) per batch, made from a seed:
    store-journal records of every op, a quarantine marker, params swaps
    at two generations and a mesh record."""
    rng = np.random.default_rng(seed)
    ops = ("node+", "node~", "node-", "edge+", "edge-")
    out, seq = [], 0
    for b in range(8):
        recs = []
        for _ in range(int(rng.integers(0, 6))):
            seq += 1
            op = ops[int(rng.integers(0, len(ops)))]
            a, c = f"pod:ns:p{int(rng.integers(0, 50))}", f"node:n{b}"
            recs.append((seq, op, a, c, int(rng.integers(0, 9)))
                        if op.startswith("edge") else (seq, op, a, 3))
        out.append((recs, seq - len(recs), seq, "deltas", {}))
    out.insert(3, ((), 4, 7, "quarantine", {"reason": "non-finite rows"}))
    out.insert(5, ((), seq, seq, "params_swap",
                   {"generation": 1, "leaves": [np.arange(4, dtype=np.float32)],
                    "source": "gen1"}))
    out.append(((), seq, seq, "params_swap",
                {"generation": 2, "leaves": [np.ones(4, np.float32)],
                 "source": "gen2"}))
    out.append(((), seq, seq, "mesh_heal", {"heal_gen": 1, "shards": 1}))
    return out


def _fill(mod, directory, batches) -> None:
    j = mod.DeltaJournal(str(directory))
    for recs, lo, hi, kind, meta in batches:
        if kind == "quarantine":
            j.mark_quarantined(lo, hi, reason=meta["reason"])
        else:
            j.append(recs, lo, hi, kind=kind, **meta)
    j.close()


def _summary(batches) -> list:
    return [(b.kind, b.seq_lo, b.seq_hi, list(b.recs),
             {k: (v if k != "leaves" else [x.tolist() for x in v])
              for k, v in b.meta.items()}) for b in batches]


def test_frame_bytes_equal_jax():
    """``[u32 length][u32 crc32][payload]``: the same frame for the same
    payload, torn header included when the fault hook fires."""
    payload = b"\x00\x01payload\xff" * 7
    got, want = io.BytesIO(), io.BytesIO()
    assert t_journal._write_frame(got, payload, sync=False) == len(
        payload) + 8
    j_journal._write_frame(want, payload, sync=False)
    assert got.getvalue() == want.getvalue()
    assert t_journal._FRAME.format == j_journal._FRAME.format
    assert (t_journal.WAL_NAME, t_journal.SNAP_NAME) == (
        j_journal.WAL_NAME, j_journal.SNAP_NAME)

    def crash(stage):
        raise RuntimeError(stage)
    torn = {}
    for name, mod in PACKAGES.items():
        buf = io.BytesIO()
        with pytest.raises(RuntimeError, match="journal_append"):
            mod._write_frame(buf, payload, fault_hook=crash, sync=False)
        torn[name] = buf.getvalue()
    assert torn["jax"] == torn["port"] and len(torn["port"]) == 8


def test_logs_are_byte_equal_and_each_reads_the_others(tmp_path):
    batches = _batches()
    for name, mod in PACKAGES.items():
        _fill(mod, tmp_path / name, batches)
    wal = {n: (tmp_path / n / t_journal.WAL_NAME).read_bytes()
           for n in PACKAGES}
    assert wal["jax"] == wal["port"]
    read = {}
    for reader, writer in (("port", "jax"), ("jax", "port"), ("port", "port")):
        j = PACKAGES[reader].DeltaJournal(str(tmp_path / writer))
        got, torn = j.read()
        j.close()
        assert torn == 0
        read[reader, writer] = _summary(got)
    assert read["port", "jax"] == read["jax", "port"] == read["port", "port"]
    assert [b.kind for b in got].count("params_swap") == 2


@pytest.mark.parametrize("cut", ["payload", "header", "garbage"])
def test_torn_tail_is_truncated_to_the_same_prefix_and_extends(tmp_path, cut):
    """A torn or corrupt tail (the payload cut short, a header cut short,
    bytes flipped) is detected by the checksum and physically truncated
    to the same valid prefix in both packages; the truncated log extends
    cleanly and replays."""
    batches = _batches(3)[:5]
    sizes = {}
    for name, mod in PACKAGES.items():
        d = tmp_path / name
        _fill(mod, d, batches)
        path = d / t_journal.WAL_NAME
        data = path.read_bytes()
        if cut == "payload":
            data = data[:-3]
        elif cut == "header":
            data = data + data[:5]
        else:
            data = data[:-3] + b"\xff\xff\xff"
        path.write_bytes(data)
        j = mod.DeltaJournal(str(d))
        got, torn = j.read()
        assert torn == 1 and j.torn_truncations == 1
        sizes[name] = (len(got), os.path.getsize(path))
        j.append([(99, "node~", "pod:ns:p1")], 98, 99)
        again, torn = j.read()
        j.close()
        assert torn == 0 and len(again) == len(got) + 1
        assert again[-1].recs == [(99, "node~", "pod:ns:p1")]
    assert sizes["jax"] == sizes["port"]
    assert sizes["port"][0] == (len(batches) if cut == "header"
                                else len(batches) - 1)


def test_snapshot_write_crash_keeps_the_previous_snapshot(tmp_path):
    for name, mod in PACKAGES.items():
        calls = {"n": 0}

        def crash_second(stage):
            if stage == "snapshot_write":
                calls["n"] += 1
                if calls["n"] == 2:
                    raise RuntimeError("crash mid-snapshot")

        j = mod.DeltaJournal(str(tmp_path / name), fault_hook=crash_second)
        j.write_snapshot({"epoch": "e1", "store_seq": 7,
                          "flat": np.arange(5, dtype=np.int32)})
        with pytest.raises(RuntimeError):
            j.write_snapshot({"epoch": "e1", "store_seq": 9})
        state = j.load_snapshot()
        assert state is not None and state["store_seq"] == 7
        np.testing.assert_array_equal(state["flat"], np.arange(5))
        assert os.path.exists(j.snap_path + ".tmp")   # the stale temp
        j.close()
    # a checksum-corrupt snapshot is unusable, never partially trusted
    snap = tmp_path / "port" / t_journal.SNAP_NAME
    snap.write_bytes(snap.read_bytes()[:-1] + b"\x00")
    for mod in PACKAGES.values():
        j = mod.DeltaJournal(str(tmp_path / "port"))
        assert j.load_snapshot() is None
        j.close()


@pytest.mark.parametrize("params_gen,heal_gen", [(None, None), (1, None),
                                                 (2, 1), (0, 0)])
def test_compaction_keeps_the_same_batches(tmp_path, params_gen, heal_gen):
    """compact(through_seq) drops the batches a snapshot covers, keeps the
    params_swap records of newer generations (all of them when the
    snapshot's generation is unknown) and the mesh records likewise, by
    their own generation; the rewritten logs are byte-equal."""
    batches = _batches(5)
    through = batches[4][2]
    for name, mod in PACKAGES.items():
        _fill(mod, tmp_path / name, batches)
        j = mod.DeltaJournal(str(tmp_path / name))
        j.compact(through, through_params_gen=params_gen,
                  through_heal_gen=heal_gen)
        kept, torn = j.read()
        j.close()
        assert torn == 0
        assert all(b.seq_hi > through for b in kept if b.kind in (
            "deltas", "quarantine"))
        assert not os.path.exists(j.wal_path + ".tmp")
    wal = {n: (tmp_path / n / t_journal.WAL_NAME).read_bytes()
           for n in PACKAGES}
    assert wal["jax"] == wal["port"]
    j = t_journal.DeltaJournal(str(tmp_path / "port"))
    swaps = [b.meta["generation"] for b in j.read()[0]
             if b.kind == "params_swap"]
    j.close()
    assert swaps == [g for g in (1, 2) if params_gen is None or g > params_gen]


def test_group_commit_defers_the_fsync_but_never_the_write(tmp_path):
    j = t_journal.DeltaJournal(str(tmp_path), fsync_every=3)
    for i in range(4):
        j.append([(i + 1, "node~", "pod:ns:p")], i, i + 1)
        # every append is written and flushed: a reader sees it at once
        assert len(t_journal._read_frames(j.wal_path)[0]) == i + 1
    assert j._unsynced == 1 and j.appended_batches == 4
    j.mark_quarantined(3, 4, reason="r")      # always fsync'd
    assert j._unsynced == 0
    j.close()
