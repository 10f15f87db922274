"""Crash-consistent persistence for the resident serving state (graft-shield).

Two artifacts, both host-side and both O(what they carry):

* **Write-ahead delta journal** (``<dir>/deltas.wal``) — every store-journal
  record batch the shield is about to apply to the donated device state is
  appended and fsync'd FIRST, so a crash mid-tick can always be replayed.
  Appends are O(delta), never O(N). Each record is framed
  ``[u32 length][u32 crc32][pickle payload]``; the per-record checksum is
  what lets recovery detect a torn tail (a crash mid-append) and truncate
  back to the last durable record instead of failing or replaying garbage.

* **State snapshot** (``<dir>/state.snap``) — a periodic full capture of the
  scorer's host bookkeeping plus the packed device arrays, written
  atomically (temp file + fsync + ``os.replace``) so a crash mid-snapshot
  leaves the PREVIOUS snapshot intact. The snapshot payload carries its own
  crc frame too.

Recovery = load last snapshot + replay the journal suffix (batches whose
store-journal seq range postdates the snapshot). Replay applies the same
records through the same scorer mutation methods, so the recovered state is
bit-identical to the pre-fault state — and strictly cheaper than a full
``_rebuild()``, which re-tensorizes the whole store. Batches may appear
twice after an append retry; application is idempotent MERGE (the store
journal's own replay contract), so duplicates are harmless.

``fault_hook`` is the seam the deterministic fault harness (rca/faults.py)
uses to crash writes mid-record: the hook runs after the header bytes but
before the payload+fsync, producing exactly the torn tail the checksum
logic must survive.
"""
from __future__ import annotations

import os
import pickle
import struct
import threading
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from ..observability import get_logger

log = get_logger("shield.journal")

_FRAME = struct.Struct("<II")          # (payload length, crc32)

WAL_NAME = "deltas.wal"
SNAP_NAME = "state.snap"


@dataclass
class JournalBatch:
    """One appended delta batch: the store-journal records staged for one
    tick, plus the seq range they cover (``seq_hi`` = the store journal's
    cursor after this batch). ``kind`` is ``deltas`` for replayable
    batches and ``quarantine`` for audit markers (a batch whose staged
    values produced non-finite verdicts; its RECORDS are store-truth and
    replay clean — the marker records the incident, it does not skip)."""
    kind: str
    seq_lo: int
    seq_hi: int
    recs: list = field(default_factory=list)
    meta: dict = field(default_factory=dict)


def _write_frame(f, payload: bytes,
                 fault_hook: "Callable[[str], None] | None" = None,
                 stage: str = "journal_append", sync: bool = True) -> int:
    header = _FRAME.pack(len(payload), zlib.crc32(payload))
    f.write(header)
    if fault_hook is not None:
        # crash point BETWEEN header and payload: the torn-tail shape a
        # real mid-append crash produces (header present, payload short)
        fault_hook(stage)
    f.write(payload)
    if sync:
        f.flush()
        os.fsync(f.fileno())
    return len(header) + len(payload)


def _read_frames(path: str) -> tuple[list[bytes], int, int]:
    """(payloads, bytes of valid prefix, torn records dropped). Stops at
    the first short/corrupt frame — everything after a bad checksum is
    untrusted, and a crash can only tear the tail."""
    payloads: list[bytes] = []
    if not os.path.exists(path):
        return payloads, 0, 0
    data = open(path, "rb").read()
    off = 0
    torn = 0
    while off < len(data):
        if off + _FRAME.size > len(data):
            torn = 1
            break
        length, crc = _FRAME.unpack_from(data, off)
        start = off + _FRAME.size
        end = start + length
        if end > len(data) or zlib.crc32(data[start:end]) != crc:
            torn = 1
            break
        payloads.append(data[start:end])
        off = end
    return payloads, off, torn


class DeltaJournal:
    """Append-only WAL + atomic snapshot store under one directory."""

    def __init__(self, directory: str,
                 fault_hook: "Callable[[str], None] | None" = None,
                 fsync_every: int = 1) -> None:
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.wal_path = os.path.join(directory, WAL_NAME)
        self.snap_path = os.path.join(directory, SNAP_NAME)
        self.fault_hook = fault_hook
        # bounded group commit: every append is written+flushed, but the
        # fsync may be deferred for up to `fsync_every` batches (1 =
        # strict per-batch fsync). The data-at-risk window is bounded to
        # that many batches AND only matters for whole-host crashes — the
        # donated-state fault model (device fault / poisoned delta /
        # executor crash) keeps the host alive, where the page cache and
        # the store's own bounded journal still cover the unsynced tail.
        # Quarantine markers, snapshots, and compaction always fsync.
        self.fsync_every = max(int(fsync_every), 1)
        self._unsynced = 0
        self.appended_batches = 0
        self.appended_bytes = 0
        self.torn_truncations = 0
        # serializes WAL file ops: the shield persists snapshots (and
        # compacts) on a background writer thread while serving appends
        self._io_lock = threading.Lock()
        self._wal_f = open(self.wal_path, "ab")

    # -- write-ahead log ---------------------------------------------------

    def append(self, recs: Sequence[tuple], seq_lo: int, seq_hi: int,
               kind: str = "deltas", force_sync: bool = False,
               **meta: Any) -> int:
        """Append one batch (group-committed fsync, see __init__);
        returns bytes written. O(delta)."""
        payload = pickle.dumps(
            {"kind": kind, "seq_lo": int(seq_lo), "seq_hi": int(seq_hi),
             "recs": list(recs), "meta": meta},
            protocol=pickle.HIGHEST_PROTOCOL)
        with self._io_lock:
            self._unsynced += 1
            sync = force_sync or self._unsynced >= self.fsync_every
            n = _write_frame(self._wal_f, payload, self.fault_hook,
                             sync=sync)
            if not sync:
                self._wal_f.flush()
            else:
                self._unsynced = 0
        self.appended_batches += 1
        self.appended_bytes += n
        return n

    def fsync(self) -> None:
        with self._io_lock:
            self._wal_f.flush()
            os.fsync(self._wal_f.fileno())
            self._unsynced = 0

    def mark_quarantined(self, seq_lo: int, seq_hi: int, reason: str) -> int:
        """Audit marker: the batch covering [seq_lo, seq_hi] carried staged
        values that produced non-finite verdicts and was re-ticked from
        replayed (store-truth) state instead. Always fsync'd — an audit
        record that can vanish is not an audit record."""
        return self.append((), seq_lo, seq_hi, kind="quarantine",
                           force_sync=True, reason=reason)

    def read(self) -> tuple[list[JournalBatch], int]:
        """(batches in append order, torn records truncated). A torn or
        checksum-failing tail is physically truncated off the file so the
        next append extends a valid log."""
        with self._io_lock:
            self._wal_f.flush()
            payloads, valid, torn = _read_frames(self.wal_path)
            batches: list[JournalBatch] = []
            offset = 0                 # bytes of the decodable prefix
            for p in payloads:
                try:
                    d = pickle.loads(p)
                except (pickle.UnpicklingError, EOFError, ValueError,
                        AttributeError) as exc:
                    log.warning("wal_record_unreadable", error=str(exc))
                    torn = 1
                    valid = offset     # keep only the decodable prefix
                    break
                offset += _FRAME.size + len(p)
                batches.append(JournalBatch(
                    kind=d["kind"], seq_lo=d["seq_lo"], seq_hi=d["seq_hi"],
                    recs=d["recs"], meta=d.get("meta", {})))
            if torn:
                self.torn_truncations += 1
                log.warning("wal_torn_tail_truncated", valid_bytes=valid)
                self._wal_f.close()
                with open(self.wal_path, "rb+") as f:
                    f.truncate(valid)
                    f.flush()
                    os.fsync(f.fileno())
                self._wal_f = open(self.wal_path, "ab")
        return batches, torn

    def compact(self, through_seq: int,
                through_params_gen: "int | None" = None,
                through_heal_gen: "int | None" = None) -> None:
        """Drop batches fully covered by a snapshot at ``through_seq``
        (rewrite-and-replace, atomic): after a snapshot the prefix is dead
        weight and replay cost must stay O(suffix), not O(history).

        ``params_swap`` records (graft-evolve: a hot checkpoint swap
        journaled ahead of its application) are NOT covered by a store-seq
        horizon — a swap can land at the same store seq as a snapshot
        captured BEFORE it, and dropping its record would recover the old
        generation. They compact by their own monotonic generation:
        records at generations the snapshot already carries
        (``<= through_params_gen``) are dead weight; newer ones survive.
        ``None`` keeps every swap record (a shield that never learned the
        snapshot's generation must not guess). ``mesh_heal`` records
        (graft-heal: a live reshard/re-expansion journaled ahead of its
        application) follow the identical discipline on their own
        monotonic ``heal_gen``."""

        def _keep(b) -> bool:
            if b.kind == "params_swap":
                return (through_params_gen is None
                        or b.meta.get("generation", 0) > through_params_gen)
            if b.kind == "mesh_heal":
                return (through_heal_gen is None
                        or b.meta.get("heal_gen", 0) > through_heal_gen)
            return b.seq_hi > through_seq

        batches, _ = self.read()
        keep = [b for b in batches if _keep(b)]
        tmp = self.wal_path + ".tmp"
        with open(tmp, "wb") as f:
            for b in keep:
                payload = pickle.dumps(
                    {"kind": b.kind, "seq_lo": b.seq_lo, "seq_hi": b.seq_hi,
                     "recs": b.recs, "meta": b.meta},
                    protocol=pickle.HIGHEST_PROTOCOL)
                # one fsync for the whole rewrite (below), not per frame
                _write_frame(f, payload, sync=False)
            f.flush()
            os.fsync(f.fileno())
        with self._io_lock:
            # appends that landed since read() are re-appended atomically:
            # re-read the live WAL tail not present in `keep`
            seen = {(b.kind, b.seq_lo, b.seq_hi, len(b.recs))
                    for b in batches}
            self._wal_f.flush()
            tail, _, _ = _read_frames(self.wal_path)
            with open(tmp, "ab") as f:
                for raw in tail:
                    d = pickle.loads(raw)
                    key = (d["kind"], d["seq_lo"], d["seq_hi"],
                           len(d["recs"]))
                    if key in seen:
                        continue
                    _write_frame(f, raw, sync=False)
                f.flush()
                os.fsync(f.fileno())
            self._wal_f.close()
            os.replace(tmp, self.wal_path)
            self._wal_f = open(self.wal_path, "ab")

    # -- snapshots ---------------------------------------------------------

    def write_snapshot(self, state: dict) -> int:
        """Atomic snapshot write: temp file + fsync + rename. A crash at
        any point (the fault harness injects one mid-payload) leaves the
        previous snapshot intact and a stale ``.tmp`` that the next write
        overwrites."""
        payload = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
        tmp = self.snap_path + ".tmp"
        with open(tmp, "wb") as f:
            _write_frame(f, payload, self.fault_hook, stage="snapshot_write")
        os.replace(tmp, self.snap_path)
        return _FRAME.size + len(payload)

    def load_snapshot(self) -> "dict | None":
        """Last durable snapshot, or None (absent or checksum-corrupt —
        a corrupt snapshot is unusable, never partially trusted)."""
        payloads, _valid, torn = _read_frames(self.snap_path)
        if torn or not payloads:
            if torn:
                log.warning("snapshot_corrupt_ignored", path=self.snap_path)
            return None
        try:
            return pickle.loads(payloads[0])
        except (pickle.UnpicklingError, EOFError, ValueError,
                AttributeError) as exc:
            log.warning("snapshot_unreadable", error=str(exc))
            return None

    def close(self) -> None:
        self._wal_f.close()
