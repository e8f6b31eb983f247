"""Durable snapshots + write-ahead block log: crash recovery for serving.
PyTorch port of ``repro/serving/recovery.py``, on the same on-disk formats:
a directory either package wrote recovers in the other bit for bit.

The serving surfaces hold their whole world in device tables, host-side
candidate pools, and a handful of counters -- state that dies with the
process.  This layer makes any of them durable with two complementary
pieces, exploiting the linearity structure the paper's composite sketches
already have:

**Snapshots** (:meth:`DurableSketchEngine.snapshot`): the backend's
``state_dict()`` -- every level table, hash params, space-saving pools,
totals, window clocks -- plus the engine's staleness watermark, written
atomically through :class:`repro_torch.training.checkpoint.AsyncCheckpointer`
with a versioned manifest and a CRC32 per array.  Restore is bit-identical
to the snapshotted state; a corrupted array fails its CRC and
:func:`recover` falls back to the previous snapshot instead of serving
garbage.

**Write-ahead block log** (:class:`BlockLog`): every ingested block (and
every window ``advance``) is appended -- raw and unpadded -- *before* it
touches the engine, as a CRC-framed record in an append-only segment file.
Recovery = restore the newest intact snapshot, then replay the log in
order from the snapshot's sequence number.  Per-mode contract:

  =============  =====================================================
  linear/signed  replay is a fold; tables are linear in the stream, so
                 snapshot + replayed blocks == uninterrupted run, bitwise
  conservative   the fold is order-dependent (Estan-Varghese reads the
                 table it writes), but the log preserves ingest order
                 exactly, so ordered replay is STILL bit-exact
  =============  =====================================================

Either way the loss bound is explicit: a crash loses at most the blocks
whose ``ingest`` call had not yet returned (the WAL append happens first;
with ``fsync=True`` a returned ingest is on disk).  Everything already
appended replays; duplicates (a retried append that survived the crash)
are skipped by sequence number; a genuinely missing record raises
:class:`WALGapError` rather than silently serving a stream with a hole.

Segment hygiene rides the snapshot cadence: ``snapshot()`` rotates the log
so each segment covers one inter-snapshot window, and segments wholly
covered by the newest durable snapshot are pruned.  Torn tails (a crash
mid-append) are truncated when the log reopens -- only ever the last
record of the last segment, which by the ordering above was never applied
anywhere that matters.

serving/faults.py is the fault-injection harness that holds all of this
to bit-for-bit recovery.
"""
from __future__ import annotations

import dataclasses
import io
import os
import struct
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.training import checkpoint as ckpt

_MAGIC = 0x574C3031  # "WL01"
_HEADER = struct.Struct("<IIQI")  # magic, payload_len, seq, crc32(payload)


class WALGapError(RuntimeError):
    """The log is missing a sequence number: replay would skip stream mass."""


def _encode_payload(kind: str, items: Optional[np.ndarray],
                    freqs: Optional[np.ndarray]) -> bytes:
    buf = io.BytesIO()
    if kind == "block":
        np.savez(buf, kind=np.frombuffer(b"block", dtype=np.uint8),
                 items=np.asarray(items, dtype=np.uint32),
                 freqs=np.asarray(freqs))
    else:
        np.savez(buf, kind=np.frombuffer(b"advance", dtype=np.uint8))
    return buf.getvalue()


def _decode_payload(payload: bytes):
    with np.load(io.BytesIO(payload)) as z:
        kind = bytes(z["kind"]).decode()
        if kind == "block":
            return kind, z["items"], z["freqs"]
        return kind, None, None


@dataclasses.dataclass(frozen=True)
class WALRecord:
    seq: int
    kind: str                      # 'block' | 'advance'
    items: Optional[np.ndarray]
    freqs: Optional[np.ndarray]


class BlockLog:
    """Append-only segmented write-ahead log of raw ingest operations.

    Segments are ``wal/seg_{first_seq:012d}.log``; each record is a fixed
    header (magic, payload length, sequence number, payload CRC32)
    followed by an npz payload holding the raw unpadded block (dtype
    preserved -- int64 counts and f32 gradient weights both round-trip
    bitwise).  Opening the log scans existing segments, truncates a torn
    tail on the LAST segment (a crash mid-append), and continues the
    sequence numbering where it left off.
    """

    def __init__(self, directory: str, *, fsync: bool = True):
        self.directory = os.path.join(directory, "wal")
        self.fsync = bool(fsync)
        os.makedirs(self.directory, exist_ok=True)
        self._fh = None
        self.next_seq = 0
        segs = self._segments()
        if segs:
            # Resume at max(seq)+1 over EVERY segment, not the last record
            # on disk: a duplicate append that survived a retry sits at the
            # tail with a stale lower seq, and rotation can leave the last
            # segment empty -- either would regress the cursor and make new
            # appends reuse live sequence numbers.
            max_seq = -1
            for i, name in enumerate(segs):
                recs, _ = self._scan_segment(
                    name, truncate_torn=(i == len(segs) - 1))
                if recs:
                    max_seq = max(max_seq, max(r.seq for r in recs))
            if max_seq >= 0:
                self.next_seq = max_seq + 1
            else:
                self.next_seq = int(segs[-1].split("_")[1].split(".")[0])
        self._open_tail()

    # -- segment bookkeeping -------------------------------------------------

    def _segments(self) -> List[str]:
        return sorted(f for f in os.listdir(self.directory)
                      if f.startswith("seg_") and f.endswith(".log"))

    def _seg_path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def _open_tail(self) -> None:
        segs = self._segments()
        if segs:
            path = self._seg_path(segs[-1])
        else:
            path = self._seg_path(f"seg_{self.next_seq:012d}.log")
        self._fh = open(path, "ab")

    def rotate(self) -> None:
        """Start a fresh segment at the current sequence number.

        Called at snapshot time so each segment covers one inter-snapshot
        window -- then :meth:`prune` can drop whole files instead of
        rewriting them."""
        self._fh.close()
        path = self._seg_path(f"seg_{self.next_seq:012d}.log")
        self._fh = open(path, "ab")

    def prune(self, watermark: int) -> None:
        """Delete segments wholly covered by a durable snapshot.

        ``watermark`` is the snapshot's sequence count: every record with
        ``seq < watermark`` is reconstructible from the snapshot alone.  A
        segment is prunable when the NEXT segment starts at or below the
        watermark (so nothing >= watermark can live in it)."""
        segs = self._segments()
        for name, nxt in zip(segs, segs[1:]):
            nxt_first = int(nxt.split("_")[1].split(".")[0])
            if nxt_first <= watermark:
                os.remove(self._seg_path(name))

    # -- append --------------------------------------------------------------

    def _append(self, payload: bytes) -> int:
        seq = self.next_seq
        self._fh.write(_HEADER.pack(_MAGIC, len(payload), seq,
                                    zlib.crc32(payload) & 0xFFFFFFFF))
        self._fh.write(payload)
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
        self.next_seq = seq + 1
        return seq

    def append_block(self, items: np.ndarray, freqs: np.ndarray) -> int:
        """Log one raw ingest block; returns its sequence number."""
        return self._append(_encode_payload("block", items, freqs))

    def append_advance(self) -> int:
        """Log a window epoch advance (moves no mass, but changes tables)."""
        return self._append(_encode_payload("advance", None, None))

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -- scan / replay -------------------------------------------------------

    def _scan_segment(self, name: str, *, truncate_torn: bool = False,
                      ) -> Tuple[List[WALRecord], Optional[int]]:
        """Parse one segment; optionally truncate a torn tail in place.

        A record is torn when the file ends mid-header/mid-payload, the
        magic is wrong, or the payload fails its CRC -- all the signatures
        of a crash mid-append.  Only trailing corruption is repairable;
        everything after the first bad frame is unparseable (frame lengths
        chain), so the scan stops there and reports the offset.
        """
        path = self._seg_path(name)
        recs: List[WALRecord] = []
        torn_at: Optional[int] = None
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        while off < len(data):
            if off + _HEADER.size > len(data):
                torn_at = off
                break
            magic, plen, seq, crc = _HEADER.unpack_from(data, off)
            end = off + _HEADER.size + plen
            if magic != _MAGIC or end > len(data):
                torn_at = off
                break
            payload = data[off + _HEADER.size:end]
            if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                torn_at = off
                break
            kind, items, freqs = _decode_payload(payload)
            recs.append(WALRecord(seq=seq, kind=kind, items=items,
                                  freqs=freqs))
            off = end
        if torn_at is not None and truncate_torn:
            with open(path, "ab") as f:
                f.truncate(torn_at)
        return recs, torn_at

    def records(self, from_seq: int = 0) -> List[WALRecord]:
        """All intact records with ``seq >= from_seq``, in order.

        Duplicates (a record re-appended by a retried writer) are dropped
        by sequence number; a missing sequence number raises
        :class:`WALGapError` -- replaying across a hole would silently
        reconstruct a different stream, the one thing a recovery layer
        must never do.  Torn tails on the last segment were truncated at
        open; torn data in an EARLIER segment is a real gap and raises.
        """
        out: List[WALRecord] = []
        seen = -1
        segs = self._segments()
        for i, name in enumerate(segs):
            recs, torn_at = self._scan_segment(name)
            if torn_at is not None and i != len(segs) - 1:
                raise WALGapError(
                    f"segment {name} is corrupt mid-file at byte {torn_at}: "
                    "records after it are unrecoverable")
            for r in recs:
                if r.seq <= seen:
                    continue               # duplicate append, skip
                if seen >= 0 and r.seq != seen + 1:
                    raise WALGapError(
                        f"log jumps from seq {seen} to {r.seq}: "
                        f"{r.seq - seen - 1} record(s) missing")
                seen = r.seq
                if r.seq >= from_seq:
                    out.append(r)
        if out and out[0].seq != from_seq:
            raise WALGapError(
                f"replay must start at seq {from_seq} but the log's first "
                f"surviving record is seq {out[0].seq}")
        return out


# --------------------------------------------------------------------------
# durable engine + recovery
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RecoveryReport:
    """What :func:`recover` did: which snapshot, what it skipped, what replayed."""
    restored_step: Optional[int]        # None = no usable snapshot, fresh start
    corrupted_steps: List[int]          # snapshots that failed CRC, newest first
    replayed_blocks: int
    replayed_advances: int
    next_seq: int                       # the log position serving resumes at


class DurableSketchEngine:
    """A :class:`~repro_torch.serving.sketch_engine.SketchServeEngine` with a WAL.

    Wraps an engine (over ANY backend with a ``state_dict`` surface --
    endpoint, sharded, windowed) so that every ingest and advance is
    logged before it is applied, and a snapshot of the full backend +
    watermark state is taken every ``snapshot_every`` operations (or on
    explicit :meth:`snapshot`).  Queries pass straight through.

    Write ordering is the whole durability story: WAL append (fsync'd by
    default) -> engine apply.  A crash at any point between loses nothing
    that ``ingest`` ever returned from; :func:`recover` rebuilds the exact
    pre-crash state from snapshot + replay.
    """

    def __init__(self, engine, directory: str, *,
                 snapshot_every: Optional[int] = None,
                 fsync: bool = True, keep_snapshots: int = 3,
                 _log: Optional[BlockLog] = None):
        self.engine = engine
        self.directory = directory
        self.snapshot_every = snapshot_every
        self.log = _log if _log is not None else BlockLog(directory,
                                                          fsync=fsync)
        self.writer = ckpt.AsyncCheckpointer(
            os.path.join(directory, "snapshots"), keep_last=keep_snapshots)
        self._ops_since_snapshot = 0

    @property
    def backend(self):
        return self.engine.backend

    # -- durable ingest path -------------------------------------------------

    def ingest(self, items: np.ndarray,
               freqs: Optional[np.ndarray] = None) -> None:
        """WAL-append the raw block, then apply it to the engine.

        Empty blocks are logged too: every operation must map 1:1 onto a
        WAL sequence number (the supervisor uses ``next_seq`` as its stream
        cursor), so even a no-op block advances the log.  The wrapped
        engine skips the empty apply itself.
        """
        items = np.asarray(items, dtype=np.uint32)
        if freqs is None:
            freqs = np.ones(items.shape[0], dtype=np.int64)
        freqs = np.asarray(freqs)
        self.log.append_block(items, freqs)
        self.engine.ingest(items, freqs)
        self._maybe_snapshot()

    def advance(self) -> None:
        """WAL-append an epoch advance, then apply it (windowed backends)."""
        self.log.append_advance()
        self.engine.advance()
        self._maybe_snapshot()

    def _maybe_snapshot(self) -> None:
        self._ops_since_snapshot += 1
        if (self.snapshot_every
                and self._ops_since_snapshot >= self.snapshot_every):
            self.snapshot()

    def snapshot(self, wait: bool = True) -> int:
        """Write a durable snapshot; returns its step (= WAL watermark).

        The step number IS the log position: a snapshot at step ``s``
        contains exactly the effect of records ``0..s-1``, so recovery
        replays from ``s``.  The log rotates here (new segment starts at
        ``s``) and, once the write is durable, segments below the OLDEST
        retained snapshot are pruned -- not below ``s``: an on-disk
        corruption of the newest snapshot must leave enough log to replay
        from any older retained one.  ``wait=False`` leaves the write in
        flight on the async writer -- pruning then waits for the NEXT
        snapshot/wait.
        """
        self.engine.drain()
        watermark = self.log.next_seq
        trees = {
            "backend": self.engine.backend.state_dict(),
            "engine": {"mass": np.asarray(self.engine.ingested_mass,
                                          dtype=np.int64)},
        }
        self.log.rotate()
        self.writer.submit(watermark, trees)
        if wait:
            self.writer.wait()
            retained = ckpt.list_steps(os.path.join(self.directory,
                                                    "snapshots"))
            # prune only what is covered REDUNDANTLY: with a single
            # snapshot on disk, a corruption of that one snapshot must
            # still leave the full log for a fresh-start replay
            if len(retained) >= 2:
                self.log.prune(min(retained))
        self._ops_since_snapshot = 0
        return watermark

    def close(self) -> None:
        self.writer.wait()
        self.log.close()

    # -- query passthrough ---------------------------------------------------

    def sync(self):
        return self.engine.sync()

    def drain(self) -> None:
        self.engine.drain()

    def topk(self, k: int, min_threshold: Optional[int] = None):
        return self.engine.topk(k, min_threshold)

    def heavy_hitters(self, threshold: int):
        return self.engine.heavy_hitters(threshold)

    def submit(self, request):
        return self.engine.submit(request)

    def submit_topk(self, k: int, min_threshold: Optional[int] = None):
        return self.engine.submit_topk(k, min_threshold)

    def submit_heavy_hitters(self, threshold: int):
        return self.engine.submit_heavy_hitters(threshold)

    def flush(self):
        return self.engine.flush()


def recover(
    directory: str,
    backend_factory: Callable[[], object],
    *,
    engine_kwargs: Optional[Dict] = None,
    snapshot_every: Optional[int] = None,
    fsync: bool = True,
    keep_snapshots: int = 3,
) -> Tuple[DurableSketchEngine, RecoveryReport]:
    """Rebuild a durable engine from disk: newest intact snapshot + replay.

    ``backend_factory`` must build a backend CONFIGURED like the one that
    crashed (same spec, key, mode, capacities -- the state_dict
    fingerprint enforces this); its state is then overwritten from the
    snapshot.  Snapshots are tried newest-first: one that fails its CRC
    (:class:`~repro_torch.training.checkpoint.CheckpointCorruptionError`) is
    recorded and skipped, falling back to the previous one -- the WAL
    still holds every record since the OLDER snapshot (pruning never goes
    below the oldest retained snapshot), so the deeper replay reconverges
    on the same bit-exact state.

    With no usable snapshot at all, recovery starts from the factory's
    fresh backend and replays the log from seq 0.
    """
    snap_dir = os.path.join(directory, "snapshots")
    corrupted: List[int] = []
    restored_step: Optional[int] = None
    trees: Optional[Dict] = None
    for step in reversed(ckpt.list_steps(snap_dir)):
        try:
            _, trees = ckpt.restore_trees(snap_dir, step=step)
            restored_step = step
            break
        except ckpt.CheckpointCorruptionError:
            corrupted.append(step)

    backend = backend_factory()
    from repro_torch.serving.sketch_engine import SketchServeEngine

    if trees is not None:
        backend.load_state_dict(trees["backend"])
    engine = SketchServeEngine(backend, **(engine_kwargs or {}))
    if trees is not None:
        engine.restore_watermark(int(trees["engine"]["mass"]))

    log = BlockLog(directory, fsync=fsync)
    from_seq = restored_step if restored_step is not None else 0
    blocks = advances = 0
    for rec in log.records(from_seq):
        if rec.kind == "block":
            engine.ingest(rec.items, rec.freqs)
            blocks += 1
        else:
            engine.advance()
            advances += 1
    engine.drain()

    durable = DurableSketchEngine(
        engine, directory, snapshot_every=snapshot_every, fsync=fsync,
        keep_snapshots=keep_snapshots, _log=log)
    report = RecoveryReport(
        restored_step=restored_step, corrupted_steps=corrupted,
        replayed_blocks=blocks, replayed_advances=advances,
        next_seq=log.next_seq)
    return durable, report
