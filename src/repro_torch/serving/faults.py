"""Fault injection + supervised serving: the recovery layer's adversary.
PyTorch port of ``repro/serving/faults.py``.

serving/recovery.py promises bit-exact crash recovery; this module is the
machinery that tries to break the promise.  Three kinds of pieces:

**Injectors** -- functions that damage durable state the way real
infrastructure does: flip bytes inside a checkpointed array (silent disk
corruption; the manifest CRC must catch it), drop a WAL record (a lost
write; replay must refuse, not silently skip mass), duplicate a WAL
record (a retried append that survived; replay must apply it once).

**FaultPlan** -- a declarative schedule of injected failures for one
supervised run: kill the process after N operations, corrupt the newest
snapshot before recovery, drop/duplicate a log record, or stall to
trigger straggler detection.

**ServingSupervisor** -- the retry/backoff wrapper that drives a durable
engine through an operation stream, catches injected (or real) crashes,
recovers from disk, and RESUMES from the exact operation the recovered
log position points at -- the WAL sequence number doubles as the cursor
into the operation stream, so nothing is skipped and nothing is applied
twice.  tests/test_torch_recovery.py runs the kill/corrupt matrix through
it and asserts bitwise equality against an uninterrupted run.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving import recovery as rec
from repro_torch.training import checkpoint as ckpt

# An operation stream entry: ("block", items, freqs) or ("advance",).
Op = Tuple


class InjectedCrash(RuntimeError):
    """The fault plan killed the serving process here."""


# --------------------------------------------------------------------------
# injectors
# --------------------------------------------------------------------------

def corrupt_checkpoint_array(directory: str, step: Optional[int] = None,
                             which: int = 0) -> str:
    """Byte-flip one stored array inside a snapshot, leaving the manifest.

    Rewrites the npz archive with a single element of array ``which``
    perturbed, exactly what a silent disk corruption looks like: the
    archive still loads, the manifest still parses, only the CRC check
    can tell.  Returns the key of the damaged array.
    """
    snap_dir = os.path.join(directory, "snapshots")
    steps = ckpt.list_steps(snap_dir)
    if step is None:
        step = max(steps)
    path = os.path.join(snap_dir, f"step_{step:08d}", "proc00_shard000.npz")
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    keys = sorted(arrays)
    key = keys[which % len(keys)]
    arr = arrays[key]
    flat = arr.reshape(-1).copy()
    if flat.size == 0:
        raise ValueError(f"array {key} is empty; pick another index")
    raw = flat.view(np.uint8)
    raw[0] ^= 0xFF
    arrays[key] = flat.reshape(arr.shape)
    np.savez(path, **arrays)
    return key


def drop_wal_record(directory: str, seq: int) -> None:
    """Remove one record from the log (a lost write; replay must raise)."""
    _rewrite_wal(directory, lambda r: None if r.seq == seq else r)


def duplicate_wal_record(directory: str, seq: int) -> None:
    """Append a stale copy of record ``seq`` at the tail (a survived retry;
    replay must apply it exactly once)."""
    log = rec.BlockLog(directory, fsync=False)
    target = [r for r in log.records(0) if r.seq == seq]
    if not target:
        log.close()
        raise ValueError(f"no record with seq {seq} in the log")
    r = target[0]
    payload = rec._encode_payload(r.kind, r.items, r.freqs)
    import zlib
    log._fh.write(rec._HEADER.pack(rec._MAGIC, len(payload), r.seq,
                                   zlib.crc32(payload) & 0xFFFFFFFF))
    log._fh.write(payload)
    log._fh.flush()
    log.close()


def _rewrite_wal(directory: str,
                 fn: Callable[[rec.WALRecord], Optional[rec.WALRecord]],
                 ) -> None:
    """Rewrite every segment through ``fn`` (None drops the record)."""
    import zlib
    log = rec.BlockLog(directory, fsync=False)
    segs = log._segments()
    per_seg = {name: log._scan_segment(name)[0] for name in segs}
    log.close()
    for name, recs in per_seg.items():
        path = os.path.join(directory, "wal", name)
        with open(path, "wb") as f:
            for r in recs:
                r2 = fn(r)
                if r2 is None:
                    continue
                payload = rec._encode_payload(r2.kind, r2.items, r2.freqs)
                f.write(rec._HEADER.pack(rec._MAGIC, len(payload), r2.seq,
                                         zlib.crc32(payload) & 0xFFFFFFFF))
                f.write(payload)


# --------------------------------------------------------------------------
# fault plan + supervisor
# --------------------------------------------------------------------------

@dataclasses.dataclass
class FaultPlan:
    """One run's injected failures (all optional, combinable).

    ``crash_after_ops``: raise :class:`InjectedCrash` once that many
    operations have been applied in the current life (counted per life, so
    a plan can kill the same run repeatedly until ``max_crashes``).
    ``corrupt_newest_snapshot``: before each recovery, byte-flip an array
    in the newest snapshot so recovery must CRC-fail it and fall back.
    ``straggle_op`` / ``straggle_seconds``: sleep before that operation,
    feeding the straggler monitor an outlier step time.
    """
    crash_after_ops: Optional[int] = None
    max_crashes: int = 1
    corrupt_newest_snapshot: bool = False
    straggle_op: Optional[int] = None
    straggle_seconds: float = 0.0
    crashes: int = dataclasses.field(default=0, init=False)

    def should_crash(self, ops_this_life: int) -> bool:
        if self.crash_after_ops is None or self.crashes >= self.max_crashes:
            return False
        return ops_this_life >= self.crash_after_ops


@dataclasses.dataclass
class SupervisedRunReport:
    """What happened across one supervised run: crashes, recoveries, timing."""
    crashes: int
    recoveries: List[rec.RecoveryReport]
    op_times: List[float]               # per-op wall time (straggler feed)


class ServingSupervisor:
    """Retry/backoff wrapper: feed an op stream, survive injected crashes.

    The operation stream maps 1:1 onto WAL sequence numbers (each block or
    advance appends exactly one record), so after a recovery the log's
    ``next_seq`` IS the index of the next operation to apply -- the
    supervisor resumes there, replaying nothing at the stream level
    (recovery already replayed the logged records) and skipping nothing.
    """

    def __init__(self, directory: str, backend_factory: Callable[[], object],
                 *, max_restarts: int = 3, backoff: float = 0.0,
                 engine_kwargs: Optional[Dict] = None,
                 snapshot_every: Optional[int] = None,
                 fsync: bool = True):
        self.directory = directory
        self.backend_factory = backend_factory
        self.max_restarts = int(max_restarts)
        self.backoff = float(backoff)
        self.engine_kwargs = engine_kwargs or {}
        self.snapshot_every = snapshot_every
        self.fsync = fsync

    def _build(self) -> Tuple[rec.DurableSketchEngine, rec.RecoveryReport]:
        return rec.recover(
            self.directory, self.backend_factory,
            engine_kwargs=self.engine_kwargs,
            snapshot_every=self.snapshot_every, fsync=self.fsync)

    def run(self, ops: Sequence[Op], fault: Optional[FaultPlan] = None,
            ) -> Tuple[rec.DurableSketchEngine, SupervisedRunReport]:
        """Apply every operation, recovering through any crash.

        Returns the live durable engine (caller queries it) and the run
        report.  Raises once ``max_restarts`` is exceeded -- a fleet that
        cannot stop crashing needs a human, not another retry.
        """
        fault = fault or FaultPlan()
        restarts = 0
        recoveries: List[rec.RecoveryReport] = []
        op_times: List[float] = []
        engine, report = self._build()
        recoveries.append(report)
        while True:
            ops_this_life = 0
            try:
                while engine.log.next_seq < len(ops):
                    i = engine.log.next_seq
                    if fault.should_crash(ops_this_life):
                        fault.crashes += 1
                        # simulate a hard kill: no drain, no snapshot --
                        # whatever is on disk is all recovery gets
                        raise InjectedCrash(f"killed before op {i}")
                    if fault.straggle_op == i and fault.straggle_seconds:
                        time.sleep(fault.straggle_seconds)
                    t0 = time.perf_counter()
                    op = ops[i]
                    if op[0] == "block":
                        engine.ingest(op[1], op[2])
                    elif op[0] == "advance":
                        engine.advance()
                    else:
                        raise ValueError(f"unknown op kind {op[0]!r}")
                    op_times.append(time.perf_counter() - t0)
                    ops_this_life += 1
                break
            except InjectedCrash:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                if self.backoff > 0:
                    time.sleep(self.backoff * 2 ** (restarts - 1))
                # the crashed engine may still have a snapshot in flight on
                # its async writer; let it settle (success or failure) so it
                # cannot race the rebuilt engine's recovery and writer in
                # the same snapshots directory
                try:
                    engine.writer.wait()
                except Exception:
                    pass
                engine.log.close()
                if fault.corrupt_newest_snapshot and ckpt.list_steps(
                        os.path.join(self.directory, "snapshots")):
                    corrupt_checkpoint_array(self.directory)
                engine, report = self._build()
                recoveries.append(report)
        return engine, SupervisedRunReport(
            crashes=restarts, recoveries=recoveries, op_times=op_times)
