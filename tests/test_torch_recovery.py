"""Port parity: checkpoints, the write-ahead block log and crash recovery.

The port's ``training/checkpoint.py``, ``serving/recovery.py`` and
``serving/faults.py`` on the reference's on-disk formats:

  * state round trips of the endpoint (linear, conservative, update
    kernel), the windowed service, the sharded service and ``KernelSketch``
    (all modes): restored objects equal the snapshotted ones bit for bit
    and keep equal under further ingest;
  * checkpoints: a CRC32 byte flip is caught, the async writer surfaces
    worker errors and retries I/O errors, bfloat16 leaves the reference
    wrote come back bit for bit;
  * the WAL: reopen, torn tail, duplicate and gap, empty blocks, rotate
    and prune;
  * kill and recover through ``ServingSupervisor`` for the endpoint, the
    windowed service mid-window and the sharded service: tables, pools,
    totals and ``topk`` equal an uninterrupted run and the reference's,
    corrupted-snapshot fallback and ``max_restarts`` included;
  * cross-package recovery: a durable directory the reference wrote
    recovers in the port bit for bit, and one the port wrote in the
    reference.

Int32 tables throughout: tolerance 0.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hierarchy as rhh
from repro.core import sketch as rsk
from repro.kernels import ops as rops
from repro.serving import faults as rfaults
from repro.serving import recovery as rrec
from repro.serving import sketch_engine as rse
from repro.serving.sharded_topk import ShardedTopKService as RefSharded
from repro.serving.windowed_topk import WindowedTopKService as RefWindowed
from repro.streams import zipf_hh_workload as r_zipf_hh_workload
from repro.training import checkpoint as rckpt
from repro_torch.core import sketch as psk
from repro_torch.core.hashing import KeySchema
from repro_torch.kernels.ops import KernelSketch
from repro_torch.launch.mesh import Mesh
from repro_torch.serving.faults import (
    FaultPlan,
    InjectedCrash,
    ServingSupervisor,
    corrupt_checkpoint_array,
    drop_wal_record,
    duplicate_wal_record,
)
from repro_torch.serving.recovery import BlockLog, DurableSketchEngine, WALGapError, recover
from repro_torch.serving.sharded_topk import ShardedTopKService
from repro_torch.serving.sketch_engine import SketchServeEngine, SketchTopKEndpoint
from repro_torch.serving.windowed_topk import WindowedTopKService
from repro_torch.streams import zipf_hh_workload
from repro_torch.training import checkpoint as ckpt

KEY = jax.random.PRNGKey(0)
MESH1 = jax.make_mesh((1,), ("data",))


@functools.lru_cache(maxsize=1)
def _stream():
    kw = dict(n_src=100, n_tgt=200, n_edges=800, n_occurrences=4_000, seed=1)
    wl, rwl = zipf_hh_workload(**kw), r_zipf_hh_workload(**kw)
    np.testing.assert_array_equal(wl.stream.items, rwl.stream.items)
    return wl.stream


def _specs(ranges=(32, 32), w=4):
    stream = _stream()
    return (rsk.mod_sketch_spec(stream.schema, [(0,), (1,)], ranges, w),
            psk.mod_sketch_spec(KeySchema(stream.schema.domains), [(0,), (1,)], ranges, w))


@functools.lru_cache(maxsize=None)
def _params(ranges=(32, 32), w=4):
    rspec, _ = _specs(ranges, w)
    p = rhh.init_hierarchy(rhh.HierarchySpec.from_spec(rspec), KEY).states[-1].params
    return np.asarray(p.q), np.asarray(p.r)


def _blocks(size=50):
    it, fr = _stream().items, _stream().freqs
    return [(it[s:s + size], fr[s:s + size]) for s in range(0, it.shape[0], size)]


def _endpoint(**kw):
    return SketchTopKEndpoint(_specs()[1], _params(), device="cpu", **kw)


def _windowed():
    return WindowedTopKService(_specs()[1], _params(), n_epochs=3, device="cpu")


def _cpu_mesh(n):
    return Mesh((n,), ("data",), ["cpu"] * n)


def _sharded(n=4):
    return ShardedTopKService(_specs()[1], _params(), _cpu_mesh(n), sync_every=2)


def _table(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_same_backend(a, b):
    """Totals, tables and candidates (order included: descent order) equal;
    either side may be the reference's."""
    assert int(a.total) == int(b.total)
    sa = a.state() if callable(a.state) else a.state
    sb = b.state() if callable(b.state) else b.state
    for x, y in zip(sa.states, sb.states):
        np.testing.assert_array_equal(_table(x.table), _table(y.table))
    for pa, pb in zip(a.candidates(), b.candidates()):
        np.testing.assert_array_equal(pa, pb)


def _assert_same_topk(a, b, k=10):
    (ia, ea), (ib, eb) = a.topk(k), b.topk(k)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(ea, eb)


# --------------------------------------------------------------------------
# state_dict round trips
# --------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda: _endpoint(), lambda: _endpoint(mode="conservative"),
    lambda: _endpoint(use_update_kernel=True), _windowed, _sharded],
    ids=["linear", "conservative", "kernel", "windowed", "sharded"])
def test_state_roundtrip_bitwise(make):
    a, b = make(), make()
    blocks = _blocks()
    for n, (it, fr) in enumerate(blocks[:6]):
        a.ingest(it, fr)
        if isinstance(a, WindowedTopKService) and n % 2 == 1:
            a.advance()
    b.load_state_dict(a.state_dict())
    _assert_same_backend(a, b)
    for it, fr in blocks[6:]:
        a.ingest(it, fr)
        b.ingest(it, fr)
    if isinstance(a, WindowedTopKService):
        a.advance()
        b.advance()
    _assert_same_backend(a, b)
    _assert_same_topk(a, b, 8)


@pytest.mark.parametrize("mode", ["linear", "conservative", "signed"])
def test_kernel_sketch_state_roundtrip_all_modes(mode):
    rspec, pspec = _specs()
    sd = rops.KernelSketch(rspec, KEY, mode=mode).state_dict()
    params = tuple(sd[k] for k in ("params.q", "params.r", "params.sign_q", "params.sign_r")
                   if k in sd)
    a = KernelSketch(pspec, params, mode=mode, block_b=64, device="cpu")
    b = KernelSketch(pspec, params, mode=mode, block_b=64, device="cpu")
    blocks = _blocks()
    for it, fr in blocks[:4]:
        a.update(it, fr)
    b.load_state_dict(a.state_dict())
    for it, fr in blocks[4:]:
        a.update(it, fr)
        b.update(it, fr)
    assert torch.equal(a.table, b.table)
    np.testing.assert_array_equal(a.query(_stream().items[:64]), b.query(_stream().items[:64]))
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        KernelSketch(pspec, params[:2], mode="linear" if mode != "linear" else "conservative",
                     device="cpu").load_state_dict(a.state_dict())


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def test_checkpoint_crc_catches_byte_flip(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"t": {"x": np.arange(32, dtype=np.int64)}})
    step, trees = ckpt.restore_trees(d)
    assert step == 1 and np.array_equal(trees["t"]["x"], np.arange(32))
    path = os.path.join(d, "step_00000001", "proc00_shard000.npz")
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["t::x"] = arrays["t::x"] + 1
    np.savez(path, **arrays)
    with pytest.raises(ckpt.CheckpointCorruptionError, match="CRC mismatch"):
        ckpt.restore_trees(d)
    _, trees = ckpt.restore_trees(d, verify=False)
    assert trees["t"]["x"][0] == 1
    # the reference reads the port's checkpoint and raises the same way
    with pytest.raises(rckpt.CheckpointCorruptionError, match="CRC mismatch"):
        rckpt.restore_trees(d)


def test_async_checkpointer_error_and_retry_paths(tmp_path, monkeypatch):
    real_save = ckpt.save

    def boom(*a, **k):
        raise OSError("disk on fire")

    monkeypatch.setattr(ckpt, "save", boom)
    w = ckpt.AsyncCheckpointer(str(tmp_path / "ck"), retries=0)
    w.submit(1, {"t": {"x": np.zeros(4)}})
    with pytest.raises(OSError, match="disk on fire"):
        w.wait()
    w.submit(2, {"t": {"x": np.zeros(4)}})
    with pytest.raises(OSError, match="disk on fire"):
        w.submit(3, {"t": {"x": np.zeros(4)}})

    attempts = []

    def flaky(*a, **k):
        attempts.append(1)
        if len(attempts) == 1:
            raise OSError("transient")
        return real_save(*a, **k)

    monkeypatch.setattr(ckpt, "save", flaky)
    w = ckpt.AsyncCheckpointer(str(tmp_path / "ck2"), retries=2, backoff=0.001)
    live = torch.arange(4)
    w.submit(1, {"t": {"x": live}})
    live += 100                            # the host copy was taken at submit
    w.wait()
    assert len(attempts) == 2
    step, trees = ckpt.restore_trees(str(tmp_path / "ck2"))
    assert step == 1 and np.array_equal(trees["t"]["x"], np.arange(4))

    def typeerror(*a, **k):
        attempts.append(1)
        raise TypeError("not transient")

    monkeypatch.setattr(ckpt, "save", typeerror)
    attempts.clear()
    w = ckpt.AsyncCheckpointer(str(tmp_path / "ck3"), retries=3, backoff=0.001)
    w.submit(1, {"t": {"x": np.zeros(2)}})
    with pytest.raises(TypeError):
        w.wait()
    assert len(attempts) == 1


def test_checkpoint_trees_both_ways_and_bfloat16(tmp_path):
    """A reference checkpoint of a dict-of-arrays tree, bfloat16 leaves
    included, is read by the port bit for bit; the port's checkpoint of the
    same tree has the same paths, dtypes and CRCs and reads back in the
    reference."""
    rng = np.random.default_rng(0)
    w32 = rng.standard_normal((8, 16)).astype(np.float32)
    tree = {"params": {"w": jnp.asarray(w32, dtype=jnp.bfloat16),
                       "b": jnp.asarray(w32[0]), "n": jnp.arange(5, dtype=jnp.int32)},
            "layers": [jnp.ones(3), jnp.zeros(2, jnp.int32)]}
    rdir, pdir = str(tmp_path / "ref"), str(tmp_path / "port")
    rckpt.save(rdir, 7, {"state": tree})
    step, flat = ckpt.restore_trees(rdir)
    want_bits = np.asarray(tree["params"]["w"]).view(np.int16)
    assert step == 7 and flat["state"]["params/w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(flat["state"]["params/w"].view(torch.int16).numpy(),
                                  want_bits)
    np.testing.assert_array_equal(flat["state"]["layers/1"], np.zeros(2, np.int32))
    template = {"params": {"w": torch.zeros((8, 16), dtype=torch.bfloat16),
                           "b": torch.zeros(16), "n": np.zeros(5, np.int32)},
                "layers": [torch.zeros(3), torch.zeros(2, dtype=torch.int32)]}
    _, got = ckpt.restore(rdir, {"state": template})
    got = got["state"]
    assert got["params"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["params"]["w"].view(torch.int16).numpy(), want_bits)
    np.testing.assert_array_equal(got["params"]["b"].numpy(), w32[0])
    assert isinstance(got["params"]["n"], np.ndarray) and isinstance(got["layers"], list)
    # the port writes the same tree the same way
    ckpt.save(pdir, 7, {"state": got})
    import json
    man = [json.load(open(os.path.join(d, "step_00000007", "manifest.json")))
           for d in (rdir, pdir)]
    strip = [[{k: e[k] for k in ("path", "shape", "dtype", "crc32")}
              for e in m["trees"]["state"]] for m in man]
    assert strip[0] == strip[1] and man[1]["format_version"] == 2
    _, back = rckpt.restore_trees(pdir)
    np.testing.assert_array_equal(back["state"]["params/w"].view(np.int16), want_bits)
    # version-1 manifests (no CRC) still restore
    mpath = os.path.join(pdir, "step_00000007", "manifest.json")
    m = man[1]
    m.pop("format_version")
    for e in m["trees"]["state"]:
        e.pop("crc32")
    json.dump(m, open(mpath, "w"))
    assert ckpt.restore_trees(pdir)[0] == 7
    assert ckpt.list_steps(pdir) == [7] and ckpt.latest_step(str(tmp_path / "none")) is None


# --------------------------------------------------------------------------
# the WAL
# --------------------------------------------------------------------------

def test_wal_roundtrip_reopen_and_torn_tail(tmp_path):
    d = str(tmp_path)
    log = BlockLog(d)
    items = np.arange(12, dtype=np.uint32).reshape(6, 2)
    freqs = np.array([1, 2, 3, 4, 5, 6], dtype=np.int64)
    log.append_block(items, freqs)
    log.append_advance()
    log.append_block(items[:2], freqs[:2].astype(np.float32))
    log.close()
    log2 = BlockLog(d)
    recs = log2.records(0)
    assert [r.kind for r in recs] == ["block", "advance", "block"]
    np.testing.assert_array_equal(recs[0].items, items)
    np.testing.assert_array_equal(recs[0].freqs, freqs)
    assert recs[2].freqs.dtype == np.float32 and log2.next_seq == 3
    log2.close()
    # the reference reads the port's log record for record
    rrecs = rrec.BlockLog(d, fsync=False).records(0)
    assert [(r.seq, r.kind) for r in rrecs] == [(r.seq, r.kind) for r in recs]
    # a crash mid-append: chop bytes off the last segment's tail
    seg = sorted(os.listdir(os.path.join(d, "wal")))[-1]
    path = os.path.join(d, "wal", seg)
    with open(path, "ab") as f:
        f.truncate(os.path.getsize(path) - 7)
    log3 = BlockLog(d)
    assert [r.seq for r in log3.records(0)] == [0, 1] and log3.next_seq == 2
    log3.append_block(items, freqs)
    assert [r.seq for r in log3.records(0)] == [0, 1, 2]
    log3.close()


def test_wal_duplicate_gap_and_reopen_cursor(tmp_path):
    d = str(tmp_path)
    log = BlockLog(d)
    for i in range(4):
        log.append_block(np.full((2, 2), i, dtype=np.uint32), np.ones(2, dtype=np.int64))
    log.close()
    duplicate_wal_record(d, 1)
    log2 = BlockLog(d)
    assert log2.next_seq == 4
    assert [r.seq for r in log2.records(0)] == [0, 1, 2, 3]   # applied once
    log2.append_block(np.full((2, 2), 9, dtype=np.uint32), np.ones(2, dtype=np.int64))
    assert [r.seq for r in log2.records(0)] == [0, 1, 2, 3, 4]
    log2.close()
    drop_wal_record(d, 2)
    with pytest.raises(WALGapError, match="missing"):
        BlockLog(d).records(0)
    # a log whose first record is lost cannot replay from seq 0
    d2 = str(tmp_path / "head")
    log = BlockLog(d2)
    for i in range(3):
        log.append_block(np.full((2, 2), i, dtype=np.uint32), np.ones(2, dtype=np.int64))
    log.close()
    drop_wal_record(d2, 0)
    with pytest.raises(WALGapError, match="must start at seq 0"):
        BlockLog(d2).records(0)


def test_wal_rotate_and_prune_respects_retained_snapshots(tmp_path):
    eng = DurableSketchEngine(SketchServeEngine(_endpoint()), str(tmp_path),
                              keep_snapshots=2)
    blocks = _blocks()
    wal_dir = os.path.join(str(tmp_path), "wal")
    for it, fr in blocks[:2]:
        eng.ingest(it, fr)
    eng.snapshot()
    assert len(os.listdir(wal_dir)) >= 2
    for it, fr in blocks[2:4]:
        eng.ingest(it, fr)
    eng.snapshot()
    for it, fr in blocks[4:]:
        eng.ingest(it, fr)
    eng.snapshot()
    segs = sorted(os.listdir(wal_dir))
    assert int(segs[0].split("_")[1].split(".")[0]) >= 2
    eng.close()
    eng2, _ = recover(str(tmp_path), _endpoint)
    ref = _endpoint()
    for it, fr in blocks:
        ref.ingest(it, fr)
    _assert_same_backend(ref, eng2.backend)


def test_empty_block_advances_wal_seq_and_supervisor_cursor(tmp_path):
    blocks = _blocks()[:4]
    empty = (blocks[0][0][:0], blocks[0][1][:0])
    ops = [("block", *blocks[0]), ("block", *empty)] + [("block", *b) for b in blocks[1:]]
    ref = _endpoint()
    for _, it, fr in ops:
        ref.ingest(it, fr)
    eng, rep = ServingSupervisor(str(tmp_path), _endpoint, snapshot_every=2).run(
        ops, FaultPlan(crash_after_ops=3, max_crashes=1))
    assert rep.crashes == 1 and eng.log.next_seq == len(ops)
    eng.drain()
    _assert_same_backend(ref, eng.backend)
    eng.close()


# --------------------------------------------------------------------------
# kill and recover
# --------------------------------------------------------------------------

def _ops(advance_every=None):
    ops = []
    for n, (it, fr) in enumerate(_blocks()):
        ops.append(("block", it, fr))
        if advance_every and n % advance_every == advance_every - 1:
            ops.append(("advance",))
    return ops


def _apply(backend, ops):
    for op in ops:
        backend.ingest(op[1], op[2]) if op[0] == "block" else backend.advance()
    return backend


@functools.lru_cache(maxsize=None)
def _reference_run(kind: str):
    """The reference's uninterrupted backend over the same ops."""
    rspec, _ = _specs()
    make = {"linear": lambda: rse.SketchTopKEndpoint(rspec, KEY),
            "conservative": lambda: rse.SketchTopKEndpoint(rspec, KEY, mode="conservative"),
            "kernel": lambda: rse.SketchTopKEndpoint(rspec, KEY),
            "windowed": lambda: RefWindowed(rspec, KEY, n_epochs=3),
            "sharded": lambda: RefSharded(rspec, KEY, MESH1, sync_every=2)}[kind]
    return _apply(make(), _ops(3 if kind == "windowed" else None))


@pytest.mark.parametrize("kind,make,crash,every", [
    ("linear", lambda: _endpoint(), 4, 3),
    ("conservative", lambda: _endpoint(mode="conservative"), 4, 3),
    ("kernel", lambda: _endpoint(use_update_kernel=True), 4, 3),
    ("windowed", _windowed, 5, 4),
    ("sharded", _sharded, 4, 3)])
def test_kill_recover_bitwise(tmp_path, kind, make, crash, every):
    ops = _ops(3 if kind == "windowed" else None)
    ref = _apply(make(), ops)
    sup = ServingSupervisor(str(tmp_path), make, snapshot_every=every)
    eng, rep = sup.run(ops, FaultPlan(crash_after_ops=crash, max_crashes=1))
    assert rep.crashes == 1 and rep.recoveries[-1].restored_step is not None
    assert rep.recoveries[-1].replayed_blocks + rep.recoveries[-1].replayed_advances > 0
    eng.drain()
    _assert_same_backend(ref, eng.backend)
    _assert_same_backend(_reference_run(kind), eng.backend)
    _assert_same_topk(ref, eng)
    _assert_same_topk(_reference_run(kind), eng)
    eng.close()


def test_kill_recover_corrupted_snapshot_falls_back(tmp_path):
    ops = _ops()
    ref = _apply(_endpoint(), ops)
    sup = ServingSupervisor(str(tmp_path), _endpoint, snapshot_every=2)
    eng, rep = sup.run(ops, FaultPlan(crash_after_ops=3, max_crashes=1,
                                      corrupt_newest_snapshot=True))
    last = rep.recoveries[-1]
    assert last.corrupted_steps, "the corrupted snapshot must be detected"
    eng.drain()
    _assert_same_backend(ref, eng.backend)
    _assert_same_topk(ref, eng)
    eng.close()


def test_repeated_crashes_until_max_restarts(tmp_path):
    sup = ServingSupervisor(str(tmp_path), _endpoint, snapshot_every=2, max_restarts=1)
    with pytest.raises(InjectedCrash):
        sup.run(_ops(), FaultPlan(crash_after_ops=1, max_crashes=10))


def test_engine_watermark_and_fresh_start(tmp_path):
    blocks = _blocks()
    eng, rep = recover(str(tmp_path), _endpoint)
    assert rep.restored_step is None and rep.replayed_blocks == 0
    for it, fr in blocks[:3]:
        eng.ingest(it, fr)
    eng.snapshot()
    mass = eng.engine.ingested_mass
    assert mass == sum(int(fr.sum()) for _, fr in blocks[:3])
    eng.close()
    eng2, rep = recover(str(tmp_path), _endpoint)
    assert eng2.engine.ingested_mass == mass and rep.replayed_blocks == 0
    eng2.close()


def test_corrupt_checkpoint_array_is_caught(tmp_path):
    eng = DurableSketchEngine(SketchServeEngine(_endpoint()), str(tmp_path))
    eng.ingest(*_blocks()[0])
    eng.snapshot()
    eng.close()
    key = corrupt_checkpoint_array(str(tmp_path))
    with pytest.raises(ckpt.CheckpointCorruptionError, match=key.split("::")[1]):
        ckpt.restore_trees(os.path.join(str(tmp_path), "snapshots"))


# --------------------------------------------------------------------------
# cross-package recovery
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["linear", "sharded"])
def test_reference_directory_recovers_in_the_port(tmp_path, kind):
    rspec, _ = _specs()
    rmake = ((lambda: rse.SketchTopKEndpoint(rspec, KEY)) if kind == "linear"
             else (lambda: RefSharded(rspec, KEY, MESH1, sync_every=2)))
    pmake = _endpoint if kind == "linear" else _sharded
    ops = _ops()
    half = len(ops) // 2
    reng, _ = rfaults.ServingSupervisor(str(tmp_path), rmake, snapshot_every=3).run(
        ops[:half], rfaults.FaultPlan(crash_after_ops=4, max_crashes=1))
    reng.close()
    # the reference crashed once, recovered and stopped half way; the port
    # recovers its directory and runs the rest
    eng, rep = ServingSupervisor(str(tmp_path), pmake, snapshot_every=3).run(ops)
    assert rep.recoveries[0].restored_step is not None
    eng.drain()
    _assert_same_backend(_reference_run(kind), eng.backend)
    _assert_same_topk(_reference_run(kind), eng)
    eng.close()


@pytest.mark.parametrize("kind", ["linear", "sharded"])
def test_port_directory_recovers_in_the_reference(tmp_path, kind):
    rspec, _ = _specs()
    rmake = ((lambda: rse.SketchTopKEndpoint(rspec, KEY)) if kind == "linear"
             else (lambda: RefSharded(rspec, KEY, MESH1, sync_every=2)))
    pmake = _endpoint if kind == "linear" else _sharded
    ops = _ops()
    half = len(ops) // 2
    eng, _ = ServingSupervisor(str(tmp_path), pmake, snapshot_every=3).run(
        ops[:half], FaultPlan(crash_after_ops=4, max_crashes=1))
    eng.close()
    reng, rep = rrec.recover(str(tmp_path), rmake, snapshot_every=3)
    assert rep.restored_step is not None and rep.next_seq == half
    for op in ops[half:]:
        reng.ingest(op[1], op[2])
    reng.drain()
    _assert_same_backend(_reference_run(kind), reng.backend)
    _assert_same_topk(_reference_run(kind), reng)
    reng.close()
