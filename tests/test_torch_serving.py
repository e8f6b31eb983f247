"""Port parity: the heavy-hitter endpoint and the serving engine.

The port's ``SketchTopKEndpoint`` under all four kernel-flag combinations
(the kernel wrappers take their plain versions on CPU tensors) is held
against the reference endpoint on its plain jnp path, on the same zipf
workload and the reference's own hash draw: ``state_dict``s bitwise equal
(keys, dtypes, values, pool order), ``topk``/``heavy_hitters`` equal.  The
engine is held against the reference engine at staleness 0, a bound and
None, through ``submit``/``flush``.  Int32 tables: exact equality.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.serving import sketch_engine as rse
from repro.streams import zipf_hh_workload as r_zipf_hh_workload
from repro_torch.core import sketch as psk
from repro_torch.core.hashing import KeySchema
from repro_torch.serving import sketch_engine as pse
from repro_torch.serving.protocol import ServeEngineProtocol
from repro_torch.streams import zipf_hh_workload

KEY = jax.random.PRNGKey(7)
CAP = 150                      # small pools: space-saving evicts


@functools.lru_cache(maxsize=1)
def _workload():
    wl = zipf_hh_workload(n_src=300, n_tgt=600, n_edges=3000,
                          n_occurrences=30_000, seed=4)
    rwl = r_zipf_hh_workload(n_src=300, n_tgt=600, n_edges=3000,
                             n_occurrences=30_000, seed=4)
    np.testing.assert_array_equal(wl.stream.items, rwl.stream.items)
    np.testing.assert_array_equal(wl.stream.freqs, rwl.stream.freqs)
    return wl


def _blocks(stream, sizes=(700, 256, 1000, 333)):
    out, s, i = [], 0, 0
    n = stream.items.shape[0]
    while s < n:
        e = min(n, s + sizes[i % len(sizes)])
        out.append((stream.items[s:e], stream.freqs[s:e]))
        s, i = e, i + 1
    return out


def _specs(stream, ranges=(64, 32), w=3):
    from repro.core import sketch as rsk

    return (rsk.mod_sketch_spec(stream.schema, [(0,), (1,)], ranges, w),
            psk.mod_sketch_spec(KeySchema(stream.schema.domains), [(0,), (1,)],
                                ranges, w))


def _pair(use_update_kernel=False, use_kernel=False):
    """A reference endpoint (plain jnp path) and a port endpoint on its
    hash params."""
    wl = _workload()
    rspec, pspec = _specs(wl.stream)
    ref = rse.SketchTopKEndpoint(rspec, KEY, max_candidates_per_group=CAP)
    sd = ref.state_dict()
    port = pse.SketchTopKEndpoint(
        pspec, (sd["params.q"], sd["params.r"]), max_candidates_per_group=CAP,
        use_update_kernel=use_update_kernel, use_kernel=use_kernel, device="cpu")
    return wl, ref, port


def _assert_sd_equal(want: dict, got: dict):
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def _assert_answer_equal(want, got):
    assert got[0].dtype == np.uint32 and got[1].dtype == np.int64
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_array_equal(want[1], got[1])


@pytest.mark.parametrize("use_update_kernel", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_endpoint_matches_reference(use_update_kernel, use_kernel):
    wl, ref, port = _pair(use_update_kernel, use_kernel)
    for items, freqs in _blocks(wl.stream):
        ref.ingest(items, freqs)
        port.ingest(items, freqs)
    port.ingest(wl.stream.items[:0])                  # empty block: no-op
    ref.ingest(wl.stream.items[:50])                  # unit frequencies
    port.ingest(wl.stream.items[:50])
    assert port.total == ref.total
    _assert_sd_equal(ref.state_dict(), port.state_dict())
    for a, b in zip(ref.candidates(), port.candidates()):
        np.testing.assert_array_equal(a, b)
    for thr in (wl.threshold, 3 * wl.threshold):
        _assert_answer_equal(ref.heavy_hitters(thr), port.heavy_hitters(thr))
    for k, floor in ((10, None), (40, None), (5, 1)):
        _assert_answer_equal(ref.topk(k, min_threshold=floor),
                             port.topk(k, min_threshold=floor))


def test_stage_fold_and_merge_match_reference():
    wl, ref, port = _pair()
    blocks = _blocks(wl.stream)
    half = len(blocks) // 2
    for items, freqs in blocks[:half]:
        ref.fold_staged(ref.stage_block(items, freqs))
        port.fold_staged(port.stage_block(items, freqs))
    assert port.stage_block(wl.stream.items[:0]) is None
    _assert_sd_equal(ref.state_dict(), port.state_dict())
    # cross-shard merge: a second pair takes the other half
    _, ref2, port2 = _pair(use_update_kernel=True)
    for items, freqs in blocks[half:]:
        ref2.ingest(items, freqs)
        port2.ingest(items, freqs)
    ref.merge_from(ref2)
    port.merge_from(port2)
    _assert_sd_equal(ref.state_dict(), port.state_dict())
    _assert_answer_equal(ref.topk(20), port.topk(20))
    with pytest.raises(ValueError, match="fused update kernel"):
        port2.stage_block(*blocks[0])
    other = pse.SketchTopKEndpoint(port.hspec.base, torch.Generator().manual_seed(1),
                                   max_candidates_per_group=CAP, device="cpu")
    with pytest.raises(ValueError, match="identical hash params"):
        port.merge_from(other)


@pytest.mark.parametrize("use_update_kernel", [False, True])
def test_state_dict_round_trips_with_reference(use_update_kernel):
    """Reference state_dict -> port -> reference, bit for bit, and the
    port's refusal of a state from another configuration."""
    wl, ref, port = _pair(use_update_kernel=use_update_kernel)
    for items, freqs in _blocks(wl.stream)[:6]:
        ref.ingest(items, freqs)
    rsd = ref.state_dict()
    fresh = pse.SketchTopKEndpoint(port.hspec.base, torch.Generator().manual_seed(2),
                                   max_candidates_per_group=CAP,
                                   use_update_kernel=use_update_kernel, device="cpu")
    fresh.load_state_dict(rsd)
    _assert_sd_equal(rsd, fresh.state_dict())
    _assert_answer_equal(ref.topk(15), fresh.topk(15))
    # the port keeps ingesting; the reference, loaded from the port, agrees
    for items, freqs in _blocks(wl.stream)[6:9]:
        ref.ingest(items, freqs)
        fresh.ingest(items, freqs)
    back = rse.SketchTopKEndpoint(ref.hspec.base, jax.random.PRNGKey(99),
                                  max_candidates_per_group=CAP)
    back.load_state_dict(fresh.state_dict())
    _assert_sd_equal(ref.state_dict(), back.state_dict())
    other_cap = pse.SketchTopKEndpoint(port.hspec.base, torch.Generator(),
                                       max_candidates_per_group=CAP + 1, device="cpu")
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        other_cap.load_state_dict(rsd)


def _engine_pair(max_staleness, use_kernel):
    _, ref, port = _pair(use_update_kernel=use_kernel, use_kernel=use_kernel)
    return (rse.SketchServeEngine(ref, max_staleness=max_staleness),
            pse.SketchServeEngine(port, max_staleness=max_staleness))


@pytest.mark.parametrize("max_staleness", [0, 2_000, None])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_engine_matches_reference_engine(max_staleness, use_kernel):
    wl = _workload()
    reng, peng = _engine_pair(max_staleness, use_kernel)
    blocks = _blocks(wl.stream)
    for i, (items, freqs) in enumerate(blocks):
        reng.ingest(items, freqs)
        peng.ingest(items, freqs)
        assert peng.staleness == reng.staleness
        if i % 5 == 2:                                # queries mid-stream
            _assert_answer_equal(reng.topk(8), peng.topk(8))
            assert peng.staleness == reng.staleness
            _assert_answer_equal(reng.heavy_hitters(wl.threshold),
                                 peng.heavy_hitters(wl.threshold))
    assert peng.ingested_mass == reng.ingested_mass == int(wl.stream.freqs.sum())
    for eng in (reng, peng):
        eng.submit_topk(5)
        eng.submit_topk(30)
        eng.submit_heavy_hitters(wl.threshold)
        eng.submit_topk(4, min_threshold=1)
        eng.submit_topk(3, min_threshold=wl.stream.total * 2)   # floor above total
    rdone, pdone = reng.flush(), peng.flush()
    assert [r.rid for r in pdone] == [r.rid for r in rdone]
    for a, b in zip(rdone, pdone):
        assert b.done
        _assert_answer_equal((a.items, a.est), (b.items, b.est))
    assert peng.flush() == []
    reng.drain()
    peng.drain()
    _assert_sd_equal(reng.backend.state_dict(), peng.backend.state_dict())
    reng.sync()
    peng.sync()
    assert peng.staleness == reng.staleness == 0


def test_engine_snapshot_is_a_copy_and_staleness_contract():
    """An unbounded engine keeps serving its snapshot while ingest folds in
    place into the live tables; sync() refreshes it."""
    wl = _workload()
    _, _, port = _pair(use_update_kernel=True, use_kernel=True)
    eng = pse.SketchServeEngine(port, max_staleness=None)
    blocks = _blocks(wl.stream)
    for items, freqs in blocks[:5]:
        eng.ingest(items, freqs)
    snap = eng.sync()
    at_sync = eng.topk(8)
    frozen = [s.table.clone() for s in snap.state.states]
    for items, freqs in blocks[5:10]:
        eng.ingest(items, freqs)
    assert eng.staleness == sum(int(f.sum()) for _, f in blocks[5:10])
    for s, t in zip(snap.state.states, frozen):
        assert torch.equal(s.table, t)                # not aliased to live tables
    _assert_answer_equal(at_sync, eng.topk(8))
    eng.sync()
    assert eng.staleness == 0
    _assert_answer_equal(port.topk(8), eng.topk(8))
    eng.restore_watermark(123)
    assert eng.ingested_mass == 123 and eng.staleness == 0
    assert isinstance(eng, ServeEngineProtocol)
    with pytest.raises(ValueError, match="kind"):
        eng.submit(pse.SketchQuery(rid=-1, kind="range"))


def test_unported_surfaces_refuse_by_roadmap_item():
    wl, _, port = _pair()
    base = port.hspec.base
    # conservative mode is ported (tests/test_torch_conservative.py): it
    # refuses the unported sharded surfaces for its own reason first
    cons = pse.SketchTopKEndpoint(base, torch.Generator(), mode="conservative",
                                  device="cpu")
    with pytest.raises(ValueError, match="single-shard"):
        cons.to_sharded(None)
    with pytest.raises(ValueError, match="mode must be"):
        pse.SketchTopKEndpoint(base, torch.Generator(), mode="bogus", device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        port.to_sharded(None)
    # migration and the tuner are ported (tests/test_torch_migration.py):
    # a migration opens, and an engine takes a tuner
    port.begin_migration(base, torch.Generator(), warmup=10)
    assert port.migrating and port.migration_progress == 0.0
    port.abort_migration()
    assert not port.migrating and port.migration_progress == 1.0
    assert pse.SketchServeEngine(port, tuner=object()).tuner is not None
    # a refused ingest leaves the kernel endpoint untouched
    kport = _pair(use_update_kernel=True)[2]
    before = kport.state_dict()
    with pytest.raises(ValueError, match="2\\^24"):
        kport.ingest(wl.stream.items[:2], np.array([1, 1 << 24]))
    _assert_sd_equal(before, kport.state_dict())
