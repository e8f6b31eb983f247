"""Port parity: hot spec migration, live statistics and the auto-tuner.

The port's ``SketchTopKEndpoint`` migrations are held against a fresh port
endpoint on the new spec and against the reference's migrated endpoint on
the same blocks and hash draws (``state_dict``s bitwise equal), across a
partition change too and on the update-kernel path; progress, the
mid-warmup refusals and the ``SpecMigration`` invariants as the reference
states them.  ``collect_live_stats`` is exact on a small keyspace and
equals the reference's; ``propose_spec`` equals the port's offline
``greedy_config`` on the same sample and the reference's ``greedy_config``
with the same draws (the reference's own live-vs-offline test fails in this
container, so the port is held to the offline search directly).  The
``AutoTuner`` takes the same decisions as the reference's when its ``draw``
yields the reference's per-round params, and the engine ticks it on
``sync`` and invalidates its snapshot on ``advance``.  Tolerance 0, except
sigma (float32 reductions in another order): rtol 1e-5.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import greedy as rgr
from repro.core import hashing as rh
from repro.core import sketch as rsk
from repro.serving import autotune as rat
from repro.serving import sketch_engine as rse
from repro.streams import collect_live_stats as r_collect_live_stats
from repro.streams import dstream as rds
from repro.streams import zipf_hh_workload as r_zipf_hh_workload
from repro_torch.core import greedy as pgr
from repro_torch.core import sketch as psk
from repro_torch.core.hashing import KeySchema
from repro_torch.core.range_opt import recursive_ranges
from repro_torch.serving import autotune as pat
from repro_torch.serving import sketch_engine as pse
from repro_torch.serving.migration import SpecMigration, require_not_migrating
from repro_torch.serving.windowed_topk import WindowedTopKService
from repro_torch.streams import collect_live_stats, exact_marginals, propose_spec
from repro_torch.streams import dstream as pds
from repro_torch.streams import zipf_hh_workload

RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def _stream(seed: int):
    kw = dict(n_src=200, n_tgt=400, n_edges=1_500, n_occurrences=8_000, seed=seed)
    s, r = zipf_hh_workload(**kw).stream, r_zipf_hh_workload(**kw).stream
    np.testing.assert_array_equal(s.items, r.items)
    return s


def _spec_pair(schema_domains, partition, ranges, w):
    return (rsk.mod_sketch_spec(rh.KeySchema(schema_domains), partition, ranges, w),
            psk.mod_sketch_spec(KeySchema(schema_domains), partition, ranges, w))


def _params(rspec, key):
    """The reference endpoint's hash draw for ``key``, as numpy."""
    sd = rse.SketchTopKEndpoint(rspec, key).state_dict()
    return sd["params.q"], sd["params.r"]


def _assert_sd_equal(want: dict, got: dict):
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def _assert_answer_equal(want, got):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("use_update_kernel", [False, True])
@pytest.mark.parametrize("new_partition,new_ranges", [([(0,), (1,)], (16, 64)),
                                                      ([(0, 1)], (1024,))])
def test_migrated_endpoint_equals_fresh_and_reference(use_update_kernel, new_partition,
                                                      new_ranges):
    stream = _stream(3)
    r_old, p_old = _spec_pair(stream.schema.domains, [(0,), (1,)], (64, 16), 4)
    r_new, p_new = _spec_pair(stream.schema.domains, new_partition, new_ranges, 4)
    key = jax.random.PRNGKey(0)
    mig_key = jax.random.fold_in(key, 7)
    items, freqs = stream.items, stream.freqs
    n = items.shape[0]
    cut1, cut2 = n // 3, 2 * n // 3
    warm = int(freqs[cut1:cut2].sum())

    ref = rse.SketchTopKEndpoint(r_old, key)
    ep = pse.SketchTopKEndpoint(p_old, _params(r_old, key), device="cpu",
                                use_update_kernel=use_update_kernel)
    for e in (ref, ep):
        e.ingest(items[:cut1], freqs[:cut1])
    ref.begin_migration(r_new, mig_key, warmup=warm)
    ep.begin_migration(p_new, _params(r_new, mig_key), warmup=warm)
    assert ep.migrating and ep.migration_progress == 0.0
    with pytest.raises(ValueError, match="mid-migration"):
        ep.state_dict()
    for e in (ref, ep):
        e.ingest(items[cut1:cut2], freqs[cut1:cut2])     # hits warmup exactly
    assert not ep.migrating and ep.migration_progress == 1.0
    assert (ep._kh is not None) == use_update_kernel
    for e in (ref, ep):
        e.ingest(items[cut2:], freqs[cut2:])

    fresh = pse.SketchTopKEndpoint(p_new, _params(r_new, mig_key), device="cpu",
                                   use_update_kernel=use_update_kernel)
    fresh.ingest(items[cut1:cut2], freqs[cut1:cut2])
    fresh.ingest(items[cut2:], freqs[cut2:])
    assert ep.total == fresh.total == ref.total
    assert ep.hspec == fresh.hspec
    _assert_sd_equal(fresh.state_dict(), ep.state_dict())
    _assert_sd_equal(ref.state_dict(), ep.state_dict())
    _assert_answer_equal(ref.topk(16), ep.topk(16))
    _assert_answer_equal(fresh.topk(16), ep.topk(16))


def test_engine_staged_ingest_migrates_like_the_reference():
    stream = _stream(5)
    r_old, p_old = _spec_pair(stream.schema.domains, [(0,), (1,)], (32, 32), 4)
    r_new, p_new = _spec_pair(stream.schema.domains, [(0,), (1,)], (16, 64), 4)
    key, mig_key = jax.random.PRNGKey(2), jax.random.PRNGKey(9)
    ref = rse.SketchServeEngine(rse.SketchTopKEndpoint(r_old, key))
    eng = pse.SketchServeEngine(pse.SketchTopKEndpoint(p_old, _params(r_old, key),
                                                       device="cpu"))
    blocks = np.array_split(np.arange(stream.items.shape[0]), 6)
    for b, idx in enumerate(blocks):
        if b == 2:
            for e, (spec, params) in ((ref, (r_new, mig_key)),
                                      (eng, (p_new, _params(r_new, mig_key)))):
                e.drain()
                e.backend.begin_migration(spec, params,
                                          warmup=int(stream.freqs[blocks[2]].sum()) + 1)
        for e in (ref, eng):
            e.ingest(stream.items[idx], stream.freqs[idx])
        _assert_answer_equal(ref.topk(8), eng.topk(8))
    eng.drain()
    ref.drain()
    assert not eng.backend.migrating
    _assert_sd_equal(ref.backend.state_dict(), eng.backend.state_dict())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_migration_progress_monotone(seed):
    stream = _stream(seed)
    _, spec = _spec_pair(stream.schema.domains, [(0,), (1,)], (32, 32), 4)
    ep = pse.SketchTopKEndpoint(spec, torch.Generator().manual_seed(seed), device="cpu")
    ep.begin_migration(spec, torch.Generator().manual_seed(seed + 1),
                       warmup=int(stream.freqs.sum()))
    last = 0.0
    for idx in np.array_split(np.arange(stream.items.shape[0]), 8):
        ep.ingest(stream.items[idx], stream.freqs[idx])
        assert ep.migration_progress >= last
        last = ep.migration_progress
    assert not ep.migrating and last == 1.0


def test_refusals_mid_warmup_and_conservative():
    stream = _stream(1)
    _, old = _spec_pair(stream.schema.domains, [(0,), (1,)], (32, 32), 4)
    _, new = _spec_pair(stream.schema.domains, [(0,), (1,)], (16, 64), 4)
    gen = torch.Generator().manual_seed
    cons = pse.SketchTopKEndpoint(old, gen(0), mode="conservative", device="cpu")
    cons.ingest(stream.items, stream.freqs)
    with pytest.raises(ValueError, match="linear"):
        cons.begin_migration(new, gen(1), warmup=1)
    ep = pse.SketchTopKEndpoint(old, gen(0), device="cpu")
    ep.ingest(stream.items, stream.freqs)
    before = ep.state_dict()
    ep.begin_migration(new, gen(1), warmup=1 << 40)
    other = pse.SketchTopKEndpoint(old, gen(0), device="cpu")
    with pytest.raises(ValueError, match="migration"):
        ep.merge_from(other)
    with pytest.raises(ValueError, match="migration"):
        other.merge_from(ep)
    with pytest.raises(ValueError, match="migration"):
        ep.to_sharded(None)
    with pytest.raises(ValueError, match="already in flight"):
        ep.begin_migration(new, gen(2), warmup=1)
    ep.ingest(stream.items[:10], stream.freqs[:10])
    ep.abort_migration()
    ep.abort_migration()                 # twice: no error
    assert not ep.migrating and ep.migration_progress == 1.0
    after = ep.state_dict()
    assert after["meta.total"] == before["meta.total"] + stream.freqs[:10].sum()


def test_spec_migration_holder_invariants():
    stream = _stream(1)
    _, old = _spec_pair(stream.schema.domains, [(0,), (1,)], (32, 32), 4)
    ep = pse.SketchTopKEndpoint(old, torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="warmup"):
        SpecMigration(ep, warmup=0)
    ep.ingest(stream.items, stream.freqs)
    with pytest.raises(ValueError, match="start empty"):
        SpecMigration(ep, warmup=10)
    require_not_migrating(None, "anything")
    fresh = pse.SketchTopKEndpoint(old, torch.Generator(), device="cpu")
    mig = SpecMigration(fresh, warmup=10)
    assert mig.progress == 0.0 and not mig.ready
    with pytest.raises(ValueError, match="warmup window"):
        require_not_migrating(mig, "entry")
    mig.offer(stream.items[:3], np.array([4, 4, 4]))
    assert mig.ready and mig.progress == 1.0


# --------------------------------------------------------------------------
# live statistics
# --------------------------------------------------------------------------

def _small_keyspace(seed):
    rng = np.random.default_rng(seed)
    n = 3000
    src = rng.integers(0, 4, size=n).astype(np.uint32)
    mid = ((src * 2 + rng.integers(0, 3, size=n)) % 8).astype(np.uint32)
    tgt = (rng.zipf(1.6, size=n) % 12).astype(np.uint32)
    uniq, inv = np.unique(np.stack([src, mid, tgt], axis=1), axis=0, return_inverse=True)
    freqs = np.bincount(inv).astype(np.int64)
    rspec, pspec = _spec_pair((4, 8, 16), [(0,), (1,), (2,)], (16, 16, 16), 5)
    key = jax.random.PRNGKey(0)
    ref = rse.SketchTopKEndpoint(rspec, key)
    ep = pse.SketchTopKEndpoint(pspec, _params(rspec, key), device="cpu")
    ref.ingest(uniq, freqs)
    ep.ingest(uniq, freqs)
    return ref, ep, uniq, freqs


def ref_draw(key):
    """The reference's folded-key draw of search candidate ``n``, as numpy."""
    def draw(n, spec):
        rspec = rsk.SketchSpec(rh.KeySchema(spec.schema.domains), spec.partition,
                               spec.ranges, spec.width)
        p = rsk.init_params(rspec, jax.random.fold_in(key, n))
        return np.asarray(p.q), np.asarray(p.r)
    return draw


def ref_key_draw(key):
    """The reference's draw from ``key`` folded with each integer of a path,
    as numpy: the ``KeyDraw`` that gives the port the reference's per-round
    params."""
    def draw(path, spec):
        k = key
        for i in path:
            k = jax.random.fold_in(k, i)
        rspec = rsk.SketchSpec(rh.KeySchema(spec.schema.domains), spec.partition,
                               spec.ranges, spec.width)
        p = rsk.init_params(rspec, k)
        return np.asarray(p.q), np.asarray(p.r)
    return draw


@pytest.mark.parametrize("seed", [7, 11])
def test_collect_live_stats_exact_and_equal_to_reference(seed):
    ref, ep, uniq, freqs = _small_keyspace(seed)
    stats = collect_live_stats(ep, k=len(uniq) + 32, min_threshold=1)
    want = r_collect_live_stats(ref, k=len(uniq) + 32, min_threshold=1)
    exact = {tuple(r): f for r, f in zip(uniq.tolist(), freqs.tolist())}
    got = {tuple(r): f for r, f in zip(stats.items.tolist(), stats.freqs.tolist())}
    assert got == exact
    assert stats.total == int(freqs.sum()) and abs(stats.coverage - 1.0) < 1e-9
    np.testing.assert_array_equal(stats.items, want.items)
    np.testing.assert_array_equal(stats.freqs, want.freqs)
    for j in range(3):
        np.testing.assert_array_equal(stats.group_values[j], want.group_values[j])
        np.testing.assert_array_equal(stats.group_mass[j], want.group_mass[j])
        assert stats.group_skew(j) == want.group_skew(j)
        per_row = exact_marginals(uniq, freqs, [j])
        exact_m = {int(v): int(m) for v, m in zip(uniq[:, j].tolist(), per_row.tolist())}
        live = {int(v): int(m) for v, m in zip(stats.group_values[j][:, 0].tolist(),
                                              stats.group_mass[j].tolist())}
        assert live == exact_m
    assert stats.describe() == want.describe()


@pytest.mark.parametrize("seed", [7, 11])
def test_propose_spec_matches_offline_greedy(seed):
    ref, ep, uniq, freqs = _small_keyspace(seed)
    stats = collect_live_stats(ep, k=len(uniq) + 32, min_threshold=1)
    key = jax.random.PRNGKey(3)
    for h in (64, 256):
        live = propose_spec(stats, h, 4, ref_draw(key), device="cpu")
        off = pgr.greedy_config(stats.items, stats.freqs, stats.schema, h, 4,
                                ref_draw(key), device="cpu")
        want = rgr.greedy_config(stats.items, stats.freqs, ref.hspec.base.schema, h, 4, key)
        for got in (off, want):
            assert live.spec.partition == got.spec.partition
            assert live.spec.ranges == got.spec.ranges
            assert live.spec.width == got.spec.width
    part = ((0,), (1,), (2,))
    ranged = propose_spec(stats, 256, 4, partition=part)
    assert ranged.spec.partition == part and ranged.trace == []
    assert ranged.spec.ranges == recursive_ranges(uniq, freqs, part, 256.0)
    few = dataclasses.replace(stats, items=stats.items[:1], freqs=stats.freqs[:1])
    with pytest.raises(ValueError, match="at least 2"):
        propose_spec(few, 64, 4)


# --------------------------------------------------------------------------
# the auto-tuner and the engine
# --------------------------------------------------------------------------

def _skew_blocks():
    return list(pds.skew_flip_batches((1 << 32, 1 << 32), 8, 1500, narrow=8, wide=256,
                                      seed=3))


@pytest.mark.parametrize("search", ["ranges", "greedy"])
def test_autotuner_decisions_match_reference(search):
    blocks = _skew_blocks()
    rblocks = list(rds.skew_flip_batches((1 << 32, 1 << 32), 8, 1500, narrow=8, wide=256,
                                         seed=3))
    for a, b in zip(blocks, rblocks):
        np.testing.assert_array_equal(a.items, b.items)
    r_spec, p_spec = _spec_pair((1 << 32, 1 << 32), [(0,), (1,)], (256, 4), 4)
    key, tkey = jax.random.PRNGKey(1), jax.random.PRNGKey(5)
    mass = int(blocks[0].freqs.sum())
    kw = dict(retune_every=2 * mass, warmup=mass, sample_k=256, search=search,
              min_improvement=0.95)
    ref_ep = rse.SketchTopKEndpoint(r_spec, key, max_candidates_per_group=512)
    ep = pse.SketchTopKEndpoint(p_spec, _params(r_spec, key), max_candidates_per_group=512,
                                device="cpu")
    r_tuner = rat.AutoTuner(ref_ep, tkey, **kw)
    p_tuner = pat.AutoTuner(ep, ref_key_draw(tkey), **kw)
    ref = rse.SketchServeEngine(ref_ep, tuner=r_tuner)
    eng = pse.SketchServeEngine(ep, tuner=p_tuner)
    for b in blocks:
        ref.ingest(b.items, b.freqs)
        eng.ingest(b.items, b.freqs)
        ref.sync()
        eng.sync()
    assert len(p_tuner.decisions) == len(r_tuner.decisions) > 0
    for got, want in zip(p_tuner.decisions, r_tuner.decisions):
        assert (got.at_total, got.migrated, got.reason, got.proposed_partition,
                got.proposed_ranges) == (want.at_total, want.migrated, want.reason,
                                         want.proposed_partition, want.proposed_ranges)
        np.testing.assert_allclose([got.sigma_current, got.sigma_proposed],
                                   [want.sigma_current, want.sigma_proposed], rtol=RTOL)
    assert any(d.migrated for d in p_tuner.decisions)
    assert (ep.hspec.base.partition, ep.hspec.base.ranges) == (
        ref_ep.hspec.base.partition, ref_ep.hspec.base.ranges)
    if not ep.migrating:
        _assert_sd_equal(ref_ep.state_dict(), ep.state_dict())
    _assert_answer_equal(ref.topk(10), eng.topk(10))


def test_autotuner_validation_and_schedule():
    stream = _stream(2)
    _, spec = _spec_pair(stream.schema.domains, [(0,), (1,)], (32, 32), 4)
    ep = pse.SketchTopKEndpoint(spec, torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="retune_every"):
        pat.AutoTuner(ep, retune_every=0, warmup=1)
    with pytest.raises(ValueError, match="min_improvement"):
        pat.AutoTuner(ep, retune_every=1, warmup=1, min_improvement=1.5)
    with pytest.raises(ValueError, match="search"):
        pat.AutoTuner(ep, retune_every=1, warmup=1, search="random")
    tuner = pat.AutoTuner(ep, retune_every=10 ** 9, warmup=1)
    assert tuner.h == 32 * 32 and tuner.w == 4
    assert tuner.step() is None and tuner.last_decision is None
    d = tuner.force()
    assert d.reason == "too-few-keys" and tuner.last_decision is d
    ep.begin_migration(spec, torch.Generator(), warmup=1 << 40)
    assert tuner.force().reason == "already-migrating"
    a, b = pat.seeded_key_draw(3), pat.seeded_key_draw(3)
    pa, pb = a((1, 2), spec), b((1, 2), spec)
    assert torch.equal(pa.q, pb.q) and not torch.equal(pa.q, a((1, 3), spec).q)


class _CountingTuner:
    def __init__(self):
        self.steps = 0

    def step(self):
        self.steps += 1


def test_engine_ticks_tuner_on_sync_and_advance_invalidates():
    stream = _stream(4)
    _, spec = _spec_pair(stream.schema.domains, [(0,), (1,)], (32, 32), 4)
    tuner = _CountingTuner()
    eng = pse.SketchServeEngine(
        pse.SketchTopKEndpoint(spec, torch.Generator(), device="cpu"), tuner=tuner)
    assert tuner.steps == 0                     # construction takes a snapshot only
    eng.ingest(stream.items, stream.freqs)
    eng.topk(4)                                 # a stale query syncs, so it ticks
    eng.sync()
    assert tuner.steps == 2

    svc = WindowedTopKService(spec, torch.Generator(), n_epochs=2, device="cpu",
                              max_candidates_per_group=256)
    weng = pse.SketchServeEngine(svc, max_staleness=None)
    half = stream.items.shape[0] // 2
    weng.ingest(stream.items[:half], stream.freqs[:half])
    weng.sync()
    before = weng.topk(4)
    weng.advance()
    assert weng._snap is None                   # advance invalidates the snapshot
    weng.advance()                              # both epochs of the first half expire
    got = weng.topk(4)
    assert got[0].shape[0] == 0 and before[0].shape[0] == 4
    assert weng.staleness == 0
