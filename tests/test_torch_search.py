"""Port parity: the paper's strategy search (Thm 3 ranges, Thm 4/5 sigma
selection, Algorithm 1 greedy, Exhaustive) and the statistics it uses.

``partition``, ``range_opt``, ``query_marginal``, ``streams.stats`` and
``streams.sampling`` must equal the reference exactly.  The search
functions take the reference's own hash draws through ``draw(n, spec)``
(``sk.init_params(spec, jax.random.fold_in(key, n))`` as numpy), so both
sides build the same int32 sketches.  ``cell_std`` and the search's sigma
values are float32 reductions taken in another order: rtol 1e-5.  A choice
(and so the specs that follow it) is compared only where the competing
sigmas differ by more than that; errors of int32 sketches are exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import exhaustive as rex
from repro.core import greedy as rgr
from repro.core import hashing as rh
from repro.core import hierarchy as rhh
from repro.core import partition as rpart
from repro.core import range_opt as rro
from repro.core import selection as rsel
from repro.core import sketch as rsk
from repro.streams import sampling as rsamp
from repro.streams import stats as rstats
from repro.streams import zipf_graph_stream as r_zipf_graph_stream
from repro_torch.core import exhaustive as pex
from repro_torch.core import greedy as pgr
from repro_torch.core import hashing as ph
from repro_torch.core import hierarchy as phh
from repro_torch.core import partition as ppart
from repro_torch.core import range_opt as pro
from repro_torch.core import selection as psel
from repro_torch.core import sketch as psk
from repro_torch.streams import observed_error, sampling as psamp, stats as pstats
from repro_torch.streams import zipf_graph_stream

RTOL = 1e-5
KEY = jax.random.PRNGKey(4)


def ref_draw(key):
    """The reference's folded-key draw of candidate ``n``, as numpy."""
    def draw(n, spec):
        rspec = rsk.SketchSpec(rh.KeySchema(spec.schema.domains), spec.partition,
                               spec.ranges, spec.width)
        p = rsk.init_params(rspec, jax.random.fold_in(key, n))
        return np.asarray(p.q), np.asarray(p.r)
    return draw


def _mod3_sample(seed=5, n=20_000, frac=0.1):
    """A modularity-3 stream (skewed middle module) and its uniform sample."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 30, n)
    mid = (rng.zipf(1.3, n) % 300)
    tgt = rng.integers(0, 3000, n)
    uniq, inv = np.unique(np.stack([src, mid, tgt], axis=1).astype(np.uint32),
                          axis=0, return_inverse=True)
    freqs = np.bincount(inv.reshape(-1)).astype(np.int64)
    cnt = rng.binomial(freqs, frac)
    keep = cnt > 0
    return (32, 512, 4096), uniq, freqs, uniq[keep], cnt[keep]


@functools.lru_cache(maxsize=1)
def _graph():
    kw = dict(n_src=2000, n_tgt=6000, n_edges=20_000, n_occurrences=120_000,
              s_src=0.7, s_tgt=0.7, seed=3)
    stream, rstream = zipf_graph_stream(**kw), r_zipf_graph_stream(**kw)
    np.testing.assert_array_equal(stream.items, rstream.items)
    np.testing.assert_array_equal(stream.freqs, rstream.freqs)
    return stream, rstream


# --------------------------------------------------------------------------
# exact numpy copies
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(7))
def test_partition_matches_reference(n):
    assert ppart.bell_number(n) == rpart.bell_number(n)
    got = list(ppart.all_partitions(range(n)))
    assert got == list(rpart.all_partitions(range(n)))
    assert len(got) == ppart.bell_number(n)
    for part in got:
        shuffled = [tuple(reversed(g)) for g in reversed(part)]
        assert ppart.canonical(shuffled) == rpart.canonical(shuffled) == part


@pytest.mark.parametrize("agg", ["median", "mean", "min", "max"])
def test_range_opt_matches_reference(agg):
    _, _, _, items, freqs = _mod3_sample()
    for fn in ("aggregate_sample",):
        for a, b in zip(getattr(pro, fn)(items, freqs), getattr(rro, fn)(items, freqs)):
            np.testing.assert_array_equal(a, b)
    for cols in ([0], [1, 2], [2, 0]):
        np.testing.assert_array_equal(pro.marginal_per_item(items, freqs, cols),
                                      rro.marginal_per_item(items, freqs, cols))
    assert pro.weighted_median(items[:, 1], freqs) == rro.weighted_median(items[:, 1], freqs)
    alphas = items[:, 0] / (items[:, 2] + 1.0)
    assert pro.aggregate_alpha(alphas, freqs, agg) == rro.aggregate_alpha(alphas, freqs, agg)
    for first, second in (([0], [1]), ([1], [0, 2])):
        assert (pro.estimate_alpha(items, freqs, first, second, agg)
                == rro.estimate_alpha(items, freqs, first, second, agg))
    for h, beta in ((360_000, 2.0), (4096, 0.3), (10, 1e-9)):
        assert pro.split_range(h, beta) == rro.split_range(h, beta)
    assert (pro.optimal_ranges_mod2(items[:, :2], freqs, 4096, agg)
            == rro.optimal_ranges_mod2(items[:, :2], freqs, 4096, agg))
    pc, rc = {}, {}
    for groups in ([[0], [1], [2]], [[0, 1], [2]], [[2], [0], [1]]):
        assert (pro.recursive_ranges(items, freqs, groups, 1 << 14, agg, pc)
                == rro.recursive_ranges(items, freqs, groups, 1 << 14, agg, rc))
    assert pc == rc
    with pytest.raises(ValueError, match="unknown aggregate"):
        pro.aggregate_alpha(alphas, freqs, "mode")


def test_stats_and_samplers_match_reference():
    stream, rstream = _graph()
    rng = np.random.default_rng(0)
    est = stream.freqs + rng.integers(0, 50, stream.freqs.shape)
    for fn in ("observed_error", "average_relative_error"):
        assert getattr(pstats, fn)(est, stream.freqs) == getattr(rstats, fn)(est, stream.freqs)
    assert pstats.exact_f2(stream.freqs) == rstats.exact_f2(stream.freqs)
    table = rng.integers(0, 1000, (4, 64))
    assert pstats.sketch_f2_upper(table) == rstats.sketch_f2_upper(table)
    np.testing.assert_array_equal(pstats.exact_marginals(stream.items, stream.freqs, [1]),
                                  rstats.exact_marginals(rstream.items, rstream.freqs, [1]))
    assert pstats.degree_stats(stream.items, stream.freqs) == rstats.degree_stats(
        rstream.items, rstream.freqs)
    with pytest.raises(ValueError, match="shape mismatch"):
        pstats.average_relative_error(est[:3], stream.freqs[:2])
    # the hierarchy's finest-level point estimates, on the reference's draw
    rbase = rsk.mod_sketch_spec(rstream.schema, [(1,), (0,)], (64, 128), 3)
    pbase = psk.mod_sketch_spec(stream.schema, [(1,), (0,)], (64, 128), 3)
    rhs, phs = rhh.HierarchySpec.from_spec(rbase), phh.HierarchySpec.from_spec(pbase)
    rstate = rhh.build_hierarchy(rhs, KEY, rstream.items, rstream.freqs)
    fine = rstate.states[-1].params
    pstate = phh.build_hierarchy(phs, (np.asarray(fine.q), np.asarray(fine.r)),
                                 stream.items, stream.freqs, device="cpu")
    q = stream.items[:300]
    np.testing.assert_array_equal(pstats.hierarchy_point_estimates(phs, pstate, q),
                                  rstats.hierarchy_point_estimates(rhs, rstate, q))
    assert (pstats.topk_point_are(phs, pstate, q, stream.freqs[:300])
            == rstats.topk_point_are(rhs, rstate, q, stream.freqs[:300]))
    # the uniform samplers draw the same sample from the same seed
    for cls, arg in (("BernoulliSampler", 0.1), ("ReservoirSampler", 500)):
        ps, rs = getattr(psamp, cls)(arg, seed=7), getattr(rsamp, cls)(arg, seed=7)
        for s in range(0, 6000, 2000):
            ps.offer(stream.items[s:s + 2000], stream.freqs[s:s + 2000])
            rs.offer(stream.items[s:s + 2000], stream.freqs[s:s + 2000])
        for a, b in zip(ps.sample(), rs.sample()):
            np.testing.assert_array_equal(a, b)
    assert observed_error is pstats.observed_error


# --------------------------------------------------------------------------
# query_marginal and cell_std
# --------------------------------------------------------------------------

@pytest.mark.parametrize("partition,ranges", [([(0,), (1,)], (64, 32)),
                                              ([(2,), (0, 1), (3,)], (8, 6, 5))])
def test_query_marginal_matches_reference(partition, ranges):
    domains = (1 << 32, 256, 1000, 70_000)[: 2 if len(ranges) == 2 else 4]
    rspec = rsk.mod_sketch_spec(rh.KeySchema(domains), partition, ranges, 3)
    pspec = psk.mod_sketch_spec(ph.KeySchema(domains), partition, ranges, 3)
    rng = np.random.default_rng(1)
    items = np.stack([rng.integers(0, min(d, 50), 3000).astype(np.uint32)
                      for d in domains], axis=1)
    freqs = rng.integers(1, 1000, 3000).astype(np.int64)
    rstate = rsk.build_sketch(rspec, KEY, items, freqs)
    p = rsk.init_params(rspec, KEY)
    pstate = psk.build_sketch(pspec, (np.asarray(p.q), np.asarray(p.r)), items, freqs,
                              device="cpu")
    for g, group in enumerate(partition):
        values = items[:200][:, list(group)]
        want = np.asarray(rsk.query_marginal(rspec, rstate, g, jnp.asarray(values)))
        got = psk.query_marginal(pspec, pstate, g, values)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_cell_std_matches_reference(dtype):
    rng = np.random.default_rng(2)
    table = rng.integers(0, 1 << 20, (5, 4096)).astype(dtype)
    want = float(rsk.cell_std(jnp.asarray(table)))
    got = psk.cell_std(torch.from_numpy(table))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=RTOL)
    assert psk.cell_std(torch.from_numpy(table.astype(np.int64))).dtype == torch.float64
    # a population std (ddof 0), not torch.std's default ddof 1
    np.testing.assert_allclose(float(got), float(np.std(table.astype(np.float64))),
                               rtol=RTOL)


# --------------------------------------------------------------------------
# the search, on the reference's draws
# --------------------------------------------------------------------------

def _check_sigmas(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)


def _clear_choice(sigmas) -> bool:
    """True when the smallest sigma beats the runner-up by more than RTOL."""
    s = sorted(sigmas)
    return len(s) < 2 or s[1] - s[0] > RTOL * s[1]


def test_choose_sketch_and_migration_gain_match_reference():
    stream, rstream = _graph()
    s_items, s_freqs = stream.sample(0.05, np.random.default_rng(0))
    h, w = 2048, 4
    want = rsel.choose_sketch(s_items, s_freqs, rstream.schema, h, w, KEY)
    got = psel.choose_sketch(s_items, s_freqs, stream.schema, h, w, ref_draw(KEY),
                             device="cpu")
    _check_sigmas(got.sigma, want.sigma)
    assert got.mod_ranges == want.mod_ranges
    assert _clear_choice(want.sigma.values())
    assert got.choice == want.choice and got.spec.describe() == want.spec.describe()
    # explicit candidates, in the caller's order
    cands = {"equal": psk.equal_sketch_spec(stream.schema, h, w),
             "count-min": psk.count_min_spec(stream.schema, h, w)}
    rcands = {"equal": rsk.equal_sketch_spec(rstream.schema, h, w),
              "count-min": rsk.count_min_spec(rstream.schema, h, w)}
    want = rsel.choose_sketch(s_items, s_freqs, rstream.schema, h, w, KEY,
                              candidates=rcands)
    got = psel.choose_sketch(s_items, s_freqs, stream.schema, h, w, ref_draw(KEY),
                             candidates=cands, device="cpu")
    _check_sigmas(got.sigma, want.sigma)
    want_gain = rsel.migration_gain(rcands["count-min"], rcands["equal"], s_items,
                                    s_freqs, KEY)
    got_gain = psel.migration_gain(cands["count-min"], cands["equal"], s_items,
                                   s_freqs, ref_draw(KEY), device="cpu")
    np.testing.assert_allclose(got_gain, want_gain, rtol=RTOL)


def test_greedy_config_matches_reference():
    domains, _, _, items, freqs = _mod3_sample()
    want = rgr.greedy_config(items, freqs, rh.KeySchema(domains), 1024, 4, KEY)
    got = pgr.greedy_config(items, freqs, ph.KeySchema(domains), 1024, 4,
                            ref_draw(KEY), device="cpu")
    assert got.n_candidates == want.n_candidates
    assert got.beta_cache_hits == want.beta_cache_hits
    assert len(got.trace) == len(want.trace)
    for stage in sorted({t.stage for t in want.trace}):
        rt = [t for t in want.trace if t.stage == stage]
        pt = [t for t in got.trace if t.stage == stage]
        for a, b in zip(rt, pt):
            assert (b.partition, b.covered, b.ranges) == (a.partition, a.covered, a.ranges)
            np.testing.assert_allclose(b.sigma, a.sigma, rtol=RTOL)
        assert _clear_choice([t.sigma for t in rt]), f"stage {stage}: a near tie"
        assert [t.chosen for t in pt] == [t.chosen for t in rt]
    assert got.spec.describe() == want.spec.describe()


def test_exhaustive_config_matches_reference():
    domains, _, _, items, freqs = _mod3_sample(seed=8, n=8000)
    want = rex.exhaustive_config(items, freqs, rh.KeySchema(domains), 512, 3, KEY,
                                 grid=5, query_top=100)
    got = pex.exhaustive_config(items, freqs, ph.KeySchema(domains), 512, 3,
                                ref_draw(KEY), grid=5, query_top=100, device="cpu")
    assert got.n_configs == want.n_configs
    assert got.spec.describe() == want.spec.describe()
    assert got.error == want.error
    est, true = np.array([3, 5, 9]), np.array([3, 4, 8])
    assert pex.observed_error(est, true) == rex.observed_error(est, true)
    with pytest.raises(ValueError, match="100 hours"):
        pex.exhaustive_config(items, freqs, ph.KeySchema(domains), 512, 3,
                              max_modularity=2, device="cpu")


def test_quickstart_error_table_matches_reference():
    """``examples/quickstart.py``'s pipeline on a reduced stream: the same
    selection and, for the four specs built with the same draw, the same
    observed errors on both query mixes."""
    stream, rstream = _graph()
    h, w = 4096, 5
    s_items, s_freqs = stream.sample(0.02, np.random.default_rng(0))
    want = rsel.choose_sketch(s_items, s_freqs, rstream.schema, h, w, KEY)
    got = psel.choose_sketch(s_items, s_freqs, stream.schema, h, w, ref_draw(KEY),
                             device="cpu")
    _check_sigmas(got.sigma, want.sigma)
    assert got.mod_ranges == want.mod_ranges
    a, b = got.mod_ranges
    qsets = {"top-500": stream.top_k_queries(500),
             "random-500": stream.random_k_queries(500, np.random.default_rng(1))}
    rspecs = {"count-min": rsk.count_min_spec(rstream.schema, h, w),
              "equal-sketch": rsk.equal_sketch_spec(rstream.schema, h, w),
              "mod-sketch": rsk.mod_sketch_spec(rstream.schema, [(0,), (1,)], (a, b), w),
              "selected": want.spec}
    pspecs = {"count-min": psk.count_min_spec(stream.schema, h, w),
              "equal-sketch": psk.equal_sketch_spec(stream.schema, h, w),
              "mod-sketch": psk.mod_sketch_spec(stream.schema, [(0,), (1,)], (a, b), w),
              "selected": got.spec}
    assert _clear_choice(want.sigma.values())
    for name, rspec in rspecs.items():
        pspec = pspecs[name]
        assert pspec.describe() == rspec.describe()
        rstate = rsk.build_sketch(rspec, KEY, rstream.items, rstream.freqs)
        p = rsk.init_params(rspec, KEY)
        pstate = psk.build_sketch(pspec, (np.asarray(p.q), np.asarray(p.r)),
                                  stream.items, stream.freqs, device="cpu")
        for qname, (qi, qf) in qsets.items():
            rest = np.asarray(rsk.query_jit(rspec, rstate, jnp.asarray(qi)))
            pest = psk.query(pspec, pstate, qi).numpy()
            np.testing.assert_array_equal(pest, rest)
            assert observed_error(pest, qf) == rstats.observed_error(rest, qf), (name, qname)


def test_default_draw_is_seeded_and_lands_on_the_device():
    stream, _ = _graph()
    s_items, s_freqs = stream.sample(0.05, np.random.default_rng(0))
    runs = [psel.choose_sketch(s_items, s_freqs, stream.schema, 1024, 3, draw,
                               device="cpu").sigma
            for draw in (None, psel.seeded_draw(0), psel.seeded_draw(1))]
    assert runs[0] == runs[1] and runs[0] != runs[2]
    draw = psel.seeded_draw(5)
    spec = psk.count_min_spec(stream.schema, 1024, 3)
    q1, r1 = draw(3, spec)
    q2, r2 = draw(3, spec)
    assert torch.equal(q1, q2) and torch.equal(r1, r2)
    assert not torch.equal(q1, draw(4, spec).q)
    assert q1.device.type == "cpu" and q1.shape == (3, spec.schema.total_chunks)
