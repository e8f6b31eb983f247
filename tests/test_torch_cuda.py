"""The port's CUDA kernels (K1-K9, K5i) against their plain PyTorch
versions.

Needs a CUDA card: every test skips without one (``-m gpu`` selects them
on a machine that has one).  Inputs are made with numpy from a seed; the
tables are int32, so the tolerance is exact equality.  Each kernel is
compared with its plain version on the same card and the same inputs, at
small shapes that still cover joint groups, multi-chunk modules,
duplicate keys, zero-frequency rows, level widths that are not tile
multiples, int32 wraparound, negative (turnstile) frequencies, strided
level views, and both residency routes of the conservative fold (K5, K5i)
on int32 and float32 tables.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import countsketch as cs
from repro_torch.core import hierarchy as hh
from repro_torch.core import sketch as sk
from repro_torch.core.hashing import KeySchema, draw_hash_params_np
from repro_torch.kernels import _cuda
from repro_torch.kernels import hier_query as hq
from repro_torch.kernels import hier_update as hu
from repro_torch.kernels import sketch_query as sq
from repro_torch.kernels import sketch_update as su
from repro_torch.kernels import sketch_update_conservative as scu
from repro_torch.kernels.hashes import make_plan
from repro_torch.kernels.ops import KernelHierarchy, KernelSketch
from repro_torch.serving.sketch_engine import SketchServeEngine, SketchTopKEndpoint
from repro_torch.streams import zipf_hh_workload

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _hspec(w=3):
    schema = KeySchema(domains=(1 << 32, 256, 1000, 4096))
    base = sk.mod_sketch_spec(schema, [(1, 2), (0,), (3,)], (48, 90, 7), w)
    return hh.HierarchySpec.from_spec(base)


def _block(hspec, n, seed):
    rng = np.random.default_rng(seed)
    items = np.stack([rng.integers(0, d, n, dtype=np.uint64).astype(np.uint32)
                      for d in hspec.base.schema.domains], axis=1)
    items[n // 10 : n // 4] = items[0]            # heavy duplication
    freqs = rng.integers(0, 1 << 12, n).astype(np.int32)
    freqs[-n // 8:] = 0                           # zero-frequency pad rows
    return items, freqs


def _params(spec, seed, device):
    rng = np.random.default_rng(seed)
    q = draw_hash_params_np(rng, (spec.width, spec.schema.total_chunks))
    r = draw_hash_params_np(rng, (spec.width, spec.n_groups))
    return sk.resolve_params(spec, (q, r), device)


def _random_table(shape, seed, device, lo=-(1 << 20), hi=1 << 20):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int32)).to(device)


def test_k1_k2_flat_sketch_match_plain(cuda):
    spec = _hspec().levels[-1]
    plan = make_plan(spec)
    params = _params(spec, 0, cuda)
    h_pad = su.padded_table_size(spec.table_size, 128)
    items, freqs = _block(_hspec(), 3000, 1)
    chunks = spec.schema.module_chunks(torch.from_numpy(items.astype(np.int64)).to(cuda))
    f = torch.from_numpy(freqs).to(cuda)
    base = _random_table((spec.width, h_pad), 2, cuda)
    n0 = _cuda.LAUNCHES["sketch_update"]
    got = su.sketch_update(plan, base.clone(), chunks, f, params.q, params.r)
    want = su.sketch_update_ref(plan, base.clone(), chunks, f, params.q, params.r)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["sketch_update"] == n0 + 1
    assert torch.equal(got, want)

    n0 = _cuda.LAUNCHES["sketch_query"]
    est = sq.sketch_query(plan, got, chunks, params.q, params.r)
    assert _cuda.LAUNCHES["sketch_query"] == n0 + 1
    assert torch.equal(est, sq.sketch_query_ref(plan, got, chunks, params.q, params.r))


def test_k3_fused_hierarchy_update_matches_plain(cuda):
    hspec = _hspec()
    hplan = hu.make_hier_plan(hspec, tile_h=128)
    params = _params(hspec.levels[-1], 3, cuda)
    table = _random_table((hspec.base.width, hplan.padded_cols), 4, cuda)
    got, want = table.clone(), table.clone()
    for seed in (5, 6):                               # multiple blocks
        items, freqs = _block(hspec, 2000, seed)
        ordered = hspec.level_items(hspec.n_levels - 1, items)
        chunks = hspec.levels[-1].schema.module_chunks(
            torch.from_numpy(ordered.astype(np.int64)).to(cuda))
        f = torch.from_numpy(freqs).to(cuda)
        hu.hier_update(hplan, got, chunks, f, params.q, params.r)
        hu.hier_update_ref(hplan, want, chunks, f, params.q, params.r)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_k1_k3_int32_wraparound_matches_plain(cuda):
    hspec = _hspec(w=2)
    hplan = hu.make_hier_plan(hspec, tile_h=128)
    params = _params(hspec.levels[-1], 7, cuda)
    table = _random_table((2, hplan.padded_cols), 8, cuda,
                          lo=(1 << 31) - (1 << 24), hi=(1 << 31) - 1)
    items, _ = _block(hspec, 1500, 9)
    freqs = np.full(1500, (1 << 24) - 1, np.int32)
    chunks = hspec.levels[-1].schema.module_chunks(
        torch.from_numpy(hspec.level_items(2, items).astype(np.int64)).to(cuda))
    f = torch.from_numpy(freqs).to(cuda)
    got = hu.hier_update(hplan, table.clone(), chunks, f, params.q, params.r)
    want = hu.hier_update_ref(hplan, table.clone(), chunks, f, params.q, params.r)
    assert torch.equal(got, want)
    assert int(got.min()) < 0                         # it did wrap


def test_k4_candidate_grid_on_level_views_matches_plain(cuda):
    hspec = _hspec()
    kh = KernelHierarchy(hspec, _params(hspec.levels[-1], 10, cuda), tile_h=128,
                          device=cuda)
    kh.table.copy_(_random_table(tuple(kh.table.shape), 11, cuda))
    kh._state_cache = None
    state = kh.state()
    rng = np.random.default_rng(12)
    for level in range(hspec.n_levels):
        view = state.states[level].table
        assert not view.is_contiguous() or level == 0
        n_pref = len(hh.level_modules(hspec.base, level - 1)) if level else 0
        prefixes = np.stack([rng.integers(0, hspec.base.schema.domains[m], 37,
                                          dtype=np.uint64).astype(np.uint32)
                             for m in hh.level_modules(hspec.base, level - 1)],
                            axis=1) if level else np.zeros((1, 0), np.uint32)
        assert prefixes.shape[1] == n_pref
        mods = hspec.base.partition[level]
        values = np.stack([rng.integers(0, hspec.base.schema.domains[m], 53,
                                        dtype=np.uint64).astype(np.uint32)
                           for m in mods], axis=1)
        pp, cp = hh.candidate_partials(hspec, state, level, prefixes, values)
        n0 = _cuda.LAUNCHES["hier_query"]
        got = hq.hier_candidate_query(view, pp, cp)
        assert _cuda.LAUNCHES["hier_query"] == n0 + 1
        assert torch.equal(got, hq.hier_candidate_query_ref(view, pp, cp))
        pp3 = torch.stack([pp, pp.flip(1)], dim=1)
        assert torch.equal(hq.hier_candidate_query_batched(view, pp3, cp),
                           hq.hier_candidate_query_batched_ref(view, pp3, cp))


def test_kernel_wrappers_refuse_what_they_do_not_take(cuda):
    spec = _hspec().levels[-1]
    plan = make_plan(spec)
    params = _params(spec, 13, cuda)
    items, freqs = _block(_hspec(), 64, 14)
    chunks = spec.schema.module_chunks(torch.from_numpy(items.astype(np.int64)).to(cuda))
    f = torch.from_numpy(freqs).to(cuda)
    h_pad = su.padded_table_size(spec.table_size, 128)
    with pytest.raises(NotImplementedError, match="training slice"):
        su.sketch_update(plan, torch.zeros((spec.width, h_pad), device=cuda),
                         chunks, f, params.q, params.r)
    table = torch.zeros((spec.width, h_pad), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="is on cpu"):
        su.sketch_update(plan, table, chunks.cpu(), f, params.q, params.r)
    with pytest.raises(ValueError, match="int64"):
        sq.sketch_query(plan, table, chunks.to(torch.int32), params.q, params.r)
    with pytest.raises(NotImplementedError, match="training slice"):
        hq.hier_candidate_query(table.float(), chunks[:2, :1].T.contiguous(),
                                chunks[:2, :1].T.contiguous())


@pytest.mark.parametrize("dtype,error,match", [
    (torch.float32, NotImplementedError, "training slice"),
    (torch.int64, ValueError, "takes int32 tables"),
])
def test_kernel_descent_refuses_tables_k4_does_not_take(cuda, dtype, error, match):
    hspec = _hspec()
    state = hh.init_hierarchy(hspec, _params(hspec.levels[-1], 16, cuda), dtype=dtype,
                              device=cuda)
    rng = np.random.default_rng(17)
    values = np.stack([rng.integers(0, hspec.base.schema.domains[m], 9,
                                    dtype=np.uint64).astype(np.uint32)
                       for m in hspec.base.partition[0]], axis=1)
    n0 = _cuda.LAUNCHES["hier_query"]
    with pytest.raises(error, match=match):
        hh.candidate_estimates(hspec, state, 0, np.zeros((1, 0), np.uint32), values,
                               use_kernel=True)
    with pytest.raises(error, match=match):
        hh.batched_candidate_estimates(hspec, state, 0, [np.zeros((1, 0), np.uint32)],
                                       values, use_kernel=True)
    assert _cuda.LAUNCHES["hier_query"] == n0


def test_endpoint_kernel_paths_equal_plain_paths_on_card(cuda):
    wl = zipf_hh_workload(n_src=300, n_tgt=600, n_edges=3000,
                          n_occurrences=30_000, seed=2)
    st = wl.stream
    spec = sk.mod_sketch_spec(KeySchema(st.schema.domains), [(0,), (1,)],
                              (64, 32), 4)
    params = _params(spec, 15, "cpu")
    eps = [SketchTopKEndpoint(spec, params, use_update_kernel=k, use_kernel=k,
                              device=cuda) for k in (True, False)]
    engines = [SketchServeEngine(ep, max_staleness=0) for ep in eps]
    _cuda.reset_launches()
    for s in range(0, st.items.shape[0], 700):
        for eng in engines:
            eng.ingest(st.items[s : s + 700], st.freqs[s : s + 700])
    for eng in engines:
        eng.submit_topk(20)
        eng.submit_heavy_hitters(wl.threshold)
    answers = [(eng.topk(25), eng.heavy_hitters(wl.threshold), eng.flush())
               for eng in engines]
    assert _cuda.LAUNCHES["hier_update"] > 0 and _cuda.LAUNCHES["hier_query"] > 0
    sd_k, sd_p = eps[0].state_dict(), eps[1].state_dict()
    assert sd_k.keys() == sd_p.keys()
    for key in sd_k:
        np.testing.assert_array_equal(sd_k[key], sd_p[key])
    (tk_k, hh_k, fl_k), (tk_p, hh_p, fl_p) = answers
    for a, b in ((tk_k, tk_p), (hh_k, hh_p)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    for ra, rb in zip(fl_k, fl_p):
        np.testing.assert_array_equal(ra.items, rb.items)
        np.testing.assert_array_equal(ra.est, rb.est)

    ks = KernelSketch(spec, params, device=cuda)
    ks.update(st.items, st.freqs)
    plain = sk.build_sketch(spec, params, st.items, st.freqs, device=cuda)
    assert torch.equal(ks.state().table, plain.table)
    np.testing.assert_array_equal(
        ks.query(st.items[:500]),
        sk.query(spec, plain, st.items[:500]).cpu().numpy())


def _signed_params(spec, seed, device):
    rng = np.random.default_rng(seed)
    arrays = [draw_hash_params_np(rng, shape) for shape in
              [(spec.width, spec.schema.total_chunks), (spec.width, spec.n_groups)] * 2]
    return cs.resolve_params(spec, arrays, device)


def _signed_block(hspec, n, seed):
    items, freqs = _block(hspec, n, seed)
    freqs[::3] *= -1                              # turnstile deletions
    return items, freqs


def _chunks(spec, items, device):
    return spec.schema.module_chunks(torch.from_numpy(items.astype(np.int64)).to(device))


def test_k6_k7_signed_flat_sketch_match_plain(cuda):
    spec = _hspec().levels[-1]
    plan = make_plan(spec)
    p = _signed_params(spec, 20, cuda)
    (q, r), s_q, s_r = p
    h_pad = su.padded_table_size(spec.table_size, 128)
    items, freqs = _signed_block(_hspec(), 3000, 21)
    chunks = _chunks(spec, items, cuda)
    f = torch.from_numpy(freqs).to(cuda)
    base = _random_table((spec.width, h_pad), 22, cuda)
    n0 = _cuda.LAUNCHES["sketch_update_signed"]
    got = su.sketch_update_signed(plan, base.clone(), chunks, f, q, r, s_q, s_r)
    want = su.sketch_update_signed_ref(plan, base.clone(), chunks, f, q, r, s_q, s_r)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["sketch_update_signed"] == n0 + 1
    assert torch.equal(got, want)

    n0 = _cuda.LAUNCHES["sketch_query_signed"]
    rows = sq.sketch_query_signed(plan, got, chunks, q, r, s_q, s_r)
    assert _cuda.LAUNCHES["sketch_query_signed"] == n0 + 1
    assert rows.dtype == torch.int32 and rows.shape == (spec.width, 3000)
    assert torch.equal(rows, sq.sketch_query_signed_ref(plan, got, chunks, q, r, s_q, s_r))


def test_k8_signed_hierarchy_update_matches_plain(cuda):
    hspec = _hspec(w=4)
    hplan = hu.make_hier_plan(hspec, tile_h=128)
    (q, r), s_q, s_r = _signed_params(hspec.levels[-1], 23, cuda)
    table = _random_table((4, hplan.padded_cols), 24, cuda)
    got, want = table.clone(), table.clone()
    for seed in (25, 26):
        items, freqs = _signed_block(hspec, 2000, seed)
        chunks = _chunks(hspec.levels[-1], hspec.level_items(2, items), cuda)
        f = torch.from_numpy(freqs).to(cuda)
        hu.hier_update_signed(hplan, got, chunks, f, q, r, s_q, s_r)
        hu.hier_update_signed_ref(hplan, want, chunks, f, q, r, s_q, s_r)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_k6_k8_int32_wraparound_matches_plain(cuda):
    hspec = _hspec(w=2)
    hplan = hu.make_hier_plan(hspec, tile_h=128)
    (q, r), s_q, s_r = _signed_params(hspec.levels[-1], 27, cuda)
    items, _ = _block(hspec, 1500, 28)
    freqs = np.full(1500, (1 << 24) - 1, np.int32)
    freqs[::2] *= -1
    f = torch.from_numpy(freqs).to(cuda)
    chunks = _chunks(hspec.levels[-1], hspec.level_items(2, items), cuda)
    for lo, hi in (((1 << 31) - (1 << 24), (1 << 31) - 1),
                   (-(1 << 31), -(1 << 31) + (1 << 24))):
        table = _random_table((2, hplan.padded_cols), 29, cuda, lo=lo, hi=hi)
        got = hu.hier_update_signed(hplan, table.clone(), chunks, f, q, r, s_q, s_r)
        want = hu.hier_update_signed_ref(hplan, table.clone(), chunks, f, q, r, s_q, s_r)
        assert torch.equal(got, want)
        assert bool(((got > 0) != (table > 0)).any())    # it did wrap
        plan = hplan.plan
        flat = table[:, : plan.table_size].contiguous()
        assert torch.equal(su.sketch_update_signed(plan, flat.clone(), chunks, f, q, r, s_q, s_r),
                           su.sketch_update_signed_ref(plan, flat.clone(), chunks, f, q, r,
                                                       s_q, s_r))


def test_k9_signed_grid_on_level_views_matches_plain(cuda):
    hspec = _hspec()
    kh = KernelHierarchy(hspec, _signed_params(hspec.levels[-1], 30, cuda), tile_h=128,
                          device=cuda, mode="signed")
    kh.table.copy_(_random_table(tuple(kh.table.shape), 31, cuda))
    kh._state_cache = None
    state = kh.cs_state()
    rng = np.random.default_rng(32)
    for level in range(hspec.n_levels):
        view = state.tables[level]
        mods = hh.level_modules(hspec.base, level - 1) if level else ()
        prefixes = (np.stack([rng.integers(0, hspec.base.schema.domains[m], 37,
                                           dtype=np.uint64).astype(np.uint32)
                              for m in mods], axis=1)
                    if level else np.zeros((1, 0), np.uint32))
        values = np.stack([rng.integers(0, hspec.base.schema.domains[m], 53,
                                        dtype=np.uint64).astype(np.uint32)
                           for m in hspec.base.partition[level]], axis=1)
        pp, cp, sp, sc = cs.candidate_signed_partials(hspec, state.params, level,
                                                      prefixes, values)
        n0 = _cuda.LAUNCHES["hier_query_signed"]
        got = hq.hier_candidate_query_signed(view, pp, cp, sp, sc)
        assert _cuda.LAUNCHES["hier_query_signed"] == n0 + 1
        assert got.dtype == torch.int32 and got.shape == (3, pp.shape[1], 53)
        assert torch.equal(got.to(torch.float32),
                           hq.hier_candidate_query_signed_ref(view, pp, cp, sp, sc))
        for max_batch in (None, 200):
            np.testing.assert_array_equal(
                cs.candidate_estimates(hspec, state, level, prefixes, values,
                                       use_kernel=True, max_batch=max_batch),
                cs.candidate_estimates(hspec, state, level, prefixes, values,
                                       max_batch=max_batch))


def test_signed_float32_tables_on_the_card_raise_item_14(cuda):
    hspec = _hspec()
    spec = hspec.levels[-1]
    params = _signed_params(spec, 33, cuda)
    items, freqs = _signed_block(hspec, 64, 34)
    ks = KernelSketch(spec, params, dtype=torch.float32, device=cuda, mode="signed")
    kh = KernelHierarchy(hspec, params, dtype=torch.float32, device=cuda, mode="signed")
    before = dict(_cuda.LAUNCHES)
    for call in (lambda: ks.update(items, freqs), lambda: ks.query_rows(items),
                 lambda: kh.update(items, freqs)):
        with pytest.raises(NotImplementedError, match="item 14"):
            call()
    state = kh.cs_state()
    values = items[:5, list(hspec.base.partition[0])]
    with pytest.raises(NotImplementedError, match="item 14"):
        cs.candidate_estimates(hspec, state, 0, np.zeros((1, 0), np.uint32), values,
                               use_kernel=True)
    assert dict(_cuda.LAUNCHES) == before


def test_signed_path_kernel_equals_plain_on_card(cuda):
    hspec = _hspec(w=4)
    params = _signed_params(hspec.levels[-1], 35, cuda)
    kh = KernelHierarchy(hspec, params, tile_h=128, block_b=700, device=cuda,
                         mode="signed")
    plain = cs.init_hierarchy(hspec, params, dtype=torch.int32, device=cuda)
    ks = KernelSketch(hspec.base, params, device=cuda, mode="signed")
    flat = cs.init_state(hspec.base, params, dtype=torch.int32, device=cuda)
    _cuda.reset_launches()
    for seed in (36, 37):
        items, freqs = _signed_block(hspec, 2000, seed)
        kh.update(items, freqs)
        ks.update(items, freqs)
        plain = cs.hier_update(hspec, plain, items, freqs)
        flat = cs.update(hspec.base, flat, items, freqs)
    for a, b in zip(kh.cs_state().tables, plain.tables):
        assert torch.equal(a, b)
    assert torch.equal(ks.cs_state().table, flat.table)
    rows, med = cs.query_rows(hspec.base, flat, items[:300])
    assert torch.equal(torch.from_numpy(ks.query_rows(items[:300])).float(), rows.cpu())
    np.testing.assert_array_equal(ks.query(items[:300]), med.cpu().numpy())
    cands = [np.unique(items[:, list(g)], axis=0) for g in hspec.base.partition]
    thr = 0.002 * np.abs(freqs).sum()
    got = cs.find_heavy_hitters(hspec, kh.cs_state(), thr, cands, use_kernel=True,
                                max_batch=4096)
    want = cs.find_heavy_hitters(hspec, plain, thr, cands, max_batch=4096)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert all(_cuda.LAUNCHES[k] > 0 for k in (
        "sketch_update_signed", "sketch_query_signed", "hier_update_signed",
        "hier_query_signed"))


# --------------------------------------------------------------------------
# K5 / K5i: the conservative fold, on both residency routes
# --------------------------------------------------------------------------

def _cons_table(shape, dtype, seed, device):
    """Cells near 2^31 on int32 tables (min + f wraps), small on float32."""
    if dtype == torch.int32:
        return _random_table(shape, seed, device, lo=(1 << 31) - (1 << 22),
                             hi=(1 << 31) - (1 << 20))
    return _random_table(shape, seed, device, lo=0, hi=1 << 20).to(dtype)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("w,ranges,route", [(3, (16, 9, 7), "shared"),
                                            (3, (48, 90, 7), "global"),
                                            (40, (6, 5, 3), "shared")])
def test_k5_conservative_update_matches_plain(cuda, monkeypatch, dtype, w, ranges,
                                              route):
    schema = KeySchema(domains=(1 << 32, 256, 1000, 4096))
    spec = sk.mod_sketch_spec(schema, [(1, 2), (0,), (3,)], ranges, w)
    hspec = hh.HierarchySpec.from_spec(spec)
    plan = make_plan(spec)
    params = _params(spec, 30, cuda)
    h_pad = su.padded_table_size(spec.table_size, 128)
    assert scu.residency(w, h_pad, 4) == route
    items, freqs = _block(hspec, 3000, 31)
    freqs = freqs * 64                                # large enough to wrap
    chunks = spec.schema.module_chunks(torch.from_numpy(items.astype(np.int64)).to(cuda))
    f = torch.from_numpy(freqs).to(cuda)
    base = _cons_table((w, h_pad), dtype, 32, cuda)
    n0 = _cuda.LAUNCHES["sketch_update_conservative"]
    got = scu.sketch_update_conservative(plan, base.clone(), chunks, f, params.q, params.r)
    want = scu.sketch_update_conservative_ref(plan, base.clone(), chunks, f, params.q,
                                              params.r)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["sketch_update_conservative"] == n0 + 1
    assert torch.equal(got, want)
    assert not torch.equal(got, base)
    if route == "shared":                             # the global route agrees
        monkeypatch.setattr(scu, "residency", lambda *args, **kw: "global")
        again = scu.sketch_update_conservative(plan, base.clone(), chunks, f,
                                               params.q, params.r)
        assert torch.equal(again, want)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_k5i_folds_every_level_in_one_launch(cuda, dtype):
    hspec = _hspec(w=4)
    params = _params(hspec.levels[-1], 33, cuda)
    state = hh.init_hierarchy(hspec, params, dtype=dtype, device=cuda)
    for st, seed in zip(state.states, (34, 35, 36)):
        st.table.copy_(_cons_table(tuple(st.table.shape), dtype, seed, cuda))
    routes = [scu.residency(4, st.table.shape[1], 4) for st in state.states]
    assert "shared" in routes and "global" in routes
    items, freqs = _block(hspec, 4000, 37)
    idxs = hh.hierarchy_indices(hspec, params, items)
    f = torch.from_numpy(freqs * 64).to(cuda)
    got = [st.table.clone() for st in state.states]
    want = [st.table.clone() for st in state.states]
    n0 = _cuda.LAUNCHES["conservative_fold"]
    scu.conservative_fold_tables(got, idxs, f)
    scu.conservative_fold_tables_ref(want, idxs, f)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["conservative_fold"] == n0 + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the hierarchy's in-place fold is the same launch
    hh.update_conservative_jit(hspec, state, items, freqs * 64)
    assert _cuda.LAUNCHES["conservative_fold"] == n0 + 2
    for st, b in zip(state.states, want):
        assert torch.equal(st.table, b)


def test_conservative_wrappers_refuse_what_they_do_not_take(cuda):
    spec = _hspec().levels[-1]
    plan = make_plan(spec)
    params = _params(spec, 38, cuda)
    items, freqs = _block(_hspec(), 64, 39)
    chunks = spec.schema.module_chunks(torch.from_numpy(items.astype(np.int64)).to(cuda))
    f = torch.from_numpy(freqs).to(cuda)
    h_pad = su.padded_table_size(spec.table_size, 128)
    with pytest.raises(ValueError, match="int32 or float32 tables"):
        scu.sketch_update_conservative(
            plan, torch.zeros((spec.width, h_pad), dtype=torch.int64, device=cuda),
            chunks, f, params.q, params.r)
    table = torch.zeros((spec.width, h_pad), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="do not match"):
        scu.sketch_update_conservative(plan, table, chunks, f[:10], params.q, params.r)
    idx = torch.zeros((spec.width, 64), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="table 1 is not"):
        scu.conservative_fold_tables([table, table.float()], [idx, idx], f)
    with pytest.raises(ValueError, match="contiguous int64"):
        scu.conservative_fold_tables([table], [idx.to(torch.int32)], f)


def test_conservative_paths_equal_plain_paths_on_card(cuda):
    wl = zipf_hh_workload(n_src=300, n_tgt=600, n_edges=3000, n_occurrences=30_000,
                          seed=4)
    spec = sk.mod_sketch_spec(wl.stream.schema, [(0,), (1,)], (64, 32), 3)
    params = _params(spec, 40, "cpu")
    ep_k = SketchTopKEndpoint(spec, params, max_candidates_per_group=150,
                              use_kernel=True, mode="conservative", device=cuda)
    ep_p = SketchTopKEndpoint(spec, params, max_candidates_per_group=150,
                              mode="conservative", device="cpu")
    eng = SketchServeEngine(ep_k)
    ks_k = KernelSketch(spec, params, mode="conservative", device=cuda, block_b=700)
    ks_p = KernelSketch(spec, params, mode="conservative", device="cpu", block_b=700)
    n0 = dict(_cuda.LAUNCHES)
    for s in range(0, wl.stream.items.shape[0], 1000):
        blk = (wl.stream.items[s:s + 1000], wl.stream.freqs[s:s + 1000])
        eng.ingest(*blk)
        ep_p.ingest(*blk)
        ks_k.update(*blk)
        ks_p.update(*blk)
    assert _cuda.LAUNCHES["conservative_fold"] > n0["conservative_fold"]
    assert _cuda.LAUNCHES["sketch_update_conservative"] > n0["sketch_update_conservative"]
    sd_k, sd_p = ep_k.state_dict(), ep_p.state_dict()
    for key in sd_p:
        assert np.array_equal(sd_k[key], sd_p[key]), key
    thr = wl.stream.total // 200
    for a, b in ((eng.heavy_hitters(thr), ep_p.heavy_hitters(thr)),
                 (eng.topk(10), ep_p.topk(10))):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert torch.equal(ks_k.table.cpu(), ks_p.table)
    q = wl.stream.items[:500]
    assert np.array_equal(ks_k.query(q), ks_p.query(q))
