"""The port's CUDA kernels (K1-K9, K5i, K7m, K9m, the float32 folds K1f,
K3f, K6f, K8f and the float32 grid K4f) against their plain PyTorch
versions.

Needs a CUDA card: every test skips without one (``-m gpu`` selects them
on a machine that has one).  Inputs are made with numpy from a seed.  On
int32 tables, and on float32 tables fed integer-valued values (every
partial sum exact), the tolerance is exact equality; float32 tables fed
Gaussian values agree within rtol 1e-5 of the table's scale, since float
atomics add in any order.  The conservative folds (K5, K5i) add in stream
order, so they equal their plain versions exactly on float32 tables fed
non-integer values too.  Each kernel is
compared with its plain version on the same card and the same inputs, at
small shapes that still cover joint groups, multi-chunk modules,
duplicate keys, zero-frequency rows, level widths that are not tile
multiples, int32 wraparound, negative (turnstile) frequencies, strided
level views, and both residency routes of the conservative fold (K5, K5i;
also on blocks of long and short runs of a few keys, or of one key) and
of the hierarchy folds (K3, K3f, K8, K8f) on int32 and float32 tables;
the flat fold (K1, K1f, the hierarchy body's one-level case) at spans of
1 and 64 tiles, w = 1, 5 and 9, on blocks of mixed keys, of one source
and of one key;
the candidate-grid queries (K4, K9, K9m, and K4f on float32 tables of
finite non-negative values) on both routes for w = 1-9, on views whose
windows start unaligned; the flat point queries (K2, K7, K7m)
for w = 1-9 with keys' chunks in registers and not, at one lane a query
and one a row, on tables holding INT_MAX, INT_MIN and zeros.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree as tr
from repro_torch.configs import ARCHS, get_reduced
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
from repro_torch.kernels.hashes import all_indices, all_sign_bits, make_plan
from repro_torch.kernels.ops import KernelHierarchy, KernelSketch
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
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


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _all_global(monkeypatch, hplan, w, n, device):
    """Force a hierarchy fold's other route (K3, K3f, K8, K8f): the same kernel with every level on
    global atomics."""
    geometry = hu.fold_geometry(hplan, w, n, 4, _sms(device), shared_bytes=0)
    assert not any(geometry.shared)
    monkeypatch.setattr(hu, "fold_geometry", lambda *args, **kw: geometry)


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


def _flat_spec(w):
    """A flat sketch of 62 x 66 = 4,092 cells a row (the accuracy path's
    mod-sketch) over a two-module 32-bit key, padded to 4,096."""
    return sk.mod_sketch_spec(KeySchema(domains=(1 << 32, 1 << 32)), [(0,), (1,)],
                              (62, 66), w)


def _flat_block(case, n, seed):
    """Items and int32 frequencies: random keys with heavy duplication
    ("mixed"), the same with every key of one source ("one_source"), or one
    key; every fifth frequency zero."""
    rng = np.random.default_rng(seed)
    items = rng.integers(0, 1 << 32, (n, 2), dtype=np.uint64).astype(np.uint32)
    items[n // 10 : n // 4] = items[0]
    if case == "one_source":
        items[:, 0] = items[0, 0]
    freqs = rng.integers(0, 1 << 12, n).astype(np.int32)
    freqs[::5] = 0
    if n == 1:
        freqs[:] = 7
    return items, freqs


def _force_deal(monkeypatch, n, span, ctas=None):
    """Force K1/K1f's spans of ``span`` tiles, one CTA a span unless ``ctas``
    is given."""
    deal = (-(-n // (hu.THREADS * span)) if ctas is None else ctas, span)
    monkeypatch.setattr(su, "flat_deal", lambda *args: deal)


@pytest.mark.parametrize("case,n", [("mixed", 5003), ("one_source", 5003), ("one_key", 1)])
@pytest.mark.parametrize("w", [1, 5, 9])
@pytest.mark.parametrize("span", [1, 64])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_k1_k1f_match_plain(cuda, monkeypatch, dtype, span, w, case, n):
    """K1 (int32) and K1f (float32, integer values: every partial sum
    exact) bit for bit with the plain fold on a random table."""
    spec = _flat_spec(w)
    plan = make_plan(spec)
    params = _params(spec, 80 + w, cuda)
    h_pad = su.padded_table_size(spec.table_size, 512)
    items, freqs = _flat_block(case, n, 81)
    chunks = _chunks(spec, items, cuda)
    f = torch.from_numpy(freqs).to(cuda, dtype)
    base = _random_table((w, h_pad), 82, cuda).to(dtype)
    _force_deal(monkeypatch, n, span)
    name = "sketch_update" if dtype == torch.int32 else "sketch_update_f32"
    n0 = _cuda.LAUNCHES[name]
    got = su.sketch_update(plan, base.clone(), chunks, f, params.q, params.r)
    want = su.sketch_update_ref(plan, base.clone(), chunks, f, params.q, params.r)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[name] == n0 + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("ctas,span", [(0, 1), (1, 0)])
def test_k1_refuses_a_launch_it_cannot_make(cuda, monkeypatch, ctas, span):
    """A launch of no CTAs or of empty spans is refused by the launcher and
    raised on: nothing falls back to the plain fold."""
    spec = _flat_spec(5)
    plan = make_plan(spec)
    params = _params(spec, 90, cuda)
    items, freqs = _flat_block("mixed", 300, 91)
    f = torch.from_numpy(freqs).to(cuda)
    table = torch.zeros((5, 4096), dtype=torch.int32, device=cuda)
    _force_deal(monkeypatch, 300, span, ctas)
    n0 = _cuda.LAUNCHES["sketch_update"]
    with pytest.raises(RuntimeError, match="failed to launch"):
        su.sketch_update(plan, table, _chunks(spec, items, cuda), f, params.q, params.r)
    assert not bool(table.any())
    assert _cuda.LAUNCHES["sketch_update"] == n0


@pytest.mark.parametrize("route", ["rule", "global"])
def test_k3_fused_hierarchy_update_matches_plain(cuda, monkeypatch, route):
    hspec = _hspec()
    hplan = hu.make_hier_plan(hspec, tile_h=128)
    params = _params(hspec.levels[-1], 3, cuda)
    table = _random_table((hspec.base.width, hplan.padded_cols), 4, cuda)
    got, want = table.clone(), table.clone()
    if route == "global":
        _all_global(monkeypatch, hplan, hspec.base.width, 2000, cuda)
    else:
        assert any(hu.fold_geometry(hplan, hspec.base.width, 2000, 4, _sms(cuda)).shared)
    n0 = _cuda.LAUNCHES["hier_update"]
    for seed in (5, 6):                               # multiple blocks
        items, freqs = _block(hspec, 2000, seed)
        ordered = hspec.level_items(hspec.n_levels - 1, items)
        chunks = hspec.levels[-1].schema.module_chunks(
            torch.from_numpy(ordered.astype(np.int64)).to(cuda))
        f = torch.from_numpy(freqs).to(cuda)
        hu.hier_update(hplan, got, chunks, f, params.q, params.r)
        hu.hier_update_ref(hplan, want, chunks, f, params.q, params.r)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["hier_update"] == n0 + 2
    assert torch.equal(got, want)


@pytest.mark.parametrize("route", ["rule", "global"])
def test_k1_k3_int32_wraparound_matches_plain(cuda, monkeypatch, route):
    """K3 on its rule's route or all global, and K1 into level 1's flat
    sketch (2 x 4,352 cells): int32 sums that wrap, bit for bit."""
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
    if route == "global":
        _all_global(monkeypatch, hplan, 2, 1500, cuda)
    else:
        assert hu.fold_geometry(hplan, 2, 1500, 4, _sms(cuda)).shared == (True, True, False)
    got = hu.hier_update(hplan, table.clone(), chunks, f, params.q, params.r)
    want = hu.hier_update_ref(hplan, table.clone(), chunks, f, params.q, params.r)
    assert torch.equal(got, want)
    assert int(got.min()) < 0                         # it did wrap

    spec = hspec.levels[1]
    plan = make_plan(spec)
    lparams = _params(spec, 10, cuda)
    h_pad = su.padded_table_size(spec.table_size, 128)
    flat = _random_table((2, h_pad), 11, cuda, lo=(1 << 31) - (1 << 24), hi=(1 << 31) - 1)
    lchunks = _chunks(spec, hspec.level_items(1, items), cuda)
    got = su.sketch_update(plan, flat.clone(), lchunks, f, lparams.q, lparams.r)
    want = su.sketch_update_ref(plan, flat.clone(), lchunks, f, lparams.q, lparams.r)
    assert torch.equal(got, want)
    assert int(got.min()) < 0


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("tile_h", [128, 1])
@pytest.mark.parametrize("order,n", [("shuffled", 5003), ("sorted", 5003),
                                     ("one_cell", 5003), ("sorted", 100),
                                     ("shuffled", 1000), ("one_cell", 256)])
def test_k3_k3f_both_routes_match_plain(cuda, monkeypatch, dtype, tile_h, order, n):
    """K3 and K3f on the rule's route (two coarse levels in shared memory
    at 5,003, 1,000 and 256 keys, level 0 alone at 100, below one CTA's
    tile) and on the all-global route, each against the plain fold:
    skewed, sorted and single-cell blocks (every key on one level-0 cell,
    as a heavy source's run on the main path) with duplicate keys and
    zero-frequency rows, n a multiple of the tile or not, padded and
    unpadded levels.  Integer values: exact on both table types."""
    hspec = _hspec(w=4)
    hplan = hu.make_hier_plan(hspec, tile_h=tile_h)
    params = _params(hspec.levels[-1], 80, cuda)
    items, freqs = _skewed_block(hspec, n, 81, order)
    freqs = np.abs(freqs) % (4096 if dtype == torch.int32 else 1024)
    freqs[: n // 7] = 0                               # a zero stretch, whole warps
    chunks = _chunks(hspec.levels[-1], hspec.level_items(2, items), cuda)
    base = (_random_table((4, hplan.padded_cols), 82, cuda) if dtype == torch.int32
            else torch.zeros((4, hplan.padded_cols), device=cuda))
    f = torch.from_numpy(freqs.astype(np.int32)).to(cuda, dtype)
    rule = hu.fold_geometry(hplan, 4, n, 4, _sms(cuda))
    assert rule.shared == ((True, True, False) if n > 100 else (True, False, False))
    name = "hier_update" + ("_f32" if dtype == torch.float32 else "")
    n0 = _cuda.LAUNCHES[name]
    want = hu.hier_update_ref(hplan, base.clone(), chunks, f, params.q, params.r)
    got = hu.hier_update(hplan, base.clone(), chunks, f, params.q, params.r)
    _all_global(monkeypatch, hplan, 4, n, cuda)
    again = hu.hier_update(hplan, base.clone(), chunks, f, params.q, params.r)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[name] == n0 + 2
    assert torch.equal(got, want) and torch.equal(again, want)
    assert not torch.equal(got, base)


def test_k3_sorted_block_on_one_level0_cell_matches_plain(cuda, monkeypatch):
    """The main path's spec (ranges 4,096 x 4,096, w = 4, one 65,536-row
    block) with every key of one source, as the stream's heaviest block
    nearly is: every lane of every warp adds to one level-0 cell a row."""
    schema = KeySchema(domains=(1 << 32, 1 << 32))
    hspec = hh.HierarchySpec.from_spec(
        sk.mod_sketch_spec(schema, [(0,), (1,)], (4096, 4096), 4))
    hplan = hu.make_hier_plan(hspec)
    params = _params(hspec.levels[-1], 83, cuda)
    rng = np.random.default_rng(84)
    n = 1 << 16
    items = np.stack([np.full(n, 123456789, np.uint32),
                      np.sort(rng.integers(0, 1 << 32, n, dtype=np.uint64)).astype(
                          np.uint32)], axis=1)
    freqs = rng.integers(1, 300, n).astype(np.int32)
    chunks = _chunks(hspec.levels[-1], hspec.level_items(1, items), cuda)
    f = torch.from_numpy(freqs).to(cuda)
    rule = hu.fold_geometry(hplan, 4, n, 4, _sms(cuda))
    assert rule.shared == (True, False) and rule.shared_bytes == 4 * 4096 * 4
    base = _random_table((4, hplan.padded_cols), 85, cuda)
    want = hu.hier_update_ref(hplan, base.clone(), chunks, f, params.q, params.r)
    got = hu.hier_update(hplan, base.clone(), chunks, f, params.q, params.r)
    _all_global(monkeypatch, hplan, 4, n, cuda)
    again = hu.hier_update(hplan, base.clone(), chunks, f, params.q, params.r)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, want)
    level0 = (want - base)[:, : hplan.level_pads[0]]
    assert int((level0 != 0).sum()) == 4              # one cell a row took it all


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
    with pytest.raises(ValueError, match="takes int32 tables"):
        sq.sketch_query(plan, torch.zeros((spec.width, h_pad), device=cuda),
                        chunks, params.q, params.r)
    with pytest.raises(ValueError, match="int32 or float32"):
        su.sketch_update(plan, torch.zeros((spec.width, h_pad), dtype=torch.int64,
                                           device=cuda), chunks, f, params.q, params.r)
    table = torch.zeros((spec.width, h_pad), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="is on cpu"):
        su.sketch_update(plan, table, chunks.cpu(), f, params.q, params.r)
    with pytest.raises(ValueError, match="int64"):
        sq.sketch_query(plan, table, chunks.to(torch.int32), params.q, params.r)
    with pytest.raises(ValueError, match="takes int32 tables"):
        hq.hier_candidate_query(table.float(), chunks[:2, :1].T.contiguous(),
                                chunks[:2, :1].T.contiguous())


@pytest.mark.parametrize("dtype,error,match", [
    (torch.float64, ValueError, "takes int32 tables"),
    (torch.int64, ValueError, "takes int32 tables"),
])
def test_kernel_descent_refuses_tables_k4_does_not_take(cuda, dtype, error, match):
    """float32 tables go to K4f (tests below); any other dtype but int32 is
    refused on the card, and nothing is launched."""
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
    with pytest.raises(ValueError, match="takes float32 tables"):
        hq.hier_candidate_query_f32(state.states[0].table, torch.zeros(
            (hspec.base.width, 1), dtype=torch.int64, device=cuda), torch.zeros(
            (hspec.base.width, 1), dtype=torch.int64, device=cuda))


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


def _many_chunks_hspec(w=3):
    """Keys of 10 chunks, more than the folds hold in registers."""
    schema = KeySchema(domains=(1 << 32,) * 5)
    return hh.HierarchySpec.from_spec(
        sk.mod_sketch_spec(schema, [(0, 1), (2,), (3, 4)], (40, 9, 11), w))


# The signed flat fold's (K6, K6f) blocks: "mixed" is _signed_block's (a
# third of the values negative, duplicate keys, a zero-frequency tail), at
# one key, around one CTA's 256 keys and just past 256 CTAs; then an
# all-zero block, every value negative, and keys of 10 chunks, which hash
# from the chunk array.
K6_CASES = [("mixed", 3000), ("mixed", 1), ("mixed", 255), ("mixed", 257),
            ("mixed", 65537), ("zeros", 3000), ("negative", 3000), ("many_chunks", 3001)]


def _k6_block(case, n, seed, w=3):
    """The hierarchy spec, items and int32 values of a K6_CASES case."""
    hspec = _many_chunks_hspec(w) if case == "many_chunks" else _hspec(w)
    items, freqs = _signed_block(hspec, n, seed)
    if case == "zeros":
        freqs[:] = 0
    elif case == "negative":
        freqs = -np.abs(freqs) - 1
    elif n < 8:                      # the zero tail would take every key
        freqs[:] = -5
    return hspec, items, freqs


@pytest.mark.parametrize("case,n", K6_CASES)
def test_k6_k7_signed_flat_sketch_match_plain(cuda, case, n):
    hspec, items, freqs = _k6_block(case, n, 21)
    spec = hspec.levels[-1]
    plan = make_plan(spec)
    p = _signed_params(spec, 20, cuda)
    (q, r), s_q, s_r = p
    h_pad = su.padded_table_size(spec.table_size, 128)
    chunks = _chunks(spec, items, cuda)
    f = torch.from_numpy(freqs).to(cuda)
    base = _random_table((spec.width, h_pad), 22, cuda)
    n0 = _cuda.LAUNCHES["sketch_update_signed"]
    got = su.sketch_update_signed(plan, base.clone(), chunks, f, q, r, s_q, s_r)
    want = su.sketch_update_signed_ref(plan, base.clone(), chunks, f, q, r, s_q, s_r)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["sketch_update_signed"] == n0 + 1
    assert torch.equal(got, want)
    assert torch.equal(got, base) == (case == "zeros")

    n0 = _cuda.LAUNCHES["sketch_query_signed"]
    rows = sq.sketch_query_signed(plan, got, chunks, q, r, s_q, s_r)
    assert _cuda.LAUNCHES["sketch_query_signed"] == n0 + 1
    assert rows.dtype == torch.int32 and rows.shape == (spec.width, n)
    assert torch.equal(rows, sq.sketch_query_signed_ref(plan, got, chunks, q, r, s_q, s_r))


# --------------------------------------------------------------------------
# K2, K7, K7m: the flat point queries' lane
# --------------------------------------------------------------------------

INT_MIN, INT_MAX = -(1 << 31), (1 << 31) - 1


def _point_case(w, n, chunks, seed, device):
    """A flat spec of w rows over keys of 5 chunks (K2, K7 and K7m hold
    them in registers) or of 10 (read from the chunk array), n query keys,
    bucket and sign params, and an int32 table over the whole int32 range
    with INT_MAX, INT_MIN and zeros planted: an INT_MIN cell under sign -1
    wraps to INT_MIN in the kernels and in their plain versions alike."""
    hspec = _many_chunks_hspec(w) if chunks == "array" else _hspec(w)
    spec = hspec.levels[-1]
    plan = make_plan(spec)
    assert (plan.total_chunks <= 8) == (chunks == "registers")   # hashes.cuh kRegChunks
    params = _signed_params(spec, seed, device)
    items, _ = _signed_block(hspec, max(n, 1), seed + 1)
    qchunks = _chunks(spec, items[:n], device)
    rng = np.random.default_rng(seed + 2)
    shape = (w, su.padded_table_size(spec.table_size, 128))
    cells = rng.integers(INT_MIN, INT_MAX, shape, dtype=np.int64, endpoint=True)
    planted = rng.random(shape)
    cells[planted < 0.1] = INT_MAX
    cells[(planted >= 0.1) & (planted < 0.2)] = INT_MIN
    cells[(planted >= 0.2) & (planted < 0.3)] = 0
    table = torch.from_numpy(cells.astype(np.int32)).to(device)
    return plan, table, qchunks, (params.base.q, params.base.r, params.sign_q, params.sign_r)


POINT_QUERIES = ("sketch_query", "sketch_query_signed", "sketch_query_signed_median")


def _force_lanes(monkeypatch, lanes):
    """K2/K7/K7m's lanes a query forced: "one" lane, the "max" (w rounded up
    to a power of two), or the "rule"'s own pick."""
    if lanes == "one":
        monkeypatch.setattr(sq, "point_lanes", lambda w, n, sms: 1)
    elif lanes == "max":
        monkeypatch.setattr(sq, "point_lanes", lambda w, n, sms: sq.max_lanes(w))


@pytest.mark.parametrize("lanes", ["rule", "one", "max"])
@pytest.mark.parametrize("chunks", ["registers", "array"])
@pytest.mark.parametrize("w", range(1, 10))
def test_k2_k7_k7m_match_plain_for_every_w(cuda, monkeypatch, w, chunks, lanes):
    """w = 1-8 run unrolled, 9 the runtime loop; one lane a query and one a
    row; Q = 0 (no launch), 1, 257 (not a multiple of the CTA's 256
    queries) and 5,003.  K7m also equals median_rows of K7's rows bit for
    bit."""
    _force_lanes(monkeypatch, lanes)
    for n in (0, 1, 257, 5003):
        plan, table, qchunks, (q, r, s_q, s_r) = _point_case(w, n, chunks, 90 + w, cuda)
        n0 = dict(_cuda.LAUNCHES)
        est = sq.sketch_query(plan, table, qchunks, q, r)
        rows = sq.sketch_query_signed(plan, table, qchunks, q, r, s_q, s_r)
        med = sq.sketch_query_signed_median(plan, table, qchunks, q, r, s_q, s_r)
        for name in POINT_QUERIES:
            assert _cuda.LAUNCHES[name] == n0[name] + (n > 0)
        assert est.dtype == torch.int32 and est.shape == (n,)
        assert torch.equal(est, sq.sketch_query_ref(plan, table, qchunks, q, r))
        assert rows.dtype == torch.int32 and rows.shape == (w, n)
        assert torch.equal(rows, sq.sketch_query_signed_ref(plan, table, qchunks, q, r,
                                                            s_q, s_r))
        assert med.dtype == torch.float32 and med.shape == (n,)
        assert torch.equal(med.view(torch.int32), cs.median_rows(rows).view(torch.int32))
        assert torch.equal(med.view(torch.int32), sq.sketch_query_signed_median_ref(
            plan, table, qchunks, q, r, s_q, s_r).view(torch.int32))
        if n == 5003:
            cells = torch.gather(table, 1, all_indices(plan, qchunks, q, r))
            bits = all_sign_bits(plan, qchunks, s_q, s_r) >> (len(plan.ranges) - 1)
            for v in (INT_MAX, INT_MIN, 0):
                assert bool((cells == v).any())
            assert bool(((cells == INT_MIN) & (bits & 1 == 1)).any())


@pytest.mark.parametrize("w,lanes", [(4, 3), (2, 4), (9, 2), (5, 16)])
def test_point_queries_refuse_a_lane_count_they_cannot_take(cuda, monkeypatch, w, lanes):
    """Lanes that are not a power of two up to w's are refused by the
    launcher and raised on: nothing falls back to the plain version."""
    plan, table, qchunks, (q, r, s_q, s_r) = _point_case(w, 300, "registers", 95, cuda)
    monkeypatch.setattr(sq, "point_lanes", lambda *args: lanes)
    n0 = dict(_cuda.LAUNCHES)
    for call in (lambda: sq.sketch_query(plan, table, qchunks, q, r),
                 lambda: sq.sketch_query_signed(plan, table, qchunks, q, r, s_q, s_r),
                 lambda: sq.sketch_query_signed_median(plan, table, qchunks, q, r, s_q, s_r)):
        with pytest.raises(RuntimeError, match="failed to launch"):
            call()
    assert dict(_cuda.LAUNCHES) == n0


def test_flat_queries_launch_k7m_for_signed_estimates_and_k2_for_minima(cuda):
    """Signed ``query()`` on an int32 table takes one K7m launch and no K7
    launch; ``query_rows()`` one K7 launch, whose rows' median is the
    estimate bit for bit; linear and conservative ``query()`` one K2 launch
    each.  Every answer equals the plain path's."""
    hspec = _hspec(w=4)
    spec = hspec.levels[-1]
    params = _signed_params(spec, 80, cuda)
    items, freqs = _signed_block(hspec, 3000, 81)
    queries = items[:700]
    ks = KernelSketch(spec, params, tile_h=128, device=cuda, mode="signed")
    ks.update(items, freqs)
    n0 = dict(_cuda.LAUNCHES)
    est = ks.query(queries)
    n1 = dict(_cuda.LAUNCHES)
    rows = ks.query_rows(queries)
    n2 = dict(_cuda.LAUNCHES)
    assert n1["sketch_query_signed_median"] == n0["sketch_query_signed_median"] + 1
    assert n1["sketch_query_signed"] == n0["sketch_query_signed"]
    assert n2["sketch_query_signed"] == n1["sketch_query_signed"] + 1
    assert n2["sketch_query_signed_median"] == n1["sketch_query_signed_median"]
    assert est.dtype == np.float32 and est.shape == (700,)
    np.testing.assert_array_equal(
        cs.median_rows(torch.from_numpy(rows)).numpy().view(np.int32), est.view(np.int32))
    plain = cs.update(spec, cs.init_state(spec, params, dtype=torch.int32, device=cuda),
                      items, freqs)
    np.testing.assert_array_equal(est, cs.query(spec, plain, queries).cpu().numpy())
    for mode in ("linear", "conservative"):
        kl = KernelSketch(spec, params.base, tile_h=128, device=cuda, mode=mode)
        kl.update(items, np.abs(freqs))
        n0 = dict(_cuda.LAUNCHES)
        got = kl.query(queries)
        assert _cuda.LAUNCHES["sketch_query"] == n0["sketch_query"] + 1
        np.testing.assert_array_equal(
            got, sq.sketch_query_ref(kl.plan, kl.table, _chunks(spec, queries, cuda),
                                     kl.params.q, kl.params.r).cpu().numpy())


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


@pytest.mark.parametrize("case,n", [("mixed", 1500)] + K6_CASES[1:])
def test_k6_k8_int32_wraparound_matches_plain(cuda, monkeypatch, case, n):
    """Values of magnitude 2^24 - 1 (alternating signs, "mixed"; all
    negative; all zero) into tables within 2^24 of either int32 limit: both
    folds wrap as the plain ones do, on both routes of K8."""
    hspec = _many_chunks_hspec(w=2) if case == "many_chunks" else _hspec(w=2)
    hplan = hu.make_hier_plan(hspec, tile_h=128)
    (q, r), s_q, s_r = _signed_params(hspec.levels[-1], 27, cuda)
    items, _ = _block(hspec, n, 28)
    freqs = np.full(n, (1 << 24) - 1, np.int32)
    if case == "negative":
        freqs *= -1
    else:
        freqs[::2] *= -1
    freqs *= case != "zeros"
    f = torch.from_numpy(freqs).to(cuda)
    chunks = _chunks(hspec.levels[-1], hspec.level_items(hspec.n_levels - 1, items), cuda)
    if (case, n) == ("mixed", 1500):
        assert hu.fold_geometry(hplan, 2, 1500, 4, _sms(cuda)).shared == (True, True, False)
    for lo, hi in (((1 << 31) - (1 << 24), (1 << 31) - 1),
                   (-(1 << 31), -(1 << 31) + (1 << 24))):
        table = _random_table((2, hplan.padded_cols), 29, cuda, lo=lo, hi=hi)
        got = hu.hier_update_signed(hplan, table.clone(), chunks, f, q, r, s_q, s_r)
        want = hu.hier_update_signed_ref(hplan, table.clone(), chunks, f, q, r, s_q, s_r)
        assert torch.equal(got, want)
        if n >= 255 and case != "zeros":
            assert bool(((got > 0) != (table > 0)).any())    # it did wrap
        with monkeypatch.context() as m:                  # and on the global route
            _all_global(m, hplan, 2, 1500, cuda)
            again = hu.hier_update_signed(hplan, table.clone(), chunks, f, q, r, s_q, s_r)
        assert torch.equal(again, want)
        plan = hplan.plan
        flat = table[:, : plan.table_size].contiguous()
        got = su.sketch_update_signed(plan, flat.clone(), chunks, f, q, r, s_q, s_r)
        want = su.sketch_update_signed_ref(plan, flat.clone(), chunks, f, q, r, s_q, s_r)
        assert torch.equal(got, want)
        if n >= 255 and case != "zeros":
            assert bool(((got > 0) != (flat > 0)).any())     # K6 wrapped too


def _skewed_block(hspec, n, seed, order):
    """A turnstile-like block: level 0's group (modules 1 and 2) drawn from
    40 prefixes, zipf-skewed, in stream order ("shuffled"), sorted by prefix
    ("sorted"), or every key on one level-0 cell ("one_cell")."""
    items, freqs = _signed_block(hspec, n, seed)
    heavy = np.minimum(np.random.default_rng(seed + 1).zipf(1.3, n), 40) - 1
    items[:, 1], items[:, 2] = heavy, heavy * 7 % 1000
    if order == "sorted":
        perm = np.lexsort((items[:, 2], items[:, 1]))
        items, freqs = items[perm], freqs[perm]
    elif order == "one_cell":
        items[:, 1], items[:, 2] = 5, 17
    return items, freqs


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("tile_h", [128, 1])
@pytest.mark.parametrize("order,n", [("shuffled", 5003), ("sorted", 5003),
                                     ("one_cell", 5003), ("sorted", 100)])
def test_k8_k8f_both_routes_match_plain(cuda, monkeypatch, dtype, tile_h, order, n):
    """K8 and K8f on the rule's route (the coarse levels in shared memory;
    two of them at 5,003 keys, level 0 alone at 100, below one CTA's tile)
    and on the all-global route, each against the plain fold: skewed,
    sorted and single-cell blocks with duplicate keys, deletions and
    zero-frequency rows, n not a multiple of the tile, padded and unpadded
    levels.  Integer values: exact on both table types."""
    hspec = _hspec(w=4)
    hplan = hu.make_hier_plan(hspec, tile_h=tile_h)
    (q, r), s_q, s_r = _signed_params(hspec.levels[-1], 60, cuda)
    items, freqs = _skewed_block(hspec, n, 61, order)
    chunks = _chunks(hspec.levels[-1], hspec.level_items(2, items), cuda)
    if dtype == torch.int32:
        base = _random_table((4, hplan.padded_cols), 62, cuda)
    else:                            # every partial sum an integer below 2^24
        base = torch.zeros((4, hplan.padded_cols), device=cuda)
        freqs = np.sign(freqs) * (np.abs(freqs) % 256)
    f = torch.from_numpy(freqs.astype(np.int32)).to(cuda, dtype)
    rule = hu.fold_geometry(hplan, 4, n, 4, _sms(cuda))
    assert rule.shared == ((True, True, False) if n > 1000 else (True, False, False))
    name = "hier_update_signed" + ("_f32" if dtype == torch.float32 else "")
    n0 = _cuda.LAUNCHES[name]
    want = hu.hier_update_signed_ref(hplan, base.clone(), chunks, f, q, r, s_q, s_r)
    got = hu.hier_update_signed(hplan, base.clone(), chunks, f, q, r, s_q, s_r)
    _all_global(monkeypatch, hplan, 4, n, cuda)
    again = hu.hier_update_signed(hplan, base.clone(), chunks, f, q, r, s_q, s_r)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[name] == n0 + 2
    assert torch.equal(got, want) and torch.equal(again, want)
    assert not torch.equal(got, base)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_k8_k8f_keys_of_many_chunks_match_plain(cuda, monkeypatch, dtype):
    """Keys of 10 chunks, more than the kernel holds in registers, hash
    from the chunk array on both routes."""
    hspec = _many_chunks_hspec()
    assert hspec.levels[-1].schema.total_chunks == 10
    hplan = hu.make_hier_plan(hspec, tile_h=128)
    (q, r), s_q, s_r = _signed_params(hspec.levels[-1], 66, cuda)
    rng = np.random.default_rng(67)
    items = rng.integers(0, 1 << 32, (3001, 5), dtype=np.uint64).astype(np.uint32)
    items[100:900, :2] = items[0, :2]                 # one heavy level-0 prefix
    freqs = rng.integers(-200, 200, 3001).astype(np.int32)
    chunks = _chunks(hspec.levels[-1], hspec.level_items(2, items), cuda)
    f = torch.from_numpy(freqs).to(cuda, dtype)
    base = torch.zeros((3, hplan.padded_cols), dtype=dtype, device=cuda)
    assert hu.fold_geometry(hplan, 3, 3001, 4, _sms(cuda)).shared[0]
    want = hu.hier_update_signed_ref(hplan, base.clone(), chunks, f, q, r, s_q, s_r)
    got = hu.hier_update_signed(hplan, base.clone(), chunks, f, q, r, s_q, s_r)
    _all_global(monkeypatch, hplan, 3, 3001, cuda)
    again = hu.hier_update_signed(hplan, base.clone(), chunks, f, q, r, s_q, s_r)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, want)


def test_k8_refuses_a_launch_it_cannot_make(cuda, monkeypatch):
    """A geometry whose shared bytes disagree with its levels, and a shared
    copy above one CTA's shared memory, are refused by the launcher and
    raised on: nothing falls back."""
    hspec = _hspec(w=4)
    hplan = hu.make_hier_plan(hspec, tile_h=128)
    (q, r), s_q, s_r = _signed_params(hspec.levels[-1], 63, cuda)
    items, freqs = _signed_block(hspec, 300, 64)
    chunks = _chunks(hspec.levels[-1], hspec.level_items(2, items), cuda)
    f = torch.from_numpy(freqs).to(cuda)
    table = torch.zeros((4, hplan.padded_cols), dtype=torch.int32, device=cuda)
    rule = hu.fold_geometry(hplan, 4, 300, 4, _sms(cuda))
    wrong = rule._replace(shared_bytes=rule.shared_bytes + 4)
    monkeypatch.setattr(hu, "fold_geometry", lambda *args, **kw: wrong)
    n0 = _cuda.LAUNCHES["hier_update_signed"]
    with pytest.raises(RuntimeError, match="failed to launch"):
        hu.hier_update_signed(hplan, table, chunks, f, q, r, s_q, s_r)
    schema = KeySchema(domains=(1 << 32, 1 << 32))
    big = hh.HierarchySpec.from_spec(
        sk.mod_sketch_spec(schema, [(0,), (1,)], (65536, 64), 1))
    bplan = hu.make_hier_plan(big, tile_h=128)
    too_big = hu.FoldGeometry((True, False), 1, 1, 65536 * 4)
    assert too_big.shared_bytes > hu.SHARED_BYTES
    monkeypatch.setattr(hu, "fold_geometry", lambda *args, **kw: too_big)
    (q, r), s_q, s_r = _signed_params(big.levels[-1], 65, cuda)
    bchunks = _chunks(big.levels[-1], big.level_items(1, items[:, :2]), cuda)
    with pytest.raises(RuntimeError, match="failed to launch"):
        hu.hier_update_signed(bplan, torch.zeros((1, bplan.padded_cols), dtype=torch.int32,
                                                 device=cuda), bchunks, f, q, r, s_q, s_r)
    assert _cuda.LAUNCHES["hier_update_signed"] == n0


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


# --------------------------------------------------------------------------
# K4, K9, K9m: one query body, on both routes
# --------------------------------------------------------------------------

GRID_SPAN = 90          # the level's last range: child partials lie below it


def _grid_case(w, p, c, seed, device, offset=3, prefixes=600):
    """A level view whose base lies ``offset`` cells past a 16-byte boundary,
    so prefix windows start unaligned, of int32 cells near +-2^24 and +-2^31
    and zeros -- never -2^31, where K9's int32 product wraps and its plain
    version's float32 one does not (ROADMAP's deliberate difference); prefix
    partials idx * GRID_SPAN, child partials below GRID_SPAN, +-1 signs."""
    rng = np.random.default_rng(seed)
    h = prefixes * GRID_SPAN
    shape = (w, h + 2 * offset + 8)
    wide = rng.integers(-(1 << 31) + 1, 1 << 31, shape, dtype=np.int64)
    near = rng.integers((1 << 24) - 8, (1 << 24) + 8, shape) * rng.choice([-1, 1], shape)
    cells = np.where(rng.random(shape) < 0.5, wide, near)
    cells[:, ::7] = 0
    table = torch.from_numpy(cells.astype(np.int32)).to(device)
    pp = torch.from_numpy(rng.integers(0, prefixes, (w, p)) * GRID_SPAN).to(device)
    cp = torch.from_numpy(rng.integers(0, GRID_SPAN, (w, c))).to(device)
    sp = torch.from_numpy(rng.choice([-1.0, 1.0], (w, p)).astype(np.float32)).to(device)
    sc = torch.from_numpy(rng.choice([-1.0, 1.0], (w, c)).astype(np.float32)).to(device)
    return table[:, offset : offset + h], pp, cp, sp, sc


def _force_query_route(monkeypatch, w, span):
    """K4/K9/K9m's route forced: the window route staging ``span`` cells a
    row in CTAs of 512 candidates, or (span 0) the direct route."""
    geometry = (hq.QueryGeometry(span, 512, hq.window_bytes(w, span)) if span
                else hq.QueryGeometry(0, hq.THREADS, 0))
    monkeypatch.setattr(hq, "query_geometry", lambda *args, **kw: geometry)


@pytest.mark.parametrize("route", ["direct", "window"])
@pytest.mark.parametrize("w", range(1, 10))
def test_k4_k9_k9m_match_plain_for_every_w_on_both_routes(cuda, monkeypatch, w, route):
    """w = 1-8 run unrolled, 9 the runtime loop.  The window route stages
    the level's whole range, then 37 cells a row, so that lanes with a child
    partial at or past the staged length read global memory; P = 1 and P =
    2,190 (the main path's widest level-1 grid), and a Q-batched grid."""
    spans = (GRID_SPAN, 37) if route == "window" else (0,)
    for p, c, seed in ((1, 5003, 40 + w), (2190, 300, 50 + w)):
        view, pp, cp, sp, sc = _grid_case(w, p, c, seed, cuda)
        for span in spans:
            _force_query_route(monkeypatch, w, span)
            n0 = dict(_cuda.LAUNCHES)
            got = hq.hier_candidate_query(view, pp, cp, span=GRID_SPAN)
            assert torch.equal(got, hq.hier_candidate_query_ref(view, pp, cp))
            rows = hq.hier_candidate_query_signed(view, pp, cp, sp, sc, span=GRID_SPAN)
            assert rows.dtype == torch.int32 and rows.shape == (w, p, c)
            assert torch.equal(rows.to(torch.float32),
                               hq.hier_candidate_query_signed_ref(view, pp, cp, sp, sc))
            med = hq.hier_candidate_median_signed(view, pp, cp, sp, sc, span=GRID_SPAN)
            assert med.dtype == torch.float32 and med.shape == (p, c)
            assert torch.equal(med.view(torch.int32), cs.median_rows(rows).view(torch.int32))
            assert torch.equal(med, hq.hier_candidate_median_signed_ref(view, pp, cp, sp, sc))
            pp3 = torch.stack([pp, pp.flip(1), pp], dim=1)
            assert torch.equal(hq.hier_candidate_query_batched(view, pp3, cp, span=GRID_SPAN),
                               hq.hier_candidate_query_batched_ref(view, pp3, cp))
            for name, n in (("hier_query", 2), ("hier_query_signed", 1),
                            ("hier_query_signed_median", 1)):
                assert _cuda.LAUNCHES[name] == n0[name] + n


@pytest.mark.parametrize("span", ["level range", None])
def test_descents_with_and_without_span_equal_plain_on_card(cuda, monkeypatch, span):
    """The linear descents (serial and Q-batched, on K4) and the signed one
    (on K9m) with ``span`` passed (the rule takes the window route at these
    ranges) and without it (the direct route), against the plain descents."""
    if span is None:
        monkeypatch.setattr(hh, "candidate_span", lambda *args: None)
    hspec = _hspec(w=4)
    params = _signed_params(hspec.levels[-1], 70, cuda)
    items, freqs = _signed_block(hspec, 3000, 71)
    cands = [np.unique(items[:, list(g)], axis=0) for g in hspec.base.partition]
    kh = KernelHierarchy(hspec, params[0], tile_h=128, device=cuda)
    kh.update(items, np.abs(freqs))
    plain = hh.update_jit(hspec, hh.init_hierarchy(hspec, params[0], device=cuda), items,
                          np.abs(freqs))
    thr = 0.002 * np.abs(freqs).sum()
    n0 = dict(_cuda.LAUNCHES)
    got = hh.find_heavy_hitters(hspec, kh.state(), thr, cands, use_kernel=True,
                                max_batch=4096)
    want = hh.find_heavy_hitters(hspec, plain, thr, cands, max_batch=4096)
    assert got[0].shape[0] > 0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    got_b = hh.batched_find_heavy_hitters(hspec, kh.state(), [thr, 2 * thr], cands,
                                          use_kernel=True)
    want_b = hh.batched_find_heavy_hitters(hspec, plain, [thr, 2 * thr], cands)
    for a, b in zip(got_b, want_b):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    ks = KernelHierarchy(hspec, params, tile_h=128, device=cuda, mode="signed")
    ks.update(items, freqs)
    splain = cs.hier_update(hspec, cs.init_hierarchy(hspec, params, dtype=torch.int32,
                                                     device=cuda), items, freqs)
    got = cs.find_heavy_hitters(hspec, ks.cs_state(), thr, cands, use_kernel=True,
                                max_batch=4096)
    want = cs.find_heavy_hitters(hspec, splain, thr, cands, max_batch=4096)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert _cuda.LAUNCHES["hier_query"] > n0["hier_query"]
    assert _cuda.LAUNCHES["hier_query_signed_median"] > n0["hier_query_signed_median"]
    assert _cuda.LAUNCHES["hier_query_signed"] == n0["hier_query_signed"]


def test_k9m_refuses_a_launch_it_cannot_make(cuda, monkeypatch):
    """Shared bytes that disagree with the window, and a window above one
    CTA's shared memory, are refused by the launcher and raised on: nothing
    falls back to the plain version."""
    view, pp, cp, sp, sc = _grid_case(4, 3, 700, 60, cuda)
    n0 = _cuda.LAUNCHES["hier_query_signed_median"]
    wrong = hq.QueryGeometry(GRID_SPAN, 256, hq.window_bytes(4, GRID_SPAN) + 4)
    monkeypatch.setattr(hq, "query_geometry", lambda *args, **kw: wrong)
    with pytest.raises(RuntimeError, match="failed to launch"):
        hq.hier_candidate_median_signed(view, pp, cp, sp, sc, span=GRID_SPAN)
    too_big = hq.QueryGeometry(20_000, 256, hq.window_bytes(4, 20_000))
    assert too_big.shared_bytes > 232_448
    monkeypatch.setattr(hq, "query_geometry", lambda *args, **kw: too_big)
    with pytest.raises(RuntimeError, match="failed to launch"):
        hq.hier_candidate_median_signed(view, pp, cp, sp, sc, span=20_000)
    assert _cuda.LAUNCHES["hier_query_signed_median"] == n0


def test_signed_float32_folds_launch_and_reads_refuse(cuda):
    """Item 14 is ported: signed float32 tables fold on the card through
    K6f and K8f (no plain fallback), point queries take the plain gather
    as the reference's do, and K9 -- int32 only, as the reference's --
    refuses a float32 level."""
    hspec = _hspec()
    spec = hspec.levels[-1]
    params = _signed_params(spec, 33, cuda)
    items, freqs = _signed_block(hspec, 64, 34)
    ks = KernelSketch(spec, params, dtype=torch.float32, device=cuda, mode="signed")
    kh = KernelHierarchy(hspec, params, dtype=torch.float32, device=cuda, mode="signed")
    before = dict(_cuda.LAUNCHES)
    ks.update(items, freqs)
    kh.update(items, freqs)
    assert _cuda.LAUNCHES["sketch_update_signed_f32"] == before["sketch_update_signed_f32"] + 1
    assert _cuda.LAUNCHES["hier_update_signed_f32"] == before["hier_update_signed_f32"] + 1
    ref = cs.update(spec, cs.init_state(spec, params, device=cuda), items, freqs)
    assert torch.equal(ks.cs_state().table, ref.table)
    np.testing.assert_array_equal(ks.query_rows(items),
                                  cs.query_rows(spec, ref, items)[0].cpu().numpy())
    assert _cuda.LAUNCHES["sketch_query_signed"] == before["sketch_query_signed"]
    state = kh.cs_state()
    values = items[:5, list(hspec.base.partition[0])]
    with pytest.raises(ValueError, match="takes int32 tables"):
        cs.candidate_estimates(hspec, state, 0, np.zeros((1, 0), np.uint32), values,
                               use_kernel=True)


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
        "sketch_update_signed", "sketch_query_signed", "sketch_query_signed_median",
        "hier_update_signed", "hier_query_signed_median"))


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
                                            (40, (6, 5, 3), "shared"),
                                            (40, (48, 90, 7), "global")])
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


@pytest.mark.parametrize("w", [4, 40])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_k5i_folds_every_level_in_one_launch(cuda, dtype, w):
    hspec = _hspec(w=w)
    params = _params(hspec.levels[-1], 33, cuda)
    state = hh.init_hierarchy(hspec, params, dtype=dtype, device=cuda)
    for st, seed in zip(state.states, (34, 35, 36)):
        st.table.copy_(_cons_table(tuple(st.table.shape), dtype, seed, cuda))
    routes = [scu.residency(w, st.table.shape[1], 4) for st in state.states]
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


def _adversarial(n, seed, kind, dtype, n_keys=12):
    """Key ids [n] and frequencies [n] that stress the fold's schedule:
    ``runs`` -- 300 short runs (windows full of runs), then runs of 400 to
    900 items (across staging buffers), a fifth of the frequencies zero;
    ``one_key`` -- one key n times.  int32 frequencies are large enough to
    wrap a run's sum past 2^31 from cells near it; float32 ones are not
    integers."""
    rng = np.random.default_rng(seed)
    if kind == "one_key":
        order = np.zeros(n, np.int64)
    else:
        lengths = np.concatenate([rng.geometric(0.7, 300), rng.integers(400, 900, 8)])
        order = np.repeat(rng.integers(0, n_keys, lengths.size), lengths)[:n]
    if dtype == torch.int32:
        freqs = rng.integers(0, 1 << 16, n).astype(np.int32)
    else:
        freqs = (rng.random(n) * 1000).astype(np.float32)
    freqs[rng.random(n) < 0.2] = 0
    return order, freqs


@pytest.mark.parametrize("w", [3, 40])
@pytest.mark.parametrize("kind", ["runs", "one_key"])
@pytest.mark.parametrize("route", ["shared", "global"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_k5_adversarial_blocks_match_plain(cuda, monkeypatch, dtype, route, kind, w):
    """K5 on blocks of long and short runs of a few keys, or of one key, on
    both routes, with the rows in registers (w = 3) or read through the
    table (w = 40): bit for bit with the per-item fold."""
    schema = KeySchema(domains=(1 << 32, 256, 1000, 4096))
    spec = sk.mod_sketch_spec(schema, [(1, 2), (0,), (3,)], (16, 9, 7), w)
    hspec = hh.HierarchySpec.from_spec(spec)
    plan = make_plan(spec)
    params = _params(spec, 50, cuda)
    h_pad = su.padded_table_size(spec.table_size, 128)
    assert scu.residency(w, h_pad, 4) == "shared"
    if route == "global":
        monkeypatch.setattr(scu, "residency", lambda *args, **kw: "global")
    keys, _ = _block(hspec, 12, 51)
    order, freqs = _adversarial(3000, 52, kind, dtype)
    chunks = spec.schema.module_chunks(torch.from_numpy(keys[order].astype(np.int64)).to(cuda))
    f = torch.from_numpy(freqs).to(cuda)
    base = _cons_table((w, h_pad), dtype, 53, cuda)
    n0 = _cuda.LAUNCHES["sketch_update_conservative"]
    got = scu.sketch_update_conservative(plan, base.clone(), chunks, f, params.q, params.r)
    want = scu.sketch_update_conservative_ref(plan, base.clone(), chunks, f, params.q,
                                              params.r)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["sketch_update_conservative"] == n0 + 1
    assert torch.equal(got, want)
    assert not torch.equal(got, base)


@pytest.mark.parametrize("w", [4, 40])
@pytest.mark.parametrize("kind", ["runs", "one_key"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_k5i_adversarial_blocks_match_plain(cuda, dtype, kind, w):
    """K5i on the same blocks, as given indices into a shared-route table
    (cells among 7 a row, so runs of different keys collide) and a
    global-route table, in one launch, with the rows in registers (w = 4)
    or read through the table (w = 40): bit for bit with the per-item fold."""
    rng = np.random.default_rng(54)
    n = 3000
    order, freqs = _adversarial(n, 55, kind, dtype)
    tables, idxs = [], []
    for cols, span, seed in ((1000, 7, 56), (30_000, 30_000, 57)):
        tables.append(_cons_table((w, cols), dtype, seed, cuda))
        cells = rng.integers(0, span, (12, w))
        idxs.append(torch.from_numpy(np.ascontiguousarray(cells[order].T)).to(cuda))
    assert [scu.residency(w, t.shape[1], 4) for t in tables] == ["shared", "global"]
    f = torch.from_numpy(freqs).to(cuda)
    got = [t.clone() for t in tables]
    want = [t.clone() for t in tables]
    n0 = _cuda.LAUNCHES["conservative_fold"]
    scu.conservative_fold_tables(got, idxs, f)
    scu.conservative_fold_tables_ref(want, idxs, f)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["conservative_fold"] == n0 + 1
    for a, b, t in zip(got, want, tables):
        assert torch.equal(a, b)
        assert not torch.equal(a, t)


# K5's claim rounds (a large block on the global route, across the card)

def _edge_spec(ranges, w=4):
    return sk.mod_sketch_spec(KeySchema((1 << 32, 1 << 32)), [(0,), (1,)], ranges, w)


def _fold_in_rounds(cuda, spec, items, freqs, base, seed):
    """K5 on one block through claim rounds (``scu.rounds_route`` must
    take it) against the per-item fold of host copies, at tolerance 0.
    The rounds' counter adds up to the block's nonzero items and equals
    the plain model's (``claim_rounds``) at the launch's ``rounds_grid``;
    returns the counts."""
    plan = make_plan(spec)
    params = _params(spec, seed, cuda)
    w, h_pad = base.shape
    assert scu.residency(w, h_pad, 4) == "global" and scu.rounds_route(w, len(freqs))
    chunks = spec.schema.module_chunks(torch.from_numpy(items.astype(np.int64)).to(cuda))
    f = torch.from_numpy(freqs).to(cuda)
    scratch = scu.RoundScratch(cuda)
    n0 = _cuda.LAUNCHES["sketch_update_conservative"]
    got = scu.sketch_update_conservative(plan, base.clone(), chunks, f, params.q, params.r,
                                         scratch)
    want = scu.sketch_update_conservative_ref(plan, base.cpu(), chunks.cpu(), f.cpu(),
                                              params.q.cpu(), params.r.cpu())
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["sketch_update_conservative"] == n0 + 1
    assert torch.equal(got.cpu(), want)
    counts = scratch.counts()
    nonzero = int(np.count_nonzero(freqs))
    assert counts["blocks"] == 1
    assert counts["round_items"] + counts["tail_items"] == nonzero
    min_fold, seg = scu.rounds_grid(plan, w, base.dtype, cuda)
    model = scu.claim_rounds(all_indices(plan, chunks, params.q, params.r), f, min_fold, seg)
    assert counts == {"blocks": 1, "rounds": sum(len(p.rounds) for p in model),
                      "round_items": sum(r.size for p in model for r in p.rounds),
                      "tail_items": sum(p.tail.size for p in model)}
    # the scratch is reused: the same block again folds the same way
    again = scu.sketch_update_conservative(plan, got, chunks, f, params.q, params.r, scratch)
    scu.sketch_update_conservative_ref(plan, want, chunks.cpu(), f.cpu(), params.q.cpu(),
                                       params.r.cpu())
    assert torch.equal(again.cpu(), want)
    assert scratch.counts() == {k: 2 * v for k, v in counts.items()}
    return counts


def _edges(n, seed, order):
    """n distinct edges (source, target): sources Zipf(0.79) over 1,000,000
    ids, as the ingest cell's configuration draws them, targets uniform;
    ``order`` "random" or "source" (sorted)."""
    rng = np.random.default_rng(seed)
    src_ids = rng.integers(0, 1 << 32, 1_000_000, dtype=np.uint64)
    weight = np.arange(1, 1_000_001, dtype=np.float64) ** -0.79
    src = src_ids[rng.choice(1_000_000, 2 * n, p=weight / weight.sum())]
    tgt = rng.integers(0, 1 << 32, 2 * n, dtype=np.uint64)
    pairs = np.stack([src, tgt], axis=1)
    _, first = np.unique(pairs, axis=0, return_index=True)
    edges = pairs[np.sort(first)[:n]]                 # the first n distinct, as drawn
    assert edges.shape[0] == n
    if order == "source":
        edges = edges[np.lexsort((edges[:, 1], edges[:, 0]))]
    return edges.astype(np.uint32)


@pytest.mark.parametrize("order", ["random", "source"])
def test_k5_rounds_on_the_ingest_cells_block_shape(cuda, order):
    """The ingest cell's shape: w 4, ranges 4,096 x 4,096 (a 268 MB table),
    65,536 distinct edges with counts, in random and in source order.
    Nearly every item folds in the rounds."""
    spec = _edge_spec((4096, 4096))
    rng = np.random.default_rng(80)
    freqs = np.minimum(rng.geometric(0.3, 1 << 16), 17_000).astype(np.int32)
    h_pad = su.padded_table_size(spec.table_size, 512)
    base = torch.zeros((4, h_pad), dtype=torch.int32, device=cuda)
    counts = _fold_in_rounds(cuda, spec, _edges(1 << 16, 81, order), freqs, base, 82)
    assert counts["round_items"] >= 0.99 * (1 << 16)


def _sharing_row0(spec, params, n, rng, cuda):
    """n distinct keys of one source whose row-0 cells are all one cell
    (their other rows differ), found among 2^22 random targets."""
    plan = make_plan(spec)
    tgt = np.unique(rng.integers(0, 1 << 32, 1 << 22, dtype=np.uint64))
    keys = np.stack([np.full_like(tgt, 12345), tgt], axis=1)
    chunks = spec.schema.module_chunks(torch.from_numpy(keys.astype(np.int64)).to(cuda))
    row0 = all_indices(plan, chunks, params.q, params.r)[0].cpu().numpy()
    cells, count = np.unique(row0, return_counts=True)
    pick = np.flatnonzero(row0 == cells[np.argmax(count)])
    assert pick.size >= n
    return keys[pick[:n]].astype(np.uint32)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("kind", ["one_key", "chain", "shared_cell", "mid_chunk"])
def test_k5_rounds_adversarial_blocks_match_plain(cuda, kind, dtype):
    """Claim rounds on a global-route table of 4 x 65,536 cells, cells near
    2^31 so that int32 estimates wrap inside the rounds, non-integer
    float32 frequencies, a fifth of them zero: ``one_key`` (one key 20,000
    times: one round, then all to the tail), ``chain`` (5,000 keys that all
    share row 0's cell: one long chain), ``shared_cell`` (those keys shuffled
    into 30,000 distinct ones), ``mid_chunk`` (5,077 distinct keys, one key
    3,000 times, 2,000 distinct keys: the tail starts in the middle of a
    staging chunk)."""
    spec = _edge_spec((256, 256))
    rng = np.random.default_rng(90)
    params = _params(spec, 91, cuda)
    distinct = _edges(40_000, 92, "random")
    if kind == "one_key":
        items = np.repeat(distinct[:1], 20_000, axis=0)
    elif kind == "chain":
        items = _sharing_row0(spec, params, 5000, rng, cuda)
    elif kind == "shared_cell":
        items = np.concatenate([_sharing_row0(spec, params, 5000, rng, cuda), distinct[:30_000]])
        items = items[rng.permutation(items.shape[0])]
    else:
        items = np.concatenate([distinct[:5077], np.repeat(distinct[5077:5078], 3000, axis=0),
                                distinct[5078:7078]])
    n = items.shape[0]
    if dtype == torch.int32:
        freqs = rng.integers(0, 1 << 16, n).astype(np.int32)
    else:
        freqs = (rng.random(n) * 1000).astype(np.float32)
    freqs[rng.random(n) < 0.2] = 0
    h_pad = su.padded_table_size(spec.table_size, 128)
    base = _cons_table((4, h_pad), dtype, 93, cuda)
    counts = _fold_in_rounds(cuda, spec, items, freqs, base, 91)
    if kind in ("one_key", "chain"):
        assert counts["rounds"] == 1 and counts["round_items"] == 1
    else:
        assert counts["rounds"] > 1 and counts["tail_items"] > 0


@pytest.mark.parametrize("n", [1, 65_537, 140_000])
def test_k5_rounds_at_block_sizes(cuda, monkeypatch, n):
    """Blocks of 1 item, of 65,537 and of 140,000 (past one segment) in
    claim rounds (the size rule lowered to 1 item)."""
    monkeypatch.setattr(scu, "ROUNDS_MIN_ITEMS", 1)
    spec = _edge_spec((256, 256))
    rng = np.random.default_rng(95)
    freqs = rng.integers(0, 1 << 12, n).astype(np.int32)
    freqs[rng.random(n) < 0.2] = 0
    freqs[0] = 7
    h_pad = su.padded_table_size(spec.table_size, 128)
    base = _cons_table((4, h_pad), torch.int32, 96, cuda)
    counts = _fold_in_rounds(cuda, spec, _edges(n, 97, "random"), freqs, base, 98)
    assert counts["round_items"] >= 1


def test_k5_rounds_scratch_is_per_sketch_and_kept(cuda):
    """A conservative KernelSketch on a global-route table allocates the
    rounds' scratch once (2 MB of claims at most) and counts its blocks;
    a shared-route one has none."""
    spec = _edge_spec((256, 256))
    params = _params(spec, 99, cuda)
    ks = KernelSketch(spec, (params.q, params.r), mode="conservative", device=cuda)
    scratch = ks.fold_scratch
    assert scratch.claims.numel() * scratch.claims.element_size() <= 2 << 20
    edges = _edges(1 << 14, 100, "random")
    freqs = np.ones(1 << 14, np.int32)
    ks.update(edges, freqs)
    ks.update(edges[:100], freqs[:100])        # below the size rule: one CTA's walk
    assert ks.fold_scratch is scratch
    assert scratch.counts()["blocks"] == 1
    small = _edge_spec((8, 8))
    sp = _params(small, 1, cuda)
    assert KernelSketch(small, (sp.q, sp.r), mode="conservative",
                        device=cuda).fold_scratch is None


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


# --------------------------------------------------------------------------
# float32 folds: K1f, K3f, K6f, K8f
# --------------------------------------------------------------------------

def _f32_values(freqs, kind, seed):
    if kind == "integer":
        return freqs.astype(np.float32)
    return (np.random.default_rng(seed).standard_normal(freqs.shape) * 100).astype(
        np.float32)


def _f32_equal(got, want, kind):
    torch.cuda.synchronize()
    if kind == "integer":
        assert torch.equal(got, want)
    else:
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("kind", ["integer", "gaussian"])
def test_k1f_float32_flat_fold_matches_plain(cuda, kind):
    spec = _hspec().levels[-1]
    plan = make_plan(spec)
    params = _params(spec, 40, cuda)
    items, freqs = _block(_hspec(), 3000, 41)
    chunks = _chunks(spec, items, cuda)
    f = torch.from_numpy(_f32_values(freqs, kind, 42)).to(cuda)
    base = _random_table((spec.width, su.padded_table_size(spec.table_size, 128)),
                         43, cuda).float()
    n0 = dict(_cuda.LAUNCHES)
    got = su.sketch_update(plan, base.clone(), chunks, f, params.q, params.r)
    want = su.sketch_update_ref(plan, base.clone(), chunks, f, params.q, params.r)
    assert _cuda.LAUNCHES["sketch_update_f32"] == n0["sketch_update_f32"] + 1
    assert _cuda.LAUNCHES["sketch_update"] == n0["sketch_update"]
    _f32_equal(got, want, kind)


@pytest.mark.parametrize("route", ["rule", "global"])
@pytest.mark.parametrize("kind", ["integer", "gaussian"])
def test_k3f_float32_hierarchy_fold_matches_plain(cuda, monkeypatch, kind, route):
    hspec = _hspec()
    hplan = hu.make_hier_plan(hspec, tile_h=128)
    params = _params(hspec.levels[-1], 44, cuda)
    got = torch.zeros((hspec.base.width, hplan.padded_cols), device=cuda)
    want = got.clone()
    if route == "global":
        _all_global(monkeypatch, hplan, hspec.base.width, 2000, cuda)
    n0 = _cuda.LAUNCHES["hier_update_f32"]
    for seed in (45, 46):
        items, freqs = _block(hspec, 2000, seed)
        chunks = _chunks(hspec.levels[-1], hspec.level_items(2, items), cuda)
        f = torch.from_numpy(_f32_values(freqs, kind, seed)).to(cuda)
        hu.hier_update(hplan, got, chunks, f, params.q, params.r)
        hu.hier_update_ref(hplan, want, chunks, f, params.q, params.r)
    assert _cuda.LAUNCHES["hier_update_f32"] == n0 + 2
    _f32_equal(got, want, kind)


@pytest.mark.parametrize("kind,case,n", [("integer", "mixed", 3000), ("gaussian", "mixed", 3000)]
                         + [("integer", c, n) for c, n in K6_CASES[1:]])
def test_k6f_float32_signed_flat_fold_matches_plain(cuda, kind, case, n):
    hspec, items, freqs = _k6_block(case, n, 48)
    spec = hspec.levels[-1]
    plan = make_plan(spec)
    (q, r), s_q, s_r = _signed_params(spec, 47, cuda)
    if n > 3001:                     # every partial sum an integer below 2^24
        freqs = np.sign(freqs) * (np.abs(freqs) % 256)
    chunks = _chunks(spec, items, cuda)
    f = torch.from_numpy(_f32_values(freqs, kind, 49)).to(cuda)
    base = torch.zeros((spec.width, su.padded_table_size(spec.table_size, 128)),
                       device=cuda)
    n0 = _cuda.LAUNCHES["sketch_update_signed_f32"]
    got = su.sketch_update_signed(plan, base.clone(), chunks, f, q, r, s_q, s_r)
    want = su.sketch_update_signed_ref(plan, base.clone(), chunks, f, q, r, s_q, s_r)
    assert _cuda.LAUNCHES["sketch_update_signed_f32"] == n0 + 1
    _f32_equal(got, want, kind)


@pytest.mark.parametrize("kind", ["integer", "gaussian"])
def test_k8f_float32_signed_hierarchy_fold_matches_plain(cuda, kind):
    """The fused signed fold on a float32 table, and the compressor's route
    to it (countsketch.hier_fold_tables and hier_fold_zero_tables on the
    card: one K8f launch each, level views of one concatenated table)
    against the plain fold on the CPU."""
    hspec = _hspec(w=3)
    hplan = hu.make_hier_plan(hspec, tile_h=128)
    params = _signed_params(hspec.levels[-1], 50, cuda)
    (q, r), s_q, s_r = params
    got = torch.zeros((3, hplan.padded_cols), device=cuda)
    want = got.clone()
    items, freqs = _signed_block(hspec, 2500, 51)
    vals = _f32_values(freqs, kind, 52)
    chunks = _chunks(hspec.levels[-1], hspec.level_items(2, items), cuda)
    f = torch.from_numpy(vals).to(cuda)
    n0 = _cuda.LAUNCHES["hier_update_signed_f32"]
    hu.hier_update_signed(hplan, got, chunks, f, q, r, s_q, s_r)
    hu.hier_update_signed_ref(hplan, want, chunks, f, q, r, s_q, s_r)
    assert _cuda.LAUNCHES["hier_update_signed_f32"] == n0 + 1
    _f32_equal(got, want, kind)

    zeros = tuple(torch.zeros((s.width, s.table_size), device=cuda) for s in hspec.levels)
    tabs = cs.hier_fold_tables(hspec, params, zeros, items, f)
    assert _cuda.LAUNCHES["hier_update_signed_f32"] == n0 + 2
    assert tabs[1].stride(0) == sum(s.table_size for s in hspec.levels)
    cpu_params = cs.resolve_params(hspec.levels[-1], params, "cpu")
    plain = cs.hier_fold_tables(hspec, cpu_params, tuple(z.cpu() for z in zeros), items,
                                torch.from_numpy(vals))
    for a, b in zip(tabs, plain):
        _f32_equal(a.cpu(), b, kind)
    fresh = cs.hier_fold_zero_tables(hspec, params, items, f)
    assert _cuda.LAUNCHES["hier_update_signed_f32"] == n0 + 3
    assert fresh[1].stride(0) == tabs[1].stride(0)
    for a, b in zip(fresh, plain):
        _f32_equal(a.cpu(), b, kind)


def test_compressor_on_the_card_equals_cpu_on_integer_gradients(cuda):
    """compress_decompress with its fold on K8f and its descent (stable
    top-k, median of rows) on the card equals the CPU run exactly on
    integer-valued gradients with many ties, beam and dense descents."""
    from repro_torch import tree as tr
    from repro_torch.training import grad_compression as gc

    rng = np.random.default_rng(53)
    grads = {"w": rng.integers(-3, 4, (1024, 64)).astype(np.float32),
             "v": np.zeros((40, 48), np.float32), "b": np.ones(7, np.float32)}
    grads["v"].reshape(-1)[:100] = 2.0
    for cfg in (gc.CompressionConfig(enabled=True, width=5, ratio=2.0, min_size=256,
                                     beta_rows_cols=256.0, k=24),
                gc.CompressionConfig(enabled=True, width=3, ratio=4.0, min_size=256)):
        cpu_g = tr.map_leaves(torch.from_numpy, grads)
        dev_g = tr.map_leaves(lambda x: x.to(cuda), cpu_g)
        cpu_state = gc.init_compression(cfg, cpu_g, torch.Generator().manual_seed(54))
        draws = {path: (c.params.base.q, c.params.base.r, c.params.sign_q,
                        c.params.sign_r)
                 for path, c in tr.flatten(cpu_state.compressors) if c is not None}
        dev_state = gc.init_compression(cfg, dev_g, draws)
        n0 = _cuda.LAUNCHES["hier_update_signed_f32"]
        for _ in range(2):
            cpu_out, cpu_state, _ = gc.compress_decompress(cfg, cpu_g, cpu_state)
            dev_out, dev_state, _ = gc.compress_decompress(cfg, dev_g, dev_state)
            for (path, a), b in zip(tr.flatten(dev_out), tr.leaves(cpu_out)):
                assert torch.equal(a.cpu(), b), path
            for (path, a), b in zip(tr.flatten(dev_state.residual),
                                    tr.leaves(cpu_state.residual)):
                assert (a is None and b is None) or torch.equal(a.cpu(), b), path
        assert _cuda.LAUNCHES["hier_update_signed_f32"] == n0 + 4


# --------------------------------------------------------------------------
# K4f: the candidate grid on float32 tables (the decayed window's)
# --------------------------------------------------------------------------

def _grid_case_f32(w, p, c, seed, device, offset=3, prefixes=600):
    """As :func:`_grid_case`, of float32 cells: finite non-negative values
    (integers, decayed non-integers, values that tie in a row, and +0.0),
    as a decayed window's tables hold them."""
    rng = np.random.default_rng(seed)
    h = prefixes * GRID_SPAN
    shape = (w, h + 2 * offset + 8)
    cells = np.where(rng.random(shape) < 0.5, rng.integers(0, 1 << 24, shape),
                     rng.random(shape) * 1e4).astype(np.float32)
    cells[:, ::5] = 7.25
    cells[:, ::7] = 0.0
    table = torch.from_numpy(cells).to(device)
    pp = torch.from_numpy(rng.integers(0, prefixes, (w, p)) * GRID_SPAN).to(device)
    cp = torch.from_numpy(rng.integers(0, GRID_SPAN, (w, c))).to(device)
    return table[:, offset : offset + h], pp, cp


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("route", ["direct", "window"])
@pytest.mark.parametrize("w", range(1, 10))
def test_k4f_matches_plain_for_every_w_on_both_routes(cuda, monkeypatch, w, route):
    """K4f bit for bit against ``hier_candidate_query_ref`` on float32
    views whose windows start unaligned: w = 1-8 unrolled, 9 the runtime
    loop; the window route staging the whole range and 37 cells a row;
    P = 1 and 2,190, and a Q-batched grid."""
    spans = (GRID_SPAN, 37) if route == "window" else (0,)
    for p, c, seed in ((1, 5003, 140 + w), (2190, 300, 150 + w)):
        view, pp, cp = _grid_case_f32(w, p, c, seed, cuda)
        for span in spans:
            _force_query_route(monkeypatch, w, span)
            n0 = dict(_cuda.LAUNCHES)
            got = hq.hier_candidate_query_f32(view, pp, cp, span=GRID_SPAN)
            assert got.shape == (p, c)
            assert _bitwise(got, hq.hier_candidate_query_ref(view, pp, cp))
            pp3 = torch.stack([pp, pp.flip(1), pp], dim=1)
            assert _bitwise(hq.hier_candidate_query_f32_batched(view, pp3, cp, span=GRID_SPAN),
                            hq.hier_candidate_query_batched_ref(view, pp3, cp))
            assert _cuda.LAUNCHES["hier_query_f32"] == n0["hier_query_f32"] + 2
            assert _cuda.LAUNCHES["hier_query"] == n0["hier_query"]


def test_k4f_on_strided_level_views_matches_plain(cuda):
    """K4f reads each level view of a float32 concatenated hierarchy table
    through its row stride, serial and batched."""
    hspec = _hspec()
    kh = KernelHierarchy(hspec, _params(hspec.levels[-1], 30, cuda), tile_h=128,
                          dtype=torch.float32, device=cuda)
    rng = np.random.default_rng(31)
    kh.table.copy_(torch.from_numpy(
        (rng.random(tuple(kh.table.shape)) * 500).astype(np.float32)).to(cuda))
    kh._state_cache = None
    state = kh.state()
    for level in range(hspec.n_levels):
        view = state.states[level].table
        assert view.dtype == torch.float32 and (not view.is_contiguous() or level == 0)
        prefixes = np.stack([rng.integers(0, hspec.base.schema.domains[m], 37,
                                          dtype=np.uint64).astype(np.uint32)
                             for m in hh.level_modules(hspec.base, level - 1)],
                            axis=1) if level else np.zeros((1, 0), np.uint32)
        values = np.stack([rng.integers(0, hspec.base.schema.domains[m], 53,
                                        dtype=np.uint64).astype(np.uint32)
                           for m in hspec.base.partition[level]], axis=1)
        pp, cp = hh.candidate_partials(hspec, state, level, prefixes, values)
        span = hh.candidate_span(hspec, level)
        assert _bitwise(hq.hier_candidate_query_f32(view, pp, cp, span=span),
                        hq.hier_candidate_query_ref(view, pp, cp))
        pp3 = torch.stack([pp, pp.flip(1)], dim=1)
        assert _bitwise(hq.hier_candidate_query_f32_batched(view, pp3, cp, span=span),
                        hq.hier_candidate_query_batched_ref(view, pp3, cp))


def test_decayed_window_descent_launches_k4f_and_equals_plain(cuda):
    """The decayed window's descent on the card runs on K4f (its folds on
    K3f) with the service's default switches, and answers as the same
    service does on CPU copies."""
    from repro_torch.serving.windowed_topk import WindowedTopKService

    wl = zipf_hh_workload(n_src=300, n_tgt=600, n_edges=3000, n_occurrences=30_000, seed=4)
    spec = sk.mod_sketch_spec(KeySchema(wl.stream.schema.domains), [(0,), (1,)],
                              (256, 128), 4)
    params = _params(hh.HierarchySpec.from_spec(spec).levels[-1], 32, torch.device("cpu"))
    kw = dict(n_epochs=3, window_mode="decay", decay=0.9, max_candidates_per_group=512)
    card = WindowedTopKService(spec, params, device=cuda, **kw)
    host = WindowedTopKService(spec, params, device="cpu", **kw)
    assert card.use_kernel and card.use_update_kernel
    assert not (host.use_kernel or host.use_update_kernel)
    n0 = dict(_cuda.LAUNCHES)
    for b, idx in enumerate(np.array_split(np.arange(wl.stream.items.shape[0]), 7)):
        if b and b % 2 == 0:
            card.advance()
            host.advance()
        card.ingest(wl.stream.items[idx], wl.stream.freqs[idx])
        host.ingest(wl.stream.items[idx], wl.stream.freqs[idx])
    for a, b in zip(card.state().states, host.state().states):
        assert _bitwise(a.table.cpu(), b.table)
    thr = max(1, card.total // 100)
    got, want = card.heavy_hitters(thr), host.heavy_hitters(thr)
    assert got[0].shape[0] > 0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    got, want = card.topk(20), host.topk(20)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert _cuda.LAUNCHES["hier_query_f32"] > n0["hier_query_f32"]
    assert _cuda.LAUNCHES["hier_update_f32"] > n0["hier_update_f32"]
    assert _cuda.LAUNCHES["hier_query"] == n0["hier_query"]



# --------------------------------------------------------------------------
# sharded serving, the sharded flat folds and the data-parallel compressor
# --------------------------------------------------------------------------

def _mesh(n, device):
    from repro_torch.launch.mesh import Mesh

    return Mesh((n,), ("data",), [device] * n)


def test_sharded_service_on_one_card_equals_plain(cuda):
    """Four shards of a ShardedTopKService on one card, then two after a
    remesh: each block is one K3 launch a shard, the descent runs K4 on the
    merged tables, and every table and answer equals the same service on
    a CPU mesh."""
    from repro_torch.serving.sharded_topk import ShardedTopKService

    wl = zipf_hh_workload(n_src=300, n_tgt=600, n_edges=3000, n_occurrences=30_000, seed=4)
    spec = sk.mod_sketch_spec(KeySchema(wl.stream.schema.domains), [(0,), (1,)],
                              (256, 128), 4)
    params = _params(hh.HierarchySpec.from_spec(spec).levels[-1], 33, torch.device("cpu"))
    kw = dict(max_candidates_per_group=4096, sync_every=2)
    card = ShardedTopKService(spec, params, _mesh(4, cuda), **kw)
    host = ShardedTopKService(spec, params, _mesh(4, "cpu"), **kw)
    assert card.use_kernel and not host.use_kernel
    n0 = dict(_cuda.LAUNCHES)
    for b, idx in enumerate(np.array_split(np.arange(wl.stream.items.shape[0]), 7)):
        card.ingest(wl.stream.items[idx], wl.stream.freqs[idx])
        host.ingest(wl.stream.items[idx], wl.stream.freqs[idx])
        if b == 3:
            card.remesh(_mesh(2, cuda))
            host.remesh(_mesh(2, "cpu"))
    assert _cuda.LAUNCHES["hier_update"] - n0["hier_update"] == 4 * 4 + 2 * 3
    for a, b in zip(card.state().states, host.state().states):
        assert a.table.is_cuda and _bitwise(a.table.cpu(), b.table)
    thr = max(1, card.total // 100)
    for got, want in ((card.heavy_hitters(thr), host.heavy_hitters(thr)),
                      (card.topk(20), host.topk(20))):
        assert got[0].shape[0] > 0
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert _cuda.LAUNCHES["hier_query"] > n0["hier_query"]


def test_sharded_service_moved_onto_the_card_launches_k4(cuda):
    """A CPU endpoint promoted onto a card mesh, and a CPU service re-meshed
    onto the card, both with the default ``use_kernel``: after the move
    each shard folds on K3 and the descent runs on K4, with answers equal
    to the service that stayed on the CPU."""
    from repro_torch.serving.sharded_topk import ShardedTopKService

    wl = zipf_hh_workload(n_src=300, n_tgt=600, n_edges=3000, n_occurrences=30_000, seed=4)
    spec = sk.mod_sketch_spec(KeySchema(wl.stream.schema.domains), [(0,), (1,)],
                              (256, 128), 4)
    params = _params(hh.HierarchySpec.from_spec(spec).levels[-1], 33, torch.device("cpu"))
    blocks = np.array_split(np.arange(wl.stream.items.shape[0]), 6)
    host = ShardedTopKService(spec, params, _mesh(2, "cpu"), max_candidates_per_group=4096)
    ep = SketchTopKEndpoint(spec, params, max_candidates_per_group=4096, device="cpu")
    moved = ShardedTopKService(spec, params, _mesh(2, "cpu"), max_candidates_per_group=4096)
    for idx in blocks[:3]:
        for target in (host, ep, moved):
            target.ingest(wl.stream.items[idx], wl.stream.freqs[idx])
    promoted = ep.to_sharded(_mesh(2, cuda))
    moved.remesh(_mesh(2, cuda))
    thr = max(1, wl.stream.freqs.sum() // 100)
    for svc in (promoted, moved):
        assert svc.use_kernel and not host.use_kernel
        n0 = dict(_cuda.LAUNCHES)
        for idx in blocks[3:]:
            svc.ingest(wl.stream.items[idx], wl.stream.freqs[idx])
        assert _cuda.LAUNCHES["hier_update"] - n0["hier_update"] == 2 * 3
        got = (svc.heavy_hitters(thr), svc.topk(20))
        assert _cuda.LAUNCHES["hier_query"] > n0["hier_query"]
        if svc is promoted:
            for idx in blocks[3:]:
                host.ingest(wl.stream.items[idx], wl.stream.freqs[idx])
        for a, b in zip(svc.state().states, host.state().states):
            assert a.table.is_cuda and _bitwise(a.table.cpu(), b.table)
        for g, want in zip(got, (host.heavy_hitters(thr), host.topk(20))):
            assert g[0].shape[0] > 0
            np.testing.assert_array_equal(g[0], want[0])
            np.testing.assert_array_equal(g[1], want[1])


@pytest.mark.parametrize("mode", ["linear", "signed"])
def test_kernel_sketch_sharded_update_on_card(cuda, mode):
    """KernelSketch.sharded_update over four shards of one card: one K1 (or
    K6) launch a shard, the table equal to the CPU mesh's."""
    spec = sk.mod_sketch_spec(KeySchema((1 << 20, 1 << 20)), [(0,), (1,)], (64, 32), 3)
    rng = np.random.default_rng(7)
    items = rng.integers(0, 1 << 20, (1000, 2), dtype=np.int64).astype(np.uint32)
    freqs = rng.integers(1, 9, 1000).astype(np.int32)
    if mode == "signed":
        freqs = freqs * np.where(np.arange(1000) % 3 == 0, -1, 1).astype(np.int32)
    shapes = ((3, spec.schema.total_chunks), (3, spec.n_groups))
    params = tuple(draw_hash_params_np(rng, shape)
                   for shape in shapes * (2 if mode == "signed" else 1))
    card = KernelSketch(spec, params, device=cuda, mode=mode)
    host = KernelSketch(spec, params, device="cpu", mode=mode)
    name = "sketch_update" if mode == "linear" else "sketch_update_signed"
    n0 = _cuda.LAUNCHES[name]
    card.sharded_update(_mesh(4, cuda), ("data",), items, freqs)
    host.sharded_update(_mesh(4, "cpu"), ("data",), items, freqs)
    assert _cuda.LAUNCHES[name] == n0 + 4
    assert _bitwise(card.table.cpu(), host.table)


def test_dp_compressor_on_card(cuda):
    """The data-parallel compressor on the card: each replica's tables by
    one K8f launch, replicas bit-identical, and on integer gradients equal
    to the same reduction on the CPU."""
    from repro_torch.training import grad_compression as gc

    local = gc.CompressionConfig(enabled=True, width=5, ratio=4.0, min_size=256)
    dp = gc.CompressionConfig(enabled=True, width=5, ratio=4.0, min_size=256,
                              axis_name="dp")
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.integers(-9, 10, (2, 64, 48)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-9, 10, (2, 8)).astype(np.float32))
    outs = []
    for device in ("cpu", cuda):
        grads = {"w": g.to(device), "b": b.to(device)}
        state = gc.init_compression(local, tr.map_leaves(lambda x: x[0], grads),
                                    torch.Generator().manual_seed(0))
        n0 = _cuda.LAUNCHES["hier_update_signed_f32"]
        out, st, _ = gc.compress_decompress(dp, grads, gc.replicate_state(state, 2))
        assert _cuda.LAUNCHES["hier_update_signed_f32"] == n0 + (2 if device == cuda else 0)
        assert torch.equal(out["w"][0], out["w"][1])
        outs.append((out["w"].cpu(), st.residual["w"].cpu(), out["b"].cpu()))
    for a, b_ in zip(*outs):
        assert torch.equal(a, b_)


# --------------------------------------------------------------------------
# the model stack on the card (plain PyTorch, no kernel): against the CPU
# --------------------------------------------------------------------------

def _card_close(got, want):
    """The card sums in other orders (cuBLAS tiles, float atomics in the
    MoE combine): within 1e-4 of the output's scale."""
    want = want.cpu().to(torch.float32).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.cpu().to(torch.float32).numpy(), want,
                               rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_on_the_card_equal_cpu(cuda, arch):
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    host = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = tr.map_leaves(lambda x: x.to(cuda), host)
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 14)))
    emb = None
    if cfg.frontend:
        emb = torch.from_numpy(rng.standard_normal(
            (2, cfg.frontend_len, cfg.d_model)).astype(np.float32) * 0.02)
    n_prefix = cfg.frontend_len if cfg.frontend and not cfg.n_enc_layers else 0
    outs = []
    for params, dev in ((host, "cpu"), (card, cuda)):
        e = None if emb is None else emb.to(dev)
        full, _ = tfm.forward(cfg, params, tok.to(dev), embeds=e)
        last, cache = tfm.prefill(cfg, params, tok[:, :12].to(dev), embeds=e,
                                  max_len=n_prefix + 16)
        steps = [last]
        for t in (12, 13):
            lg, cache = tfm.decode_step(cfg, params, cache, tok[:, t : t + 1].to(dev),
                                        n_prefix + t)
            steps.append(lg[:, 0])
        outs.append((full, steps))
    (full_h, steps_h), (full_c, steps_c) = outs
    _card_close(full_c, full_h)
    for a, b in zip(steps_c, steps_h):
        _card_close(a, b)


@pytest.mark.parametrize("t", [1024, 4096])
def test_apply_moe_on_the_card_equals_cpu(cuda, t):
    """Dropless (T*k = 2,048) and capacity-dropping (T*k = 8,192) dispatch:
    the same experts chosen and dropped, outputs within tolerance."""
    cfg = dataclasses.replace(get_reduced("mixtral-8x22b"), dtype="float32",
                              capacity_factor=1.0)
    host = moe.make_moe_params(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(np.random.default_rng(t).standard_normal(
        (2, t // 2, cfg.d_model)).astype(np.float32))
    want, waux = moe.apply_moe(cfg, host, x)
    got, gaux = moe.apply_moe(cfg, {k: v.to(cuda) for k, v in host.items()}, x.to(cuda))
    assert torch.equal(gaux["expert_choice"].cpu(), waux["expert_choice"])
    assert float(gaux["dropped_frac"]) == float(waux["dropped_frac"])
    assert (float(waux["dropped_frac"]) > 0) == (t * cfg.top_k > 4096)
    _card_close(got, want)


@pytest.mark.parametrize("mode", ["ep_shardmap", "local"])
def test_moe_mesh_dispatch_on_the_card_equals_cpu(cuda, mode):
    """The mesh dispatches on a (2, 2) mesh of this card against the same
    mesh on the CPU: routing and drops equal, outputs within tolerance."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import shard_ctx

    cfg = dataclasses.replace(get_reduced("mixtral-8x22b"), dtype="float32",
                              moe_dispatch=mode, capacity_factor=1.0)
    host = moe.make_moe_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for t in (64, 9000):                       # dropless, and drops a shard
        x = torch.from_numpy(np.random.default_rng(t).standard_normal(
            (4, t // 4, cfg.d_model)).astype(np.float32))
        with shard_ctx.activation_sharding(Mesh((2, 2), ("data", "model"), ["cpu"] * 4)):
            want, waux = moe.apply_moe(cfg, host, x)
        with shard_ctx.activation_sharding(Mesh((2, 2), ("data", "model"), [cuda] * 4)):
            got, gaux = moe.apply_moe(cfg, {k: v.to(cuda) for k, v in host.items()},
                                      x.to(cuda))
        assert got.device.type == "cuda"
        assert float(gaux["dropped_frac"]) == float(waux["dropped_frac"])
        assert (float(waux["dropped_frac"]) > 0) == (t > 64)
        assert torch.equal(gaux["expert_choice"].cpu(), waux["expert_choice"])
        np.testing.assert_allclose(float(gaux["lb_loss"]), float(waux["lb_loss"]), rtol=1e-5)
        _card_close(got, want)


def test_trace_reader_reads_a_cuda_trace(cuda, tmp_path):
    """A real CUDA trace: the events and the exported chrome trace give the
    same kernels and launches, and the chrome trace the copies' bytes."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import trace_analysis as ta

    a = torch.randn(512, 512, device=cuda)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        b = a @ a
        host = b.cpu()
        back = torch.ones(1000).to(cuda)
        torch.cuda.synchronize()
    assert host.shape == (512, 512) and back.device.type == "cuda"
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev, js = ta.summarize(ta.read(prof)), ta.summarize(ta.read(path))
    assert ev["launches"] >= 1
    assert {k: v[1] for k, v in ev["kernels"].items()} == \
        {k: v[1] for k, v in js["kernels"].items()}
    assert js["memcpy"]["DtoH"]["bytes"] == 512 * 512 * 4
    assert js["memcpy"]["HtoD"]["bytes"] == 1000 * 4
    assert ev["memcpy"]["DtoH"]["count"] == 1 and ev["memcpy"]["DtoH"]["bytes"] is None
    for s in (ev, js):
        assert 0 < s["device_busy_s"] <= s["wall_s"] and 0 <= s["idle_share"] < 1
        assert s["device_busy_union_s"] <= s["device_busy_s"] + 1e-12
    assert "aten::mm" in ta.host_totals(ta.read(path))
