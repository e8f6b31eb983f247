"""Port parity: the hierarchy (core/hierarchy.py), the plain versions of K3
and K4, the threshold descent and KernelHierarchy.

The same numpy inputs go through the JAX reference and the port on the
CPU, with the reference's own hash draw handed to the port.  The oracles
are the reference's jnp paths (``update_jit``, ``hier_update_ref``,
``hier_candidate_query_ref`` / ``_batched_ref`` and the jnp descent).
Int32 tables: the tolerance is exact equality.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as rh
from repro.core import hierarchy as rhh
from repro.core import sketch as rsk
from repro.kernels import hier_query as rhq
from repro.kernels import hier_update as rhu
from repro.kernels import ops as rops
from repro.streams import group_candidates as r_group_candidates
from repro.streams import zipf_hh_workload as r_zipf_hh_workload
from repro_torch import interop
from repro_torch.core import hashing as ph
from repro_torch.core import hierarchy as phh
from repro_torch.core import sketch as psk
from repro_torch.kernels import _cuda
from repro_torch.kernels import hier_query as phq
from repro_torch.kernels import hier_update as phu
from repro_torch.kernels.ops import KernelHierarchy
from repro_torch.streams import group_candidates, zipf_hh_workload

DOMAINS = (1 << 32, 256, 1000, 70_000)
PARTITION = [(3, 1), (0,), (2,)]          # joint out-of-order group first
RANGES = (48, 90, 7)                      # level widths 48, 4320, 30240
KEY = jax.random.PRNGKey(3)


def _hspecs(domains=DOMAINS, partition=PARTITION, ranges=RANGES, w=3):
    rbase = rsk.mod_sketch_spec(rh.KeySchema(domains), partition, ranges, w)
    pbase = psk.mod_sketch_spec(ph.KeySchema(domains), partition, ranges, w)
    return rhh.HierarchySpec.from_spec(rbase), phh.HierarchySpec.from_spec(pbase)


def _states(rspec, pspec, key=KEY):
    """A reference init_hierarchy draw and the port's state on its params."""
    rstate = rhh.init_hierarchy(rspec, key)
    fine = rstate.states[-1].params
    pstate = phh.init_hierarchy(pspec, (np.asarray(fine.q), np.asarray(fine.r)),
                                device="cpu")
    return rstate, pstate


def _block(n, seed, domains=DOMAINS, zero_tail=True):
    rng = np.random.default_rng(seed)
    items = np.stack([rng.integers(0, d, n, dtype=np.uint64).astype(np.uint32)
                      for d in domains], axis=1)
    items[n // 10 : n // 4] = items[0]                  # heavy duplication
    freqs = rng.integers(1, 1 << 12, n).astype(np.int64)
    if zero_tail:
        freqs[-n // 8:] = 0                             # zero-frequency pads
    return items, freqs


def _assert_tables_equal(rstate, pstate):
    assert len(rstate.states) == len(pstate.states)
    for rs, ps in zip(rstate.states, pstate.states):
        np.testing.assert_array_equal(np.asarray(rs.table), ps.table.numpy())


def test_hierarchy_spec_matches_reference():
    rspec, pspec = _hspecs()
    assert repr(pspec) == repr(rspec)
    assert pspec.level_divisors == rspec.level_divisors == (630, 7, 1)
    assert pspec.table_cells == rspec.table_cells
    items, _ = _block(50, 0)
    for lvl in range(pspec.n_levels):
        np.testing.assert_array_equal(pspec.level_items(lvl, items),
                                      rspec.level_items(lvl, items))
    grouped = pspec.level_items(pspec.n_levels - 1, items)
    np.testing.assert_array_equal(pspec.to_schema_order(grouped),
                                  rspec.to_schema_order(grouped))
    np.testing.assert_array_equal(pspec.to_schema_order(grouped), items)


def test_level_params_share_prefix_and_refusals():
    rspec, pspec = _hspecs()
    _, pstate = _states(rspec, pspec)
    assert phh.params_share_prefix(pstate)
    fine = pstate.states[-1].params
    for lvl, st in enumerate(pstate.states):
        want = phh.level_params(pspec, fine, lvl)
        assert torch.equal(st.params.q, want.q) and torch.equal(st.params.r, want.r)
    # independently drawn per-level params: the cascade entry points refuse
    gen = torch.Generator().manual_seed(4)
    indep = phh.HierarchyState(states=tuple(
        psk.SketchState(params=psk.init_params(s, gen, "cpu"), table=st.table.clone())
        for s, st in zip(pspec.levels, pstate.states)))
    assert not phh.params_share_prefix(indep)
    items, freqs = _block(40, 1)
    for fn in (phh.update, phh.update_jit):
        with pytest.raises(ValueError, match="shared per-group hash family"):
            fn(pspec, indep, items, freqs)
    with pytest.raises(ValueError, match="shared per-group hash family"):
        phh.stage_indices(pspec, indep, items)
    with pytest.raises(ValueError, match="shared per-group hash family"):
        KernelHierarchy.from_state(pspec, indep)


def test_hierarchy_indices_match_reference():
    rspec, pspec = _hspecs()
    rstate, pstate = _states(rspec, pspec)
    items, _ = _block(700, 2)
    want = rhh.hierarchy_indices(rspec, rstate.states[-1].params, jnp.asarray(items))
    got = phh.hierarchy_indices(pspec, pstate.states[-1].params, items)
    for w_l, g_l in zip(want, got):
        assert g_l.dtype == torch.int64
        np.testing.assert_array_equal(np.asarray(w_l), g_l.numpy())


def test_update_paths_match_reference_update_jit():
    rspec, pspec = _hspecs()
    rstate, pstate = _states(rspec, pspec)
    p_ref = p_pure = pstate
    p_staged = phh.init_hierarchy(
        pspec, (pstate.states[-1].params.q, pstate.states[-1].params.r), device="cpu")
    for seed in range(3):                                   # multiple blocks
        items, freqs = _block(900, 10 + seed)
        rstate = rhh.update_jit(rspec, rstate, jnp.asarray(items), jnp.asarray(freqs))
        p_pure = phh.update(pspec, p_pure, items, freqs)
        p_ref = phh.update_reference(pspec, p_ref, items, freqs)
        p_staged = phh.fold_indices(p_staged, phh.stage_indices(pspec, p_staged, items),
                                    torch.from_numpy(freqs))
    for got in (p_pure, p_ref, p_staged):
        _assert_tables_equal(rstate, got)
    # update_jit folds in place, update returns new tables
    items, freqs = _block(100, 20)
    new = phh.update(pspec, p_staged, items, freqs)
    assert not torch.equal(new.states[-1].table, p_staged.states[-1].table)
    same = phh.update_jit(pspec, p_staged, items, freqs)
    assert same.states[-1].table is p_staged.states[-1].table
    _assert_tables_equal(new, same)


def test_build_and_merge_match_reference():
    rspec, pspec = _hspecs()
    rstate, _ = _states(rspec, pspec)
    fine = rstate.states[-1].params
    qr = (np.asarray(fine.q), np.asarray(fine.r))
    ia, fa = _block(2500, 30)
    ib, fb = _block(1200, 31)
    ra = rhh.build_hierarchy(rspec, KEY, ia, fa, block=1024)
    rb = rhh.build_hierarchy(rspec, KEY, ib, fb, block=1024)
    pa = phh.build_hierarchy(pspec, qr, ia, fa, block=1024, device="cpu")
    pb = phh.build_hierarchy(pspec, qr, ib, fb, block=1024, device="cpu")
    _assert_tables_equal(ra, pa)
    _assert_tables_equal(rhh.merge(ra, rb), phh.merge(pa, pb))


@pytest.mark.parametrize("tile_h", [128, 512])
def test_plain_k3_matches_reference_hier_update_ref(tile_h):
    """The K3 wrapper on CPU tensors takes its plain version; both are held
    against the reference's jnp oracle on the same concatenated table:
    duplicate keys, zero-frequency rows, several blocks, level widths that
    are not tile multiples."""
    rspec, pspec = _hspecs()
    rstate, pstate = _states(rspec, pspec)
    rplan, pplan = rhu.make_hier_plan(rspec, tile_h), phu.make_hier_plan(pspec, tile_h)
    assert pplan.level_pads == rplan.level_pads
    assert pplan.level_offsets == rplan.level_offsets
    assert pplan.level_divs == rplan.level_divs
    assert any(s % tile_h for s in pplan.level_sizes)
    fine = rstate.states[-1].params
    pq, pr = pstate.states[-1].params
    rng = np.random.default_rng(5)
    start = rng.integers(-(1 << 20), 1 << 20, (3, pplan.padded_cols)).astype(np.int32)
    want = jnp.asarray(start)
    got_wrap = torch.from_numpy(start.copy())
    got_ref = torch.from_numpy(start.copy())
    before = dict(_cuda.LAUNCHES)
    n_fine = pspec.n_levels - 1
    for seed in range(3):
        items, freqs = _block(1100, 40 + seed)
        ordered = rspec.level_items(n_fine, items)
        want = rhu.hier_update_ref(rplan, want,
                                   rspec.levels[-1].schema.module_chunks(jnp.asarray(ordered)),
                                   jnp.asarray(freqs), fine.q, fine.r)
        chunks = pspec.levels[-1].schema.module_chunks(
            torch.from_numpy(ordered.astype(np.int64)))
        f = torch.from_numpy(freqs)
        phu.hier_update(pplan, got_wrap, chunks, f, pq, pr)
        phu.hier_update_ref(pplan, got_ref, chunks, f, pq, pr)
    np.testing.assert_array_equal(np.asarray(want), got_wrap.numpy())
    np.testing.assert_array_equal(np.asarray(want), got_ref.numpy())
    assert dict(_cuda.LAUNCHES) == before                 # no kernel on CPU
    with pytest.raises(ValueError, match="plan expects"):
        phu.hier_update(pplan, got_wrap[:, :-1], chunks, f, pq, pr)


def test_make_hier_plan_refuses_wide_finest_level():
    schema = (1 << 32, 1 << 32)
    rspec, pspec = _hspecs(domains=schema, partition=[(0,), (1,)],
                           ranges=(1 << 16, 1 << 15))
    for make, spec in ((rhu.make_hier_plan, rspec), (phu.make_hier_plan, pspec)):
        with pytest.raises(ValueError, match="fit int32"):
            make(spec)


def _partials(rspec, pspec, rstate, pstate, level, n_pref, n_cand, seed):
    rng = np.random.default_rng(seed)
    mods = rhh.level_modules(rspec.base, level - 1) if level else ()
    prefixes = (np.stack([rng.integers(0, DOMAINS[m], n_pref, dtype=np.uint64)
                          .astype(np.uint32) for m in mods], axis=1)
                if level else np.zeros((1, 0), np.uint32))
    values = np.stack([rng.integers(0, DOMAINS[m], n_cand, dtype=np.uint64)
                       .astype(np.uint32) for m in PARTITION[level]], axis=1)
    rpp, rcp = rhh.candidate_partials(rspec, rstate, level, jnp.asarray(prefixes),
                                      jnp.asarray(values))
    ppp, pcp = phh.candidate_partials(pspec, pstate, level, prefixes, values)
    np.testing.assert_array_equal(np.asarray(rpp), ppp.numpy())
    np.testing.assert_array_equal(np.asarray(rcp), pcp.numpy())
    return rpp, rcp, ppp, pcp


@pytest.mark.parametrize("level", [0, 1, 2])
def test_plain_k4_and_batched_match_reference_refs(level):
    rspec, pspec = _hspecs()
    rstate, pstate = _states(rspec, pspec)
    items, freqs = _block(3000, 50)
    rstate = rhh.update_jit(rspec, rstate, jnp.asarray(items), jnp.asarray(freqs))
    pstate = phh.update_jit(pspec, pstate, items, freqs)
    rpp, rcp, ppp, pcp = _partials(rspec, pspec, rstate, pstate, level, 29, 41, 51)
    rt, pt = rstate.states[level].table, pstate.states[level].table
    want = np.asarray(rhq.hier_candidate_query_ref(rt, rpp, rcp))
    np.testing.assert_array_equal(want, phq.hier_candidate_query(pt, ppp, pcp).numpy())
    np.testing.assert_array_equal(want, phq.hier_candidate_query_ref(pt, ppp, pcp).numpy())
    rpp3 = jnp.stack([rpp, rpp[:, ::-1], rpp], axis=1)
    ppp3 = torch.stack([ppp, ppp.flip(1), ppp], dim=1)
    want3 = np.asarray(rhq.hier_candidate_query_batched_ref(rt, rpp3, rcp))
    np.testing.assert_array_equal(
        want3, phq.hier_candidate_query_batched(pt, ppp3, pcp).numpy())
    np.testing.assert_array_equal(
        want3, phq.hier_candidate_query_batched_ref(pt, ppp3, pcp).numpy())
    with pytest.raises(ValueError, match="int32 tables only"):
        phq.hier_candidate_query(pt.to(torch.int64), ppp, pcp)


@functools.lru_cache(maxsize=1)
def _hh_case():
    """A small zipf edge workload, built through both packages from the
    reference's hash draw."""
    rwl = r_zipf_hh_workload(n_src=300, n_tgt=600, n_edges=3000,
                             n_occurrences=40_000, seed=2)
    pwl = zipf_hh_workload(n_src=300, n_tgt=600, n_edges=3000,
                           n_occurrences=40_000, seed=2)
    np.testing.assert_array_equal(rwl.stream.items, pwl.stream.items)
    np.testing.assert_array_equal(rwl.stream.freqs, pwl.stream.freqs)
    np.testing.assert_array_equal(rwl.exact_items, pwl.exact_items)
    assert rwl.threshold == pwl.threshold
    rspec, pspec = _hspecs(domains=rwl.stream.schema.domains,
                           partition=[(0,), (1,)], ranges=(64, 32), w=4)
    rstate = rhh.build_hierarchy(rspec, KEY, rwl.stream.items, rwl.stream.freqs)
    fine = rstate.states[-1].params
    pstate = phh.build_hierarchy(pspec, (np.asarray(fine.q), np.asarray(fine.r)),
                                 pwl.stream.items, pwl.stream.freqs, device="cpu")
    _assert_tables_equal(rstate, pstate)
    rcand = r_group_candidates(rspec.base, rwl.stream.items)
    pcand = group_candidates(pspec.base, pwl.stream.items)
    for a, b in zip(rcand, pcand):
        np.testing.assert_array_equal(a, b)
    return rwl, rspec, pspec, rstate, pstate, pcand


@pytest.mark.parametrize("max_batch", [1 << 16, 700])
def test_find_heavy_hitters_matches_reference(max_batch):
    """Plain and K4-wrapper routes (the wrapper takes its plain version on
    CPU) against the reference's jnp descent, with and without prefix-axis
    chunking (max_batch=700 forces short, zero-padded chunks)."""
    wl, rspec, pspec, rstate, pstate, cand = _hh_case()
    for thr in (wl.threshold, 1 << 30):
        want = rhh.find_heavy_hitters(rspec, rstate, thr, cand, max_batch=max_batch)
        for use_kernel in (False, True):
            got = phh.find_heavy_hitters(pspec, pstate, thr, cand,
                                         use_kernel=use_kernel, max_batch=max_batch)
            assert got[0].dtype == np.uint32 and got[1].dtype == np.int64
            np.testing.assert_array_equal(want[0], got[0])
            np.testing.assert_array_equal(want[1], got[1])
    got_items, _ = phh.find_heavy_hitters(pspec, pstate, wl.threshold, cand)
    got_set = {tuple(r) for r in got_items}
    assert all(tuple(r) in got_set for r in wl.exact_items)   # no false negatives
    with pytest.raises(ValueError, match="one candidate set per level"):
        phh.find_heavy_hitters(pspec, pstate, 1, cand[:1])
    with pytest.raises(ValueError, match=r"candidates\[1\] must be"):
        phh.find_heavy_hitters(pspec, pstate, 1, [cand[0], cand[0][:, :0]])


@pytest.mark.parametrize("max_batch", [1 << 16, 900])
def test_batched_descent_matches_reference(max_batch):
    wl, rspec, pspec, rstate, pstate, cand = _hh_case()
    thrs = [wl.threshold, wl.threshold * 3, 1 << 30, wl.threshold // 2]
    want = rhh.batched_find_heavy_hitters(rspec, rstate, thrs, cand,
                                          max_batch=max_batch)
    for use_kernel in (False, True):
        got = phh.batched_find_heavy_hitters(pspec, pstate, thrs, cand,
                                             use_kernel=use_kernel,
                                             max_batch=max_batch)
        assert len(got) == len(want)
        for (wi, we), (gi, ge) in zip(want, got):
            np.testing.assert_array_equal(wi, gi)
            np.testing.assert_array_equal(we, ge)
    # batched level grids equal the reference's, request by request
    prefix_sets = [cand[0][:5], cand[0][3:20], cand[0][:1]]
    wgrids = rhh.batched_candidate_estimates(rspec, rstate, 1, prefix_sets, cand[1],
                                             max_batch=max_batch)
    ggrids = phh.batched_candidate_estimates(pspec, pstate, 1, prefix_sets, cand[1],
                                             use_kernel=True, max_batch=max_batch)
    for a, b in zip(wgrids, ggrids):
        np.testing.assert_array_equal(np.asarray(a), b)
    with pytest.raises(ValueError, match="non-empty prefix set"):
        phh.batched_candidate_estimates(pspec, pstate, 1, [cand[0][:0]], cand[1])


def test_kernel_hierarchy_from_reference_state():
    """A reference state crosses over as arrays (interop), is packed into
    the concatenated padded table, ingests on the plain K3 path and stays
    equal to the reference's update_jit; its state() view is cached until
    the next ingest and serves the descent unchanged."""
    rspec, pspec = _hspecs()
    rstate, _ = _states(rspec, pspec)
    items, freqs = _block(1500, 60)
    rstate = rhh.update_jit(rspec, rstate, jnp.asarray(items), jnp.asarray(freqs))
    fine = rstate.states[-1].params
    pstate = interop.hierarchy_state_from_numpy(
        pspec, np.asarray(fine.q), np.asarray(fine.r),
        [np.asarray(s.table) for s in rstate.states], device="cpu")
    kh = KernelHierarchy.from_state(pspec, pstate, tile_h=128, block_b=700)
    rkh = rops.KernelHierarchy.from_state(rspec, rstate, tile_h=128)
    np.testing.assert_array_equal(np.asarray(rkh.table), kh.table.numpy())
    view = kh.state()
    assert kh.state() is view
    _assert_tables_equal(rstate, view)
    items, freqs = _block(1600, 61)
    kh.update(items, freqs)
    assert kh.state() is not view
    rstate = rhh.update_jit(rspec, rstate, jnp.asarray(items), jnp.asarray(freqs))
    _assert_tables_equal(rstate, kh.state())
    with pytest.raises(ValueError, match="negative frequencies"):
        kh.update(items[:3], np.array([1, -1, 2]))
    with pytest.raises(ValueError, match="conservative hierarchies take"):
        KernelHierarchy(pspec, (fine.q, fine.r), device="cpu", mode="conservative")
    with pytest.raises(ValueError, match="need 3 level tables"):
        interop.hierarchy_state_from_numpy(pspec, np.asarray(fine.q),
                                           np.asarray(fine.r), [], device="cpu")


@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_plain_k3f_matches_reference_hier_update_ref_float32(values):
    """K3f's plain version (float32 concatenated table) against the
    reference's jnp oracle: exact on integer-valued frequencies, within
    float32 rounding (rtol 1e-6) on Gaussian ones; the float32
    ``KernelHierarchy`` folds the same table."""
    rspec, pspec = _hspecs()
    rstate, pstate = _states(rspec, pspec)
    rplan, pplan = rhu.make_hier_plan(rspec, 128), phu.make_hier_plan(pspec, 128)
    fine = rstate.states[-1].params
    pq, pr = pstate.states[-1].params
    rng = np.random.default_rng(15)
    start = rng.integers(-50, 50, (3, pplan.padded_cols)).astype(np.float32)
    want, got = jnp.asarray(start), torch.from_numpy(start.copy())
    kh = KernelHierarchy(pspec, (pq, pr), tile_h=128, dtype=torch.float32,
                         device="cpu")
    kh.table = torch.from_numpy(start.copy())
    before = dict(_cuda.LAUNCHES)
    n_fine = pspec.n_levels - 1
    for seed in range(2):
        items, freqs = _block(700, 60 + seed)
        if values == "gaussian":
            freqs = rng.standard_normal(freqs.shape) * 10
        freqs = freqs.astype(np.float32)
        ordered = rspec.level_items(n_fine, items)
        want = rhu.hier_update_ref(rplan, want,
                                   rspec.levels[-1].schema.module_chunks(jnp.asarray(ordered)),
                                   jnp.asarray(freqs), fine.q, fine.r)
        chunks = pspec.levels[-1].schema.module_chunks(
            torch.from_numpy(ordered.astype(np.int64)))
        phu.hier_update(pplan, got, chunks, torch.from_numpy(freqs), pq, pr)
        kh.update(items, freqs)
    for table in (got, kh.table):
        assert table.dtype == torch.float32
        if values == "integer":
            np.testing.assert_array_equal(table.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(table.numpy(), np.asarray(want), rtol=1e-6,
                                       atol=1e-6 * float(np.abs(want).max()))
    assert dict(_cuda.LAUNCHES) == before
