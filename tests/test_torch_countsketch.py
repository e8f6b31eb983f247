"""Port parity: the signed Count-Sketch path (core/countsketch.py), the
plain versions of K6-K9 and the signed modes of KernelSketch and
KernelHierarchy.

The same numpy inputs go through the JAX reference and the port on the
CPU, with the reference's own hash draw (bucket AND sign params) handed to
the port through ``repro_torch.interop``.  The oracles are the reference's
jnp paths (``core.countsketch``, ``hier_update_signed_ref``,
``hier_candidate_query_signed_ref``), never its Pallas kernels.  Int32
tables: the tolerance is exact equality, for odd and even w and for
negative (turnstile) frequencies.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import countsketch as rcs
from repro.core import hashing as rh
from repro.core import hierarchy as rhh
from repro.core import sketch as rsk
from repro.kernels import hier_query as rhq
from repro.kernels import hier_update as rhu
from repro.kernels import ops as rops
from repro.kernels.hashes import make_plan as r_make_plan
from repro.kernels.hashes import row_sign_bits as r_row_sign_bits
from repro_torch import interop
from repro_torch.core import countsketch as pcs
from repro_torch.core import hashing as ph
from repro_torch.core import hierarchy as phh
from repro_torch.core import sketch as psk
from repro_torch.kernels import _cuda
from repro_torch.kernels import hier_query as phq
from repro_torch.kernels import hier_update as phu
from repro_torch.kernels import sketch_query as psq
from repro_torch.kernels import sketch_update as psu
from repro_torch.kernels.hashes import all_sign_bits, make_plan, row_sign_bits
from repro_torch.kernels.ops import KernelHierarchy, KernelSketch
from repro_torch.launch.mesh import Mesh

DOMAINS = (1 << 32, 256, 1000, 70_000)
PARTITION = [(3, 1), (0,), (2,)]          # joint out-of-order group first
RANGES = (48, 90, 7)                      # level widths 48, 4320, 30240
WIDTHS = (3, 4, 5)


def _specs(w, partition=PARTITION, ranges=RANGES):
    rbase = rsk.mod_sketch_spec(rh.KeySchema(DOMAINS), partition, ranges, w)
    pbase = psk.mod_sketch_spec(ph.KeySchema(DOMAINS), partition, ranges, w)
    return rbase, pbase


def _hspecs(w):
    rbase, pbase = _specs(w)
    return rhh.HierarchySpec.from_spec(rbase), phh.HierarchySpec.from_spec(pbase)


def _arrays(rparams):
    return (np.asarray(rparams.base.q), np.asarray(rparams.base.r),
            np.asarray(rparams.sign_q), np.asarray(rparams.sign_r))


def _params(rspec, seed=0):
    """A reference draw and the port's params on the same arrays."""
    rp = rcs.init_params(rspec, jax.random.PRNGKey(seed))
    return rp, interop.countsketch_params_from_numpy(*_arrays(rp), device="cpu")


def _block(n, seed, fmax=1 << 12):
    """Keys with heavy duplication and frequencies of both signs."""
    rng = np.random.default_rng(seed)
    items = np.stack([rng.integers(0, d, n, dtype=np.uint64).astype(np.uint32)
                      for d in DOMAINS], axis=1)
    items[n // 10 : n // 4] = items[0]
    freqs = rng.integers(-fmax, fmax, n).astype(np.int64)
    freqs[-n // 8:] = 0
    return items, freqs


def _zeros(spec, dtype=jnp.int32):
    return jnp.zeros((spec.width, spec.table_size), dtype)


def _eq(want, got):
    np.testing.assert_array_equal(np.asarray(want), got.numpy() if
                                  isinstance(got, torch.Tensor) else got)


# --------------------------------------------------------------------------
# signs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("w", WIDTHS)
def test_sign_bits_and_group_parity_match_reference(w):
    rspec, pspec = _specs(w)
    rp, pp = _params(rspec, w)
    items, _ = _block(400, w)
    bits = pcs.sign_bits(pspec, pp, items)
    assert bits.dtype == torch.int64
    _eq(rcs.sign_bits(rspec, rp, jnp.asarray(items)), bits)
    _eq(rcs.signs(rspec, rp, jnp.asarray(items)), pcs.signs(pspec, pp, items))
    for lvl in range(pspec.n_groups):
        _eq(rcs.signs_from_bits(rcs.sign_bits(rspec, rp, jnp.asarray(items)), lvl),
            pcs.signs_from_bits(bits, lvl))
    for g, mods in enumerate(pspec.partition):
        vals = items[:, list(mods)]
        _eq(rcs.group_sign_parity(rspec, rp, g, jnp.asarray(vals)),
            pcs.group_sign_parity(pspec, pp, g, vals))
    # the kernels' plain helper agrees with the core's, and row by row with
    # the reference's kernel-side helper
    chunks = pspec.schema.module_chunks(torch.from_numpy(items.astype(np.int64)))
    assert torch.equal(all_sign_bits(make_plan(pspec), chunks, pp.sign_q, pp.sign_r),
                       bits)
    rchunks = jnp.asarray(rspec.schema.module_chunks_np(items))
    for k in range(w):
        _eq(r_row_sign_bits(r_make_plan(rspec), rchunks, rp.sign_q[k], rp.sign_r[k]),
            row_sign_bits(make_plan(pspec), chunks, pp.sign_q[k], pp.sign_r[k]))


def test_resolve_params_takes_generators_arrays_and_params():
    _, pspec = _specs(3)
    drawn = pcs.resolve_params(pspec, torch.Generator().manual_seed(0), "cpu")
    assert drawn.sign_q.shape == (3, pspec.schema.total_chunks)
    assert drawn.sign_r.shape == (3, pspec.n_groups)
    assert int(drawn.sign_q.max()) < int(ph.P31)
    again = pcs.resolve_params(pspec, drawn, "cpu")
    arrays = pcs.resolve_params(pspec, (drawn.base.q.numpy(), drawn.base.r.numpy(),
                                        drawn.sign_q.numpy(), drawn.sign_r.numpy()), "cpu")
    for got in (again, arrays):
        assert all(torch.equal(a, b) for a, b in
                   zip((*got.base, got.sign_q, got.sign_r),
                       (*drawn.base, drawn.sign_q, drawn.sign_r)))
    with pytest.raises(ValueError, match="hash params have shapes"):
        pcs.resolve_params(pspec, (drawn.base.q, drawn.base.r, drawn.sign_q[:, :1],
                                   drawn.sign_r), "cpu")


# --------------------------------------------------------------------------
# flat sketch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("w", WIDTHS)
def test_update_query_rows_match_reference(w):
    rspec, pspec = _specs(w)
    rp, pp = _params(rspec, 10 + w)
    rstate = rcs.CountSketchState(rp, _zeros(rspec))
    pstate = pcs.init_state(pspec, pp, dtype=torch.int32, device="cpu")
    for seed in range(3):
        items, freqs = _block(500, 20 + seed)
        rstate = rcs.update(rspec, rstate, jnp.asarray(items), jnp.asarray(freqs))
        pstate = pcs.update(pspec, pstate, items, freqs)
        _eq(rstate.table, pstate.table)
    assert int(pstate.table.min()) < 0 < int(pstate.table.max())
    queries, _ = _block(300, 30)
    rrows, rmed = rcs.query_rows(rspec, rstate, jnp.asarray(queries))
    prows, pmed = pcs.query_rows(pspec, pstate, queries)
    assert prows.dtype == pmed.dtype == torch.float32
    _eq(rrows, prows)
    _eq(rmed, pmed)
    _eq(rcs.query(rspec, rstate, jnp.asarray(queries)),
        pcs.query(pspec, pstate, queries))


@pytest.mark.parametrize("w", WIDTHS)
def test_median_of_rows_near_2_24_matches_reference(w):
    """Rows whose two middle values sum past 2^24 round in float32: the
    port averages them as jnp.median does, not as torch.median would."""
    rspec, pspec = _specs(w, partition=[(0, 1, 2, 3)], ranges=(64,))
    rp, pp = _params(rspec, 40 + w)
    rng = np.random.default_rng(w)
    table = rng.integers((1 << 24) - 64, (1 << 24) + 64, (w, 64)).astype(np.int32)
    table[:, ::3] *= -1
    table[:, 1] = [3, 16777215, -7, 16777213, 1][:w]
    rstate = rcs.CountSketchState(rp, jnp.asarray(table))
    pstate = pcs.CountSketchState(pp, torch.from_numpy(table))
    items, _ = _block(400, 50 + w)
    _eq(rcs.query(rspec, rstate, jnp.asarray(items)), pcs.query(pspec, pstate, items))
    rows = torch.from_numpy(table[:, 1:2].astype(np.float32))
    _eq(jnp.median(jnp.asarray(rows.numpy()), axis=0), pcs.median_rows(rows))
    if w == 4:
        assert float(pcs.median_rows(rows)[0]) == 8388608.0
        assert float(torch.median(rows, dim=0).values[0]) == 3.0


@pytest.mark.parametrize("w", range(1, 10))
def test_median_of_rows_with_nan_and_inf_matches_reference(w):
    """A column that holds a NaN has median NaN, as jnp.median gives it;
    +-inf sort as values (inf - inf in the even-w midpoint is NaN too)."""
    nan, inf = np.nan, np.inf
    example = np.array([[1, 5, inf, -inf], [2, nan, inf, 1], [nan, 7, -inf, 2]],
                       np.float32)
    rng = np.random.default_rng(70 + w)
    rows = rng.integers(-50, 50, (w, 40)).astype(np.float32)
    rows[:, :4] = np.resize(example, (w, 4))
    rows[:, 4] = np.resize([inf, -inf], w)             # inf and -inf, no NaN
    rows[:, 5] = np.resize([inf, 3], w)
    rows[:, 6] = np.resize([-inf, -inf, 1, -inf, 2], w)
    for c in range(7, 40):                             # a NaN in some rows
        k = int(rng.integers(0, w + 2))
        if k < w:
            rows[k, c] = nan
            if c % 3 == 0:
                rows[(k + 1) % w, c] = rng.choice([inf, -inf, nan])
    if w == 3:
        _eq(jnp.median(jnp.asarray(example), axis=0), np.array([nan, nan, inf, 1]))
        _eq(np.array([nan, nan, inf, 1], np.float32),
            pcs.median_rows(torch.from_numpy(example)))
    _eq(jnp.median(jnp.asarray(rows), axis=0), pcs.median_rows(torch.from_numpy(rows)))


@pytest.mark.parametrize("w", range(1, 10))
def test_median_of_rows_matches_reference_for_every_w(w):
    """The comparator network gives jnp.median's order statistics and
    float32 midpoint for odd and even w: int32 rows (cast first, as jnp
    promotes them) with ties, cells near +-2^24 whose midpoints round, and
    cells near +-2^31; and float32 rows of mixed signs and zeros."""
    rng = np.random.default_rng(80 + w)
    ints = rng.integers(-3, 4, (w, 300)).astype(np.int64)
    ints[:, 100:200] += (1 << 24) * rng.choice([-1, 1], (w, 100))
    ints[:, 200:] = rng.integers(-(1 << 31), 1 << 31, (w, 100))
    ints = ints.astype(np.int32)
    _eq(jnp.median(jnp.asarray(ints), axis=0), pcs.median_rows(torch.from_numpy(ints)))
    floats = (rng.standard_normal((w, 300)) * 1e3).astype(np.float32)
    floats[:, ::5] = 0.0
    floats[:, 1::7] = -0.0
    _eq(jnp.median(jnp.asarray(floats), axis=0), pcs.median_rows(torch.from_numpy(floats)))


def test_l2estimate_and_merge_match_reference():
    rspec, pspec = _specs(4)
    rp, pp = _params(rspec, 60)
    ra, rb = rcs.CountSketchState(rp, _zeros(rspec)), rcs.CountSketchState(rp, _zeros(rspec))
    pa = pcs.init_state(pspec, pp, dtype=torch.int32, device="cpu")
    pb = pcs.init_state(pspec, pp, dtype=torch.int32, device="cpu")
    ia, fa = _block(600, 61, fmax=40)
    ib, fb = _block(600, 62, fmax=40)
    ra, pa = (rcs.update(rspec, ra, jnp.asarray(ia), jnp.asarray(fa)),
              pcs.update(pspec, pa, ia, fa))
    rb, pb = (rcs.update(rspec, rb, jnp.asarray(ib), jnp.asarray(fb)),
              pcs.update(pspec, pb, ib, fb))
    _eq(rcs.merge(ra, rb).table, pcs.merge(pa, pb).table)
    both = pcs.update(pspec, pa, ib, fb)
    assert torch.equal(pcs.merge(pa, pb).table, both.table)     # linearity
    # every partial sum of squares is an integer below 2^24 here, so the
    # float32 row sums are exact in any order of addition
    assert float(torch.square(both.table.double()).sum(dim=1).max()) < (1 << 24)
    _eq(rcs.l2estimate(rcs.merge(ra, rb).table), pcs.l2estimate(both.table))


# --------------------------------------------------------------------------
# hierarchy
# --------------------------------------------------------------------------

def _hier_states(rhspec, phspec, seed, dtype=jnp.int32):
    rp = rcs.init_params(rhspec.levels[-1], jax.random.PRNGKey(seed))
    rstate = rcs.CountSketchHierarchy(
        rp, tuple(_zeros(s, dtype) for s in rhspec.levels))
    pstate = interop.countsketch_hierarchy_from_numpy(
        phspec, *_arrays(rp), [np.asarray(t) for t in rstate.tables], device="cpu")
    return rstate, pstate


def _tables_eq(rstate, pstate):
    assert len(rstate.tables) == len(pstate.tables)
    for want, got in zip(rstate.tables, pstate.tables):
        _eq(want, got)


@pytest.mark.parametrize("w", WIDTHS)
def test_hier_update_matches_reference_and_oracle(w):
    rhspec, phspec = _hspecs(w)
    rstate, pstate = _hier_states(rhspec, phspec, 70 + w)
    r_or, p_or = rstate, pstate
    for seed in range(2):
        items, freqs = _block(700, 80 + seed)
        rstate = rcs.hier_update(rhspec, rstate, jnp.asarray(items), jnp.asarray(freqs))
        r_or = rcs.hier_update_reference(rhspec, r_or, jnp.asarray(items),
                                         jnp.asarray(freqs))
        pstate = pcs.hier_update(phspec, pstate, items, freqs)
        p_or = pcs.hier_update_reference(phspec, p_or, items, freqs)
    _tables_eq(rstate, pstate)
    _tables_eq(r_or, p_or)
    _tables_eq(rstate, p_or)
    _tables_eq(rcs.hier_merge(rstate, r_or), pcs.hier_merge(pstate, p_or))
    items, _ = _block(200, 90)
    for lvl in range(phspec.n_levels):
        prefixes = phspec.level_items(lvl, items)
        _eq(rcs.hier_query(rhspec, rstate, lvl, jnp.asarray(prefixes)),
            pcs.hier_query(phspec, pstate, lvl, prefixes))


def test_interop_carries_the_reference_hierarchy():
    rhspec, phspec = _hspecs(3)
    rstate, _ = _hier_states(rhspec, phspec, 95)
    items, freqs = _block(500, 96)
    rstate = rcs.hier_update(rhspec, rstate, jnp.asarray(items), jnp.asarray(freqs))
    pstate = interop.countsketch_hierarchy_from_numpy(
        phspec, *_arrays(rstate.params), [np.asarray(t) for t in rstate.tables],
        device="cpu")
    _tables_eq(rstate, pstate)
    for lvl in range(phspec.n_levels):
        rl = rcs.level_params(rhspec, rstate.params, lvl)
        pl = pcs.level_params(phspec, pstate.params, lvl)
        for want, got in zip(_arrays(rl), (*pl.base, pl.sign_q, pl.sign_r)):
            _eq(want, got)
    with pytest.raises(ValueError, match="level tables"):
        interop.countsketch_hierarchy_from_numpy(
            phspec, *_arrays(rstate.params), [np.asarray(rstate.tables[0])],
            device="cpu")


# --------------------------------------------------------------------------
# plain versions of K6-K9
# --------------------------------------------------------------------------

@pytest.mark.parametrize("w", WIDTHS)
def test_plain_k6_k7_match_core(w):
    rspec, pspec = _specs(w)
    rp, pp = _params(rspec, 100 + w)
    plan = make_plan(pspec)
    h_pad = psu.padded_table_size(pspec.table_size, 128)
    items, freqs = _block(900, 101)
    chunks = pspec.schema.module_chunks(torch.from_numpy(items.astype(np.int64)))
    q, r = pp.base
    before = dict(_cuda.LAUNCHES)
    table = psu.sketch_update_signed(
        plan, torch.zeros((w, h_pad), dtype=torch.int32), chunks,
        torch.from_numpy(freqs), q, r, pp.sign_q, pp.sign_r)
    rstate = rcs.update(rspec, rcs.CountSketchState(rp, _zeros(rspec)),
                        jnp.asarray(items), jnp.asarray(freqs))
    _eq(rstate.table, table[:, : pspec.table_size])
    assert int(table[:, pspec.table_size:].abs().sum()) == 0
    rows = psq.sketch_query_signed(plan, table, chunks[:300], q, r, pp.sign_q,
                                   pp.sign_r)
    assert rows.dtype == torch.int32 and rows.shape == (w, 300)
    rrows, _ = rcs.query_rows(rspec, rstate, jnp.asarray(items[:300]))
    _eq(rrows, rows.to(torch.float32))
    assert dict(_cuda.LAUNCHES) == before           # CPU tensors: no launch


@pytest.mark.parametrize("bad,match", [
    (None, None), ("sq_int32", "must be int64"), ("sr_int32", "must be int64"),
    ("sq_shape", "shapes"), ("sr_shape", "shapes"), ("sq_strided", "sq must be contiguous"),
    ("sr_strided", "sr must be contiguous")])
def test_signed_kernels_check_sign_params_beside_q_and_r(bad, match):
    """The signed kernels' wrappers (K6-K8) check the sign params once,
    beside q and r, and hold them to the same rules: int64, q's and r's
    shapes, contiguous, on the table's device."""
    rspec, pspec = _specs(3)
    _, pp = _params(rspec, 140)
    plan = make_plan(pspec)
    items, _ = _block(40, 141)
    chunks = pspec.schema.module_chunks(torch.from_numpy(items.astype(np.int64)))
    table = torch.zeros((3, psu.padded_table_size(pspec.table_size, 128)), dtype=torch.int32)
    q, r = pp.base
    signs = {"sq": pp.sign_q, "sr": pp.sign_r}
    if bad is not None:
        name, what = bad.split("_")
        t = signs[name]
        signs[name] = {"int32": t.to(torch.int32), "shape": t[:, :-1].contiguous(),
                       "strided": t.repeat(1, 2)[:, ::2]}[what]
    check = lambda: _cuda.require_hash_inputs(  # noqa: E731
        "k6", plan, table, chunks, q, r, _cuda.FOLD_DTYPES, (signs["sq"], signs["sr"]))
    if bad is None:
        check()
    else:
        with pytest.raises(ValueError, match=match):
            check()


@pytest.mark.parametrize("w", WIDTHS)
def test_plain_k8_matches_reference_oracle(w):
    rhspec, phspec = _hspecs(w)
    rp = rcs.init_params(rhspec.levels[-1], jax.random.PRNGKey(110 + w))
    q, r, sq, sr = (torch.from_numpy(a.astype(np.int64)) for a in _arrays(rp))
    rplan, pplan = rhu.make_hier_plan(rhspec, 128), phu.make_hier_plan(phspec, 128)
    assert pplan.level_offsets == rplan.level_offsets
    rng = np.random.default_rng(w)
    start = rng.integers(-(1 << 20), 1 << 20, (w, pplan.padded_cols)).astype(np.int32)
    want = jnp.asarray(start)
    got = torch.from_numpy(start.copy())
    for seed in range(2):
        items, freqs = _block(800, 111 + seed)
        ordered = phspec.level_items(phspec.n_levels - 1, items)
        rchunks = jnp.asarray(rhspec.levels[-1].schema.module_chunks_np(ordered))
        pchunks = phspec.levels[-1].schema.module_chunks(
            torch.from_numpy(ordered.astype(np.int64)))
        want = rhu.hier_update_signed_ref(rplan, want, rchunks, jnp.asarray(freqs),
                                          rp.base.q, rp.base.r, rp.sign_q, rp.sign_r)
        phu.hier_update_signed(pplan, got, pchunks, torch.from_numpy(freqs), q, r, sq, sr)
    _eq(want, got)


def _grid_inputs(phspec, level, n_pref, n_vals, seed):
    rng = np.random.default_rng(seed)
    mods = phh.level_modules(phspec.base, level - 1) if level else ()
    prefixes = (np.stack([rng.integers(0, DOMAINS[m], n_pref, dtype=np.uint64)
                          .astype(np.uint32) for m in mods], axis=1)
                if level else np.zeros((1, 0), np.uint32))
    values = np.stack([rng.integers(0, DOMAINS[m], n_vals, dtype=np.uint64)
                       .astype(np.uint32) for m in phspec.base.partition[level]],
                      axis=1)
    return prefixes, values


@pytest.mark.parametrize("w", WIDTHS)
def test_plain_k9_and_signed_partials_match_reference(w):
    rhspec, phspec = _hspecs(w)
    rstate, pstate = _hier_states(rhspec, phspec, 120 + w)
    items, freqs = _block(900, 121)
    rstate = rcs.hier_update(rhspec, rstate, jnp.asarray(items), jnp.asarray(freqs))
    pstate = pcs.hier_update(phspec, pstate, items, freqs)
    for level in range(phspec.n_levels):
        prefixes, values = _grid_inputs(phspec, level, 13, 17, level)
        want = rcs.candidate_signed_partials(rhspec, rstate.params, level,
                                             jnp.asarray(prefixes), jnp.asarray(values))
        got = pcs.candidate_signed_partials(phspec, pstate.params, level,
                                            prefixes, values)
        for a, b in zip(want, got):
            _eq(a, b)
        pp, cp, sp, sc = got
        assert sp.dtype == sc.dtype == torch.float32
        grid = phq.hier_candidate_query_signed(pstate.tables[level], pp, cp, sp, sc)
        _eq(rhq.hier_candidate_query_signed_ref(rstate.tables[level], *want), grid)


def test_grid_sign_is_bit_l_of_the_full_key():
    """sp (the prefix's own top sign bit) times sc (one group's parity)
    equals bit L of the full key's packed bits, because parities XOR."""
    _, phspec = _hspecs(4)
    params = pcs.resolve_params(phspec.levels[-1], torch.Generator().manual_seed(3),
                                "cpu")
    items, _ = _block(60, 130)
    fine = phspec.levels[-1]
    bits = pcs.sign_bits(fine, params, phspec.level_items(phspec.n_levels - 1, items))
    for level in range(phspec.n_levels):
        prefixes = phspec.level_items(level - 1, items) if level else np.zeros((60, 0),
                                                                                np.uint32)
        values = items[:, list(phspec.base.partition[level])]
        pp, cp, sp, sc = pcs.candidate_signed_partials(phspec, params, level,
                                                       prefixes, values)
        diag = torch.arange(60)
        got = sp[:, diag] * sc[:, diag]                      # child (i, i) = key i
        assert torch.equal(got, pcs.signs_from_bits(bits, level))
        lvl_idx = phh.hierarchy_indices(phspec, params.base, items)[level]
        assert torch.equal(pp[:, diag] + cp[:, diag], lvl_idx)


# --------------------------------------------------------------------------
# descent
# --------------------------------------------------------------------------

def _turnstile(n_keys, seed):
    """An insert stream of light keys and six heavy ones, with half its
    light keys deleted whole, the rows of both signs shuffled together."""
    rng = np.random.default_rng(seed)
    keys, _ = _block(n_keys, seed)
    keys = np.unique(keys, axis=0)
    keys = keys[rng.permutation(keys.shape[0])]
    f = rng.integers(1, 300, keys.shape[0]).astype(np.int64)
    f[:6] = (60_000, 45_000, 30_000, 25_000, 20_000, 15_000)
    gone = rng.random(keys.shape[0]) < 0.5
    gone[:6] = False
    items = np.concatenate([keys, keys[gone]])
    freqs = np.concatenate([f, -f[gone]])
    order = rng.permutation(items.shape[0])
    return items[order], freqs[order], keys[~gone], f[~gone]


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("max_batch", [None, 40])
def test_candidate_estimates_match_reference(w, max_batch):
    rhspec, phspec = _hspecs(w)
    rstate, pstate = _hier_states(rhspec, phspec, 140 + w)
    items, freqs, _, _ = _turnstile(800, 141)
    rstate = rcs.hier_update(rhspec, rstate, jnp.asarray(items), jnp.asarray(freqs))
    pstate = pcs.hier_update(phspec, pstate, items, freqs)
    for level in range(phspec.n_levels):
        prefixes, values = _grid_inputs(phspec, level, 11, 9, 142 + level)
        want = rcs.candidate_estimates(rhspec, rstate, level, prefixes, values,
                                       max_batch=max_batch)
        for use_kernel in (False, True):            # CPU: both take the plain grid
            got = pcs.candidate_estimates(phspec, pstate, level, prefixes, values,
                                          use_kernel=use_kernel, max_batch=max_batch)
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("w", WIDTHS)
def test_find_heavy_hitters_on_a_turnstile_block_matches_reference(w):
    rhspec, phspec = _hspecs(w)
    rstate, pstate = _hier_states(rhspec, phspec, 150 + w)
    items, freqs, kept, kept_f = _turnstile(1500, 151)
    rstate = rcs.hier_update(rhspec, rstate, jnp.asarray(items), jnp.asarray(freqs))
    pstate = pcs.hier_update(phspec, pstate, items, freqs)
    thr = 0.01 * kept_f.sum()
    cands = [np.unique(items[:, list(g)], axis=0) for g in phspec.base.partition]
    want = rcs.find_heavy_hitters(rhspec, rstate, thr, cands, max_batch=256)
    for use_kernel in (False, True):
        got = pcs.find_heavy_hitters(phspec, pstate, thr, cands,
                                     use_kernel=use_kernel, max_batch=256)
        assert got[0].dtype == np.uint32 and got[1].dtype == np.float32
        np.testing.assert_array_equal(want[0], got[0])      # items and order
        np.testing.assert_array_equal(want[1], got[1])
    found = {tuple(k) for k in want[0].tolist()}
    assert {tuple(k) for k in kept[:6].tolist()} <= found    # the six heavy keys
    # deletion cancels exactly: the stream's tables are the kept half's
    only = pcs.hier_update(phspec, pcs.init_hierarchy(
        phspec, pstate.params, dtype=torch.int32, device="cpu"), kept, kept_f)
    for a, b in zip(only.tables, pstate.tables):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="one candidate set per level"):
        pcs.find_heavy_hitters(phspec, pstate, thr, cands[:1])
    empty = pcs.find_heavy_hitters(phspec, pstate, thr,
                                   [cands[0][:0]] + cands[1:])
    assert empty[0].shape == (0, len(DOMAINS)) and empty[1].dtype == np.float32


# --------------------------------------------------------------------------
# KernelSketch / KernelHierarchy, signed mode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("w", WIDTHS)
def test_kernel_sketch_signed_matches_core(w):
    rspec, pspec = _specs(w)
    rp, pp = _params(rspec, 160 + w)
    ks = KernelSketch(pspec, _arrays(rp), tile_h=128, block_b=300, device="cpu",
                      mode="signed")
    rstate = rcs.CountSketchState(rp, _zeros(rspec))
    for seed in range(2):
        items, freqs = _block(700, 161 + seed)
        ks.update(items, freqs)
        rstate = rcs.update(rspec, rstate, jnp.asarray(items), jnp.asarray(freqs))
    _eq(rstate.table, ks.cs_state().table)
    _eq(rstate.table, ks.table_view())
    queries, _ = _block(250, 163)
    rrows, rmed = rcs.query_rows(rspec, rstate, jnp.asarray(queries))
    rows = ks.query_rows(queries)
    assert rows.dtype == np.int32
    _eq(rrows, rows.astype(np.float32))
    est = ks.query(queries)
    assert est.dtype == np.float32
    _eq(rmed, est)
    other = KernelSketch(pspec, pp, tile_h=128, device="cpu", mode="signed")
    other.update(queries, np.full(250, -3))
    ks.merge(other)
    rstate = rcs.update(rspec, rstate, jnp.asarray(queries), jnp.full(250, -3))
    _eq(rstate.table, ks.cs_state().table)


def test_kernel_sketch_signed_float32_on_cpu_matches_reference_core():
    rspec, pspec = _specs(4)
    rp, pp = _params(rspec, 170)
    ks = KernelSketch(pspec, pp, tile_h=128, dtype=torch.float32, device="cpu",
                      mode="signed")
    items, _ = _block(500, 171)
    freqs = np.random.default_rng(172).normal(0, 3.0, 500).astype(np.float32)
    ks.update(items, freqs)
    rstate = rcs.update(rspec, rcs.CountSketchState(rp, _zeros(rspec, jnp.float32)),
                        jnp.asarray(items), jnp.asarray(freqs))
    np.testing.assert_allclose(np.asarray(rstate.table), ks.table_view(),
                               rtol=1e-6, atol=1e-5)   # float32 sums, other order
    rrows, _ = rcs.query_rows(rspec, rcs.CountSketchState(rp, jnp.asarray(
        ks.table_view())), jnp.asarray(items[:50]))
    _eq(rrows, ks.query_rows(items[:50]))


@pytest.mark.parametrize("w", WIDTHS)
def test_kernel_hierarchy_signed_matches_core(w):
    rhspec, phspec = _hspecs(w)
    rstate, _ = _hier_states(rhspec, phspec, 180 + w)
    kh = KernelHierarchy(phspec, _arrays(rstate.params), tile_h=128, block_b=400,
                         device="cpu", mode="signed")
    items, freqs, _, kept_f = _turnstile(400, 181)
    kh.update(items, freqs)
    rstate = rcs.hier_update(rhspec, rstate, jnp.asarray(items), jnp.asarray(freqs))
    view = kh.cs_state()
    assert view is kh.cs_state()                          # cached until ingest
    for t in view.tables:
        assert t.data_ptr() >= kh.table.data_ptr()        # views, not copies
        assert t.untyped_storage().data_ptr() == kh.table.untyped_storage().data_ptr()
    _tables_eq(rstate, view)
    thr = 0.01 * kept_f.sum()
    cands = [np.unique(items[:, list(g)], axis=0) for g in phspec.base.partition]
    want = rcs.find_heavy_hitters(rhspec, rstate, thr, cands)
    got = pcs.find_heavy_hitters(phspec, view, thr, cands, use_kernel=True)
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_array_equal(want[1], got[1])
    kh.update(items[:10], freqs[:10])
    assert kh.cs_state() is not view


def test_signed_state_dict_round_trips_with_reference():
    rspec, pspec = _specs(4)
    rp, pp = _params(rspec, 190)
    port = KernelSketch(pspec, pp, tile_h=128, device="cpu", mode="signed")
    items, freqs = _block(800, 191)
    port.update(items, freqs)
    ref = rops.KernelSketch(rspec, jax.random.PRNGKey(7), tile_h=128,
                            mode="signed")                    # other params
    ref.load_state_dict(port.state_dict())
    np.testing.assert_array_equal(ref.table_view(), port.table_view())
    for want, got in zip(_arrays(ref.cs_params), (*pp.base, pp.sign_q, pp.sign_r)):
        _eq(want, got)
    rsd = ref.state_dict()
    back = KernelSketch(pspec, torch.Generator().manual_seed(9), tile_h=128,
                        device="cpu", mode="signed")
    back.load_state_dict(rsd)
    psd = back.state_dict()
    assert rsd.keys() == psd.keys() == {"meta.fingerprint", "table", "params.q",
                                        "params.r", "params.sign_q", "params.sign_r"}
    for k in rsd:
        assert rsd[k].dtype == psd[k].dtype, k
        np.testing.assert_array_equal(rsd[k], psd[k])
    np.testing.assert_array_equal(back.query(items[:40]), port.query(items[:40]))
    linear = KernelSketch(pspec, pp.base, tile_h=128, device="cpu")
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        linear.load_state_dict(rsd)


def test_signed_refusals_match_reference():
    rspec, pspec = _specs(4)
    rp, pp = _params(rspec, 200)
    rhspec, phspec = _hspecs(4)
    ks = KernelSketch(pspec, pp, device="cpu", mode="signed")
    kh = KernelHierarchy(phspec, _arrays(rcs.init_params(rhspec.levels[-1],
                                                         jax.random.PRNGKey(1))),
                         device="cpu", mode="signed")
    items, _ = _block(4, 201)
    for bad in (np.array([1, -(1 << 24), 1, 1]), np.array([1, 1 << 24, 1, 1])):
        with pytest.raises(ValueError) as want:
            rops.check_signed_kernel_freqs(bad, jnp.int32)
        for target in (ks, kh):
            with pytest.raises(ValueError) as got:
                target.update(items, bad)
            assert str(got.value) == str(want.value)
    assert int(ks.table.abs().sum()) == int(kh.table.abs().sum()) == 0
    ks.update(items, np.array([-(1 << 24) + 1, -5, 0, (1 << 24) - 1]))
    assert int(ks.table.min()) < 0
    # state(): the reference's refusal, word for word
    rks = rops.KernelSketch(rspec, jax.random.PRNGKey(0), mode="signed")
    with pytest.raises(ValueError) as want:
        rks.state()
    with pytest.raises(ValueError) as got:
        ks.state()
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="signed hierarchies use cs_state"):
        kh.state()
    with pytest.raises(ValueError, match="linear-mode only"):
        kh.load_state(None)
    linear = KernelSketch(pspec, pp.base, device="cpu")
    with pytest.raises(ValueError, match="signed-mode view"):
        linear.cs_state()
    with pytest.raises(ValueError, match="signed-mode estimator"):
        linear.query_rows(items)
    with pytest.raises(ValueError, match="identical modes"):
        ks.merge(linear)
    other = KernelSketch(pspec, (pp.base.q, pp.base.r, pp.sign_q.flip(0),
                                 pp.sign_r), device="cpu", mode="signed")
    with pytest.raises(ValueError, match="sign-hash params"):
        ks.merge(other)
    with pytest.raises(ValueError, match="signed hierarchy view"):
        KernelHierarchy(phspec, torch.Generator(), device="cpu").cs_state()


def test_float32_and_sharded_refusals_name_their_items():
    """The sharded folds run in linear and signed mode (tests/
    test_torch_sharded.py holds them against the reference); conservative
    mode refuses what the reference's refuses; float32 tables are taken by
    the folds and refused, with ValueError, by the int32-only reads."""
    rspec, pspec = _specs(3)
    _, pp = _params(rspec, 210)
    mesh = Mesh((2,), ("data",), ["cpu", "cpu"])
    m = pspec.schema.modularity
    items = (np.arange(4 * m, dtype=np.uint32).reshape(4, m) * 37) % 251
    for mode, params in (("signed", pp), ("linear", pp.base)):
        ks = KernelSketch(pspec, params, device="cpu", mode=mode)
        ks.sharded_update(mesh, ("data",), items, np.ones(4, np.int32))
        one = KernelSketch(pspec, params, device="cpu", mode=mode)
        one.update(items, np.ones(4, np.int32))
        assert torch.equal(ks.table, one.table)
    # the checks the CUDA wrappers run first (the card tests drive them
    # there): the folds take float32 tables since item 14 (K1f, K3f, K6f,
    # K8f); the reads (K2, K4, K7, K9) take int32 only, as the reference's
    _cuda.require_table_dtype(torch.zeros((2, 2)), "sketch_update_signed",
                              _cuda.FOLD_DTYPES)
    with pytest.raises(ValueError, match="takes int32 tables"):
        _cuda.require_int32_table(torch.zeros((2, 2)), "sketch_query_signed")
    # conservative mode is ported; its sharded fold refuses as the
    # reference's does, and a conservative hierarchy is no KernelHierarchy
    cons = KernelSketch(pspec, pp.base, device="cpu", mode="conservative")
    with pytest.raises(ValueError, match="only defined for linear tables"):
        cons.sharded_update(None, ("data",), np.zeros((2, 4), np.uint32), np.ones(2))
    with pytest.raises(ValueError, match="KernelHierarchy modes"):
        KernelHierarchy(phh.HierarchySpec.from_spec(pspec), pp, device="cpu",
                        mode="conservative")


@pytest.mark.parametrize("values", ["integer", "gaussian"])
@pytest.mark.parametrize("w", WIDTHS)
def test_plain_k6f_k8f_match_reference_oracles_float32(w, values):
    """The plain K6f and K8f (float32 tables, signed float values) against
    the reference's jnp oracles, and ``hier_fold_tables`` on float32 tables
    and ``hier_fold_zero_tables`` (the compressor's fold, which takes K8f
    on the card): exact on
    integer-valued values, within float32 rounding (rtol 1e-6) on Gaussian
    ones."""
    rspec, pspec = _specs(w)
    rhspec, phspec = _hspecs(w)
    rp, pp = _params(rspec, 120 + w)
    q, r = pp.base
    rng = np.random.default_rng(121 + w)
    items, freqs = _block(900, 122 + w)
    vals = (freqs if values == "integer"
            else rng.standard_normal(freqs.shape) * 50).astype(np.float32)

    def close(want, got):
        if values == "integer":
            _eq(want, got)
        else:
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(want).max()))

    before = dict(_cuda.LAUNCHES)
    plan = make_plan(pspec)
    h_pad = psu.padded_table_size(pspec.table_size, 128)
    chunks = pspec.schema.module_chunks(torch.from_numpy(items.astype(np.int64)))
    flat = psu.sketch_update_signed(plan, torch.zeros((w, h_pad)), chunks,
                                    torch.from_numpy(vals), q, r, pp.sign_q, pp.sign_r)
    rflat = rcs.update(rspec, rcs.CountSketchState(rp, _zeros(rspec, jnp.float32)),
                       jnp.asarray(items), jnp.asarray(vals))
    close(rflat.table, flat[:, : pspec.table_size])

    rhp = rcs.init_params(rhspec.levels[-1], jax.random.PRNGKey(130 + w))
    hq_, hr, hsq, hsr = (torch.from_numpy(a.astype(np.int64)) for a in _arrays(rhp))
    rplan, pplan = rhu.make_hier_plan(rhspec, 128), phu.make_hier_plan(phspec, 128)
    ordered = phspec.level_items(phspec.n_levels - 1, items)
    rchunks = jnp.asarray(rhspec.levels[-1].schema.module_chunks_np(ordered))
    pchunks = phspec.levels[-1].schema.module_chunks(
        torch.from_numpy(ordered.astype(np.int64)))
    want = rhu.hier_update_signed_ref(
        rplan, jnp.zeros((w, rplan.padded_cols), jnp.float32), rchunks,
        jnp.asarray(vals), rhp.base.q, rhp.base.r, rhp.sign_q, rhp.sign_r)
    got = phu.hier_update_signed(pplan, torch.zeros((w, pplan.padded_cols)), pchunks,
                                 torch.from_numpy(vals), hq_, hr, hsq, hsr)
    close(want, got)

    zeros = tuple(jnp.zeros((s.width, s.table_size), jnp.float32) for s in rhspec.levels)
    rtabs = rcs.hier_fold_tables(rhspec, rhp, zeros, jnp.asarray(items), jnp.asarray(vals))
    ptabs = pcs.hier_fold_tables(
        phspec, interop.countsketch_params_from_numpy(*_arrays(rhp), device="cpu"),
        tuple(torch.zeros((s.width, s.table_size)) for s in phspec.levels),
        items, torch.from_numpy(vals))
    for a, b in zip(rtabs, ptabs):
        close(a, b)
    fresh = pcs.hier_fold_zero_tables(
        phspec, interop.countsketch_params_from_numpy(*_arrays(rhp), device="cpu"),
        items, torch.from_numpy(vals))
    for a, b in zip(ptabs, fresh):
        assert torch.equal(a, b)
    assert dict(_cuda.LAUNCHES) == before
