"""The candidate-grid queries (K4, K9, K9m) on the CPU: the plain version
of K9m against the reference's median of its signed rows, the descents
with and without the window route's ``span``, and the route rule
(``kernels/hier_query.query_geometry``, pure Python).

Inputs come from a numpy seed and go through the reference's jnp oracles
and the port's plain versions; the tolerance is 0, comparing by value
(-0.0 == 0.0: a zero under sign -1 is -0.0 in both plain versions).  The
kernels themselves run on the card (``tests/test_torch_cuda.py``).
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
from repro_torch.core import countsketch as pcs
from repro_torch.core import hashing as ph
from repro_torch.core import hierarchy as phh
from repro_torch.core import sketch as psk
from repro_torch.kernels import hier_query as phq

SPAN = 90               # a level's last range: child partials lie below it
PREFIXES = 50
SMS = 132               # an H100 SXM
DOMAINS = (1 << 32, 256, 1000, 70_000)
PARTITION = [(3, 1), (0,), (2,)]
RANGES = (48, 90, 7)


def _grid(w, p, c, seed):
    """An int32 level table of cells near +-2^24 and +-2^31, and zeros,
    with its prefix partials (idx * SPAN), child partials (below SPAN) and
    +-1 signs.  No cell is -2^31: K9m multiplies in int32 and wraps there
    under sign -1, where the float32 plain versions give +2^31 (a
    deliberate difference, ROADMAP section 3), and these inputs are the
    kernel's too."""
    rng = np.random.default_rng(seed)
    shape = (w, PREFIXES * SPAN)
    wide = rng.integers(-(1 << 31) + 1, 1 << 31, shape, dtype=np.int64)
    near = rng.integers((1 << 24) - 4, (1 << 24) + 4, shape) * rng.choice([-1, 1], shape)
    table = np.where(rng.random(shape) < 0.5, wide, near).astype(np.int32)
    table[:, ::9] = 0
    pp = rng.integers(0, PREFIXES, (w, p)) * SPAN
    cp = rng.integers(0, SPAN, (w, c))
    sp = rng.choice([-1.0, 1.0], (w, p)).astype(np.float32)
    sc = rng.choice([-1.0, 1.0], (w, c)).astype(np.float32)
    return table, pp, cp, sp, sc


@pytest.mark.parametrize("p", [1, 7])
@pytest.mark.parametrize("w", range(1, 10))
def test_median_signed_ref_matches_reference_median_of_rows(w, p):
    """K9m's plain version is jnp.median over the reference's signed rows,
    for odd and even w, one prefix or several."""
    table, pp, cp, sp, sc = _grid(w, p, 61, 10 * w + p)
    rows = rhq.hier_candidate_query_signed_ref(
        jnp.asarray(table), jnp.asarray(pp.astype(np.uint32)),
        jnp.asarray(cp.astype(np.uint32)), jnp.asarray(sp), jnp.asarray(sc))
    want = np.asarray(jnp.median(rows, axis=0))
    args = [torch.from_numpy(a) for a in (table, pp, cp, sp, sc)]
    got = phq.hier_candidate_median_signed_ref(*args)
    assert got.dtype == torch.float32 and got.shape == (p, 61)
    np.testing.assert_array_equal(want, got.numpy())
    # CPU tensors take the plain version, with or without span
    np.testing.assert_array_equal(want, phq.hier_candidate_median_signed(*args).numpy())
    np.testing.assert_array_equal(
        want, phq.hier_candidate_median_signed(*args, span=SPAN).numpy())
    np.testing.assert_array_equal(
        np.asarray(rows), phq.hier_candidate_query_signed(*args, span=SPAN).numpy())


def _turnstile_case(w, seed):
    """Both packages' signed and linear hierarchies over one block of keys
    (heavy duplication, both signs), from the reference's hash draws."""
    rspec = rhh.HierarchySpec.from_spec(
        rsk.mod_sketch_spec(rh.KeySchema(DOMAINS), PARTITION, RANGES, w))
    pspec = phh.HierarchySpec.from_spec(
        psk.mod_sketch_spec(ph.KeySchema(DOMAINS), PARTITION, RANGES, w))
    rng = np.random.default_rng(seed)
    items = np.stack([rng.integers(0, d, 1500, dtype=np.uint64).astype(np.uint32)
                      for d in DOMAINS], axis=1)
    items[150:400] = items[0]
    items[400:500] = items[1]
    freqs = rng.integers(1, 300, 1500).astype(np.int64)
    rparams = rcs.init_params(rspec.levels[-1], jax.random.PRNGKey(seed))
    arrays = (np.asarray(rparams.base.q), np.asarray(rparams.base.r),
              np.asarray(rparams.sign_q), np.asarray(rparams.sign_r))
    rsig = rcs.CountSketchHierarchy(rparams, tuple(
        jnp.zeros((s.width, s.table_size), jnp.int32) for s in rspec.levels))
    psig = pcs.init_hierarchy(pspec, arrays, dtype=torch.int32, device="cpu")
    signed = (rcs.hier_update(rspec, rsig, jnp.asarray(items), jnp.asarray(freqs - 40)),
              pcs.hier_update(pspec, psig, items, freqs - 40))
    rlin = rhh.init_hierarchy(rspec, jax.random.PRNGKey(seed + 1))
    fine = rlin.states[-1].params
    plin = phh.init_hierarchy(pspec, (np.asarray(fine.q), np.asarray(fine.r)), device="cpu")
    linear = (rhh.update_jit(rspec, rlin, jnp.asarray(items), jnp.asarray(freqs)),
              phh.update_jit(pspec, plin, items, freqs))
    cands = [np.unique(items[:, list(g)], axis=0) for g in PARTITION]
    return rspec, pspec, signed, linear, cands, int(freqs.sum())


@pytest.mark.parametrize("span", ["level range", None])
def test_descents_with_and_without_span_match_reference(monkeypatch, span):
    """``core/hierarchy.find_heavy_hitters`` (and its Q-batched form) and
    ``core/countsketch.find_heavy_hitters``, with the level's last range
    passed to the query kernels as ``span`` and without it, give the
    reference's items and estimates (CPU tensors take the plain grids)."""
    rspec, pspec, (rsig, psig), (rlin, plin), cands, total = _turnstile_case(4, 3)
    for level in range(pspec.n_levels):
        assert phh.candidate_span(pspec, level) == RANGES[level]
    if span is None:
        monkeypatch.setattr(phh, "candidate_span", lambda *args: None)
    thr = 0.01 * total
    want = rhh.find_heavy_hitters(rspec, rlin, thr, cands, max_batch=256)
    got = phh.find_heavy_hitters(pspec, plin, thr, cands, use_kernel=True, max_batch=256)
    assert got[0].shape[0] > 0
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_array_equal(want[1], got[1])
    want_b = rhh.batched_find_heavy_hitters(rspec, rlin, [thr, 3 * thr], cands)
    got_b = phh.batched_find_heavy_hitters(pspec, plin, [thr, 3 * thr], cands,
                                           use_kernel=True)
    for a, b in zip(want_b, got_b):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    want = rcs.find_heavy_hitters(rspec, rsig, thr, cands, max_batch=256)
    got = pcs.find_heavy_hitters(pspec, psig, thr, cands, use_kernel=True, max_batch=256)
    assert got[0].shape[0] > 0
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_array_equal(want[1], got[1])


# --------------------------------------------------------------------------
# the route rule
# --------------------------------------------------------------------------

def _ctas(g, p, c):
    """The (prefix, first candidate, candidates) each CTA of the launch
    covers, as hier_query.cuh walks its grid."""
    tiles = -(-c // g.c_tile)
    return [(b // tiles, (b % tiles) * g.c_tile,
             min(g.c_tile, c - (b % tiles) * g.c_tile)) for b in range(p * tiles)]


@pytest.mark.parametrize("shape,route", [
    ((1, 4096), "direct"), ((16, 4096), "direct"), ((24, 4096), "direct"),
    ((48, 4096), "direct"), ((86, 4096), "window"), ((91, 4096), "window"),
    ((365, 4096), "window"), ((2190, 4096), "window"), ((16 * 2190, 4096), "window"),
    ((1, 191300), "direct"), ((1, 124025), "direct")])
def test_query_routes_at_the_paths_grids(shape, route):
    """The main path's level grids at w = 4 and span 4,096 (the most
    launched 16 x 4,096 on the direct route, the wide level-1 grids and a
    flush of 16 requests on the window route) and the turnstile descent's
    1 x 191,300 (direct)."""
    p, c = shape
    g = phq.query_geometry(4, p, c, 4096, SMS)
    assert ("window" if g.span else "direct") == route
    assert g.c_tile % phq.THREADS == 0
    if g.span:
        assert g.shared_bytes == phq.window_bytes(4, 4096) == 4 * 4 * 4100 + 16
        assert 8 * g.c_tile >= phq.SECTOR_READS * g.span
    else:
        assert g.shared_bytes == 0
        assert phq.THREADS <= g.c_tile <= phq.THREADS * phq.DIRECT_LANES
    assert phq.query_geometry(4, p, c, None, SMS).span == 0


def test_query_geometry_invariants_and_grid_walk():
    """Random shapes: a window fits WINDOW_BYTES and its pitch holds the
    span from a 16-byte-aligned start; without span the route is direct;
    and the CTAs cover every (p, c) lane exactly once."""
    rng = np.random.default_rng(5)
    for _ in range(300):
        w = int(rng.integers(1, 12))
        p = int(rng.integers(1, 3000))
        c = int(rng.integers(1, 20000))
        span = int(rng.choice([7, 48, 90, 512, 4096, 20000]))
        g = phq.query_geometry(w, p, c, span, SMS)
        assert g.c_tile >= phq.THREADS and g.c_tile % phq.THREADS == 0
        if g.span:
            pitch = (g.span + 7) // 4 * 4
            assert pitch % 4 == 0 and pitch >= g.span + 3
            assert g.shared_bytes == 4 * w * pitch + phq.BAR_BYTES <= phq.WINDOW_BYTES
        else:
            assert g.shared_bytes == 0
        assert phq.query_geometry(w, p, c, None, SMS).span == 0
        if p * c <= 200_000:
            seen = np.zeros((p, c), np.int32)
            for pi, c0, n in _ctas(g, p, c):
                seen[pi, c0 : c0 + n] += 1
            assert (seen == 1).all()
