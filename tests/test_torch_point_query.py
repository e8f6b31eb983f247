"""Port parity: the flat point queries' plain versions -- K2 (the minimum
over rows), K7 (the signed rows) and K7m (their median) -- and the signed
``KernelSketch.query`` that launches K7m on the card, against the
reference's jnp oracles on the CPU (``kernels.ref.sketch_query_ref``,
``core.countsketch.query_rows`` and its ``jnp.median``, and the median
the reference's ``KernelSketch.query`` takes, ``np.median`` of the rows in
float32), never its Pallas kernels.

Inputs are drawn from a numpy seed: hash params through
``draw_hash_params_np``, int32 tables over the whole int32 range with
INT_MAX, INT_MIN + 1 and zeros planted (INT_MIN too for K2).  Cases: w = 1-9
(odd and even; 1-8 are the kernels' unrolled rows, 9 their runtime loop),
Q = 0, 1 and 257, and keys of 6 chunks (held in registers on the card) and
of 10 (read from the chunk array).  Tolerance 0.  A cell of -2^31 under
sign -1 is the one stated difference from the reference (ROADMAP): the
port's int32 product wraps where the reference's float32 one does not.
The lane rule the kernels launch with (``point_lanes``) is pure Python and
is checked here too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import countsketch as rcs
from repro.core import hashing as rh
from repro.core import sketch as rsk
from repro.kernels.hashes import make_plan as r_make_plan
from repro.kernels.ref import sketch_query_ref as r_sketch_query_ref
from repro_torch.core import countsketch as pcs
from repro_torch.core import hashing as ph
from repro_torch.core import sketch as psk
from repro_torch.kernels import _cuda
from repro_torch.kernels import sketch_query as psq
from repro_torch.kernels.hashes import make_plan
from repro_torch.kernels.ops import KernelSketch
from repro_torch.kernels.sketch_update import padded_table_size

INT_MIN, INT_MAX = -(1 << 31), (1 << 31) - 1
# (domains, partition, ranges): keys of 6 chunks with a joint out-of-order
# group, and of 10 chunks, more than the kernels hold in registers
KEYS = {
    "6_chunks": ((1 << 32, 256, 1000, 70_000), [(3, 1), (0,), (2,)], (48, 90, 7)),
    "10_chunks": ((1 << 32,) * 5, [(0, 1), (2,), (3, 4)], (40, 9, 11)),
}
WIDTHS = range(1, 10)
QUERIES = (0, 1, 257)
TILE_H = 128


def _case(key, w, n, seed, int_min=False):
    """Both packages' specs, a numpy draw of bucket and sign params, n keys
    (uint32[n, modules], a few repeated) and an int32 table padded to
    TILE_H columns whose pad cells the queries must never read."""
    domains, partition, ranges = KEYS[key]
    rspec = rsk.mod_sketch_spec(rh.KeySchema(domains), partition, ranges, w)
    pspec = psk.mod_sketch_spec(ph.KeySchema(domains), partition, ranges, w)
    rng = np.random.default_rng(seed)
    shapes = [(w, pspec.schema.total_chunks), (w, pspec.n_groups)] * 2
    q, r, sq, sr = [ph.draw_hash_params_np(rng, shape) for shape in shapes]
    items = np.stack([rng.integers(0, d, n, dtype=np.uint64).astype(np.uint32)
                      for d in domains], axis=1)
    items[n // 2 :: 7] = items[:1]
    h = pspec.table_size
    table = rng.integers(INT_MIN + 1, INT_MAX, (w, h), dtype=np.int64, endpoint=True)
    planted = rng.integers(0, h, (w, 3 * h // 8 + 1))
    for k in range(w):
        table[k, planted[k, 0::3]] = INT_MAX
        table[k, planted[k, 1::3]] = INT_MIN if int_min else INT_MIN + 1
        table[k, planted[k, 2::3]] = 0
    table = table.astype(np.int32)
    padded = np.full((w, padded_table_size(h, TILE_H)), INT_MIN, np.int32)
    padded[:, :h] = table
    return rspec, pspec, (q, r, sq, sr), items, table, torch.from_numpy(padded)


def _reference_rows(rspec, arrays, items, table):
    q, r, sq, sr = map(jnp.asarray, arrays)
    state = rcs.CountSketchState(
        rcs.CountSketchParams(rsk.SketchParams(q, r), sq, sr), jnp.asarray(table))
    rows, med = rcs.query_rows(rspec, state, jnp.asarray(items))
    return np.asarray(rows), np.asarray(med)


def _port_inputs(pspec, arrays, items):
    p = pcs.resolve_params(pspec, arrays, "cpu")
    chunks = pspec.schema.module_chunks(torch.from_numpy(items.astype(np.int64)))
    return make_plan(pspec), chunks, (p.base.q, p.base.r, p.sign_q, p.sign_r)


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("n", QUERIES)
@pytest.mark.parametrize("w", WIDTHS)
def test_plain_k2_matches_reference_oracle(w, n, key):
    rspec, pspec, arrays, items, table, padded = _case(key, w, n, 1000 + 10 * w + n,
                                                       int_min=True)
    plan, chunks, (q, r, _, _) = _port_inputs(pspec, arrays, items)
    before = dict(_cuda.LAUNCHES)
    got = psq.sketch_query(plan, padded, chunks, q, r)
    assert dict(_cuda.LAUNCHES) == before            # CPU tensors: no launch
    want = r_sketch_query_ref(r_make_plan(rspec), jnp.asarray(table),
                              rspec.schema.module_chunks(jnp.asarray(items)),
                              jnp.asarray(arrays[0]), jnp.asarray(arrays[1]))
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("n", QUERIES)
@pytest.mark.parametrize("w", WIDTHS)
def test_plain_k7_matches_reference_rows(w, n, key):
    rspec, pspec, arrays, items, table, padded = _case(key, w, n, 2000 + 10 * w + n)
    plan, chunks, params = _port_inputs(pspec, arrays, items)
    before = dict(_cuda.LAUNCHES)
    rows = psq.sketch_query_signed(plan, padded, chunks, *params)
    assert dict(_cuda.LAUNCHES) == before
    assert rows.dtype == torch.int32 and rows.shape == (w, n)
    want, _ = _reference_rows(rspec, arrays, items, table)
    np.testing.assert_array_equal(want, rows.to(torch.float32).numpy())


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("n", QUERIES)
@pytest.mark.parametrize("w", WIDTHS)
def test_plain_k7m_and_signed_query_match_reference_median(w, n, key):
    """K7m's plain version and the signed ``KernelSketch.query`` (which
    launches K7m on the card) against ``jnp.median`` of the reference's
    rows and against the reference ``KernelSketch.query``'s median."""
    rspec, pspec, arrays, items, table, padded = _case(key, w, n, 3000 + 10 * w + n)
    plan, chunks, params = _port_inputs(pspec, arrays, items)
    rows, jnp_median = _reference_rows(rspec, arrays, items, table)
    np_median = np.median(rows.astype(np.float32), axis=0)
    before = dict(_cuda.LAUNCHES)
    med = psq.sketch_query_signed_median(plan, padded, chunks, *params)
    assert med.dtype == torch.float32 and med.shape == (n,)
    assert torch.equal(med.view(torch.int32), pcs.median_rows(
        psq.sketch_query_signed(plan, padded, chunks, *params)).view(torch.int32))
    ks = KernelSketch(pspec, arrays, tile_h=TILE_H, device="cpu", mode="signed")
    ks.table = padded.clone()
    est = ks.query(items)
    assert dict(_cuda.LAUNCHES) == before
    assert est.dtype == np.float32 and est.shape == (n,)
    for want in (jnp_median, np_median):
        np.testing.assert_array_equal(want, med.numpy())
        np.testing.assert_array_equal(want, est)


def test_int_min_under_sign_minus_one_is_the_stated_difference():
    """Every cell -2^31: the port's K7 rows (and so K7m) wrap to -2^31 under
    sign -1, where the reference's float32 product gives +2^31; under sign
    +1 they agree."""
    rspec, pspec, arrays, items, table, padded = _case("6_chunks", 5, 257, 4000)
    table[:] = INT_MIN
    padded[:] = INT_MIN
    plan, chunks, params = _port_inputs(pspec, arrays, items)
    rows = psq.sketch_query_signed(plan, padded, chunks, *params)
    want, _ = _reference_rows(rspec, arrays, items, table)
    assert (want == -float(INT_MIN)).any() and (want == float(INT_MIN)).any()
    np.testing.assert_array_equal(rows.numpy(), np.full((5, 257), INT_MIN, np.int32))
    np.testing.assert_array_equal(np.abs(want), np.full((5, 257), 2.0 ** 31, np.float32))
    np.testing.assert_array_equal(psq.sketch_query_signed_median(plan, padded, chunks,
                                                                 *params).numpy(),
                                  np.full(257, float(INT_MIN), np.float32))


@pytest.mark.parametrize("n", (1, 500, 8192, 16_896, 16_897, 33_792, 65_536, 1 << 20))
@pytest.mark.parametrize("w", WIDTHS)
def test_point_lanes_fill_the_card_up_to_two_ctas_an_sm(w, n):
    """The lane rule on a card of 132 SMs: the most lanes, a power of two
    up to w's, whose threads stay within 512 an SM; the runtime-w rows (9)
    always one lane.  The flat paths' 65,536 queries take one lane, the
    accuracy path's 500 at w = 5 eight."""
    lanes = psq.point_lanes(w, n, 132)
    budget = 132 * psq.LANE_THREADS_PER_SM
    assert lanes & (lanes - 1) == 0 and 1 <= lanes <= psq.max_lanes(w)
    assert lanes == 1 or n * lanes <= budget
    assert lanes == psq.max_lanes(w) or n * 2 * lanes > budget
    if w > psq.UNROLLED_ROWS:
        assert lanes == 1
    assert psq.point_lanes(4, 65_536, 132) == 1 and psq.point_lanes(5, 500, 132) == 8
