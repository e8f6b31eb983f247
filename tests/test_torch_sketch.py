"""Port parity: the flat sketch (core/sketch.py) and KernelSketch.

The same numpy inputs go through the JAX reference and the port on the
CPU, with shared hash params.  On CPU tensors the port's kernel wrappers
run their plain versions, which are held here against the reference's jnp
oracles (``kernels/ref.py``).  Int32 tables: exact equality.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as rh
from repro.core import sketch as rsk
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.hashes import make_plan as r_make_plan
from repro_torch.core import hashing as ph
from repro_torch.core import sketch as psk
from repro_torch.kernels import ops as pops
from repro_torch.kernels import sketch_query as psq
from repro_torch.kernels import sketch_update as psu
from repro_torch.kernels.hashes import make_plan as p_make_plan

DOMAINS = (1 << 32, 256, 1000, 70_000)
SPECS = [("count_min", [(0, 1, 2, 3)], (5003,)),
         ("mod", [(3, 1), (0,), (2,)], (48, 90, 7))]
KEY = jax.random.PRNGKey(0)


def _specs(partition, ranges, w=3):
    return (rsk.mod_sketch_spec(rh.KeySchema(DOMAINS), partition, ranges, w),
            psk.mod_sketch_spec(ph.KeySchema(DOMAINS), partition, ranges, w))


def _block(n, seed, fmax=1 << 12):
    rng = np.random.default_rng(seed)
    items = np.stack([rng.integers(0, d, n, dtype=np.uint64).astype(np.uint32)
                      for d in DOMAINS], axis=1)
    items[n // 10 : n // 4] = items[0]                  # heavy duplication
    freqs = rng.integers(1, fmax, n).astype(np.int64)
    return items, freqs


def _shared(rspec, pspec):
    rp = rsk.init_params(rspec, KEY)
    pp = psk.resolve_params(pspec, (np.asarray(rp.q), np.asarray(rp.r)), "cpu")
    return rp, pp


@pytest.mark.parametrize("name,partition,ranges", SPECS)
def test_update_query_merge_match_reference(name, partition, ranges):
    rspec, pspec = _specs(partition, ranges)
    rp, pp = _shared(rspec, pspec)
    ra, rb = (rsk.SketchState(rp, jnp.zeros((3, rspec.table_size), jnp.int32))
              for _ in range(2))
    pa, pb = (psk.init_state(pspec, (pp.q, pp.r), device="cpu") for _ in range(2))
    for seed in range(3):
        items, freqs = _block(600, seed)
        ra = rsk.update_jit(rspec, ra, jnp.asarray(items), jnp.asarray(freqs))
        pa = psk.update(pspec, pa, items, freqs)
        items, freqs = _block(300, 10 + seed)
        rb = rsk.update_jit(rspec, rb, jnp.asarray(items), jnp.asarray(freqs))
        pb = psk.update_jit(pspec, pb, items, freqs)       # in place
    np.testing.assert_array_equal(np.asarray(ra.table), pa.table.numpy())
    np.testing.assert_array_equal(np.asarray(rb.table), pb.table.numpy())
    rm, pm = rsk.merge(ra, rb), psk.merge(pa, pb)
    np.testing.assert_array_equal(np.asarray(rm.table), pm.table.numpy())
    queries, _ = _block(400, 99)
    np.testing.assert_array_equal(
        np.asarray(rsk.query_jit(rspec, rm, jnp.asarray(queries))),
        psk.query(pspec, pm, queries).numpy())


def test_update_is_pure_and_update_jit_in_place():
    rspec, pspec = _specs(*SPECS[1][1:])
    _, pp = _shared(rspec, pspec)
    st = psk.init_state(pspec, (pp.q, pp.r), device="cpu")
    items, freqs = _block(100, 1)
    new = psk.update(pspec, st, items, freqs)
    assert int(st.table.abs().sum()) == 0 and int(new.table.sum()) > 0
    same = psk.update_jit(pspec, st, items, freqs)
    assert same.table is st.table and torch.equal(st.table, new.table)


def test_int32_wraparound_matches_reference():
    rspec, pspec = _specs(*SPECS[1][1:])
    rp, pp = _shared(rspec, pspec)
    start = np.full((3, rspec.table_size), (1 << 31) - 5, np.int32)
    items, _ = _block(500, 2)
    freqs = np.full(500, (1 << 24) - 1, np.int64)
    rs = rsk.update_jit(rspec, rsk.SketchState(rp, jnp.asarray(start)),
                        jnp.asarray(items), jnp.asarray(freqs))
    ps = psk.update(pspec, psk.SketchState(pp, torch.from_numpy(start.copy())),
                    items, freqs)
    np.testing.assert_array_equal(np.asarray(rs.table), ps.table.numpy())
    assert int(ps.table.min()) < 0


def test_build_sketch_matches_reference():
    rspec, pspec = _specs(*SPECS[1][1:])
    rp, _ = _shared(rspec, pspec)
    items, freqs = _block(2500, 4)
    want = rsk.build_sketch(rspec, KEY, items, freqs, block=1024)
    got = psk.build_sketch(pspec, (np.asarray(rp.q), np.asarray(rp.r)), items,
                           freqs, block=1024, device="cpu")
    np.testing.assert_array_equal(np.asarray(want.table), got.table.numpy())


@pytest.mark.parametrize("tile_h,block_b", [(128, 1 << 16), (512, 700)])
def test_kernel_sketch_plain_path_matches_kernel_oracles(tile_h, block_b):
    """KernelSketch on CPU tensors runs the plain K1/K2; the reference's
    jnp oracles are run on the same padded table and params."""
    rspec, pspec = _specs(*SPECS[1][1:])
    rp, pp = _shared(rspec, pspec)
    ks = pops.KernelSketch(pspec, (pp.q, pp.r), tile_h=tile_h,
                           block_b=block_b, device="cpu")
    rplan = r_make_plan(rspec)
    table = jnp.zeros((3, ks.h_pad), jnp.int32)
    for seed in range(2):
        items, freqs = _block(1500, 20 + seed)
        ks.update(items, freqs)
        table = rref.sketch_update_ref(
            rplan, table, rspec.schema.module_chunks(jnp.asarray(items)),
            jnp.asarray(freqs), rp.q, rp.r)
    np.testing.assert_array_equal(np.asarray(table), ks.table.numpy())
    queries, _ = _block(300, 30)
    want = rref.sketch_query_ref(rplan, table,
                                 rspec.schema.module_chunks(jnp.asarray(queries)),
                                 rp.q, rp.r)
    np.testing.assert_array_equal(np.asarray(want), ks.query(queries))
    np.testing.assert_array_equal(np.asarray(table)[:, : rspec.table_size],
                                  ks.table_view())
    assert torch.equal(ks.state().table, ks.table[:, : pspec.table_size])


def test_plain_k1_k2_wrappers_on_cpu_match_kernel_oracles():
    """The wrappers themselves, called with CPU tensors, take the plain
    versions (no kernel, no launch counted)."""
    from repro_torch.kernels import _cuda

    rspec, pspec = _specs(*SPECS[0][1:])
    rp, pp = _shared(rspec, pspec)
    items, freqs = _block(800, 5)
    rplan, pplan = r_make_plan(rspec), p_make_plan(pspec)
    h_pad = psu.padded_table_size(pspec.table_size, 512)
    before = dict(_cuda.LAUNCHES)
    chunks = pspec.schema.module_chunks(torch.from_numpy(items.astype(np.int64)))
    got = psu.sketch_update(pplan, torch.zeros((3, h_pad), dtype=torch.int32),
                            chunks, torch.from_numpy(freqs), pp.q, pp.r)
    rchunks = rspec.schema.module_chunks(jnp.asarray(items))
    want = rref.sketch_update_ref(rplan, jnp.zeros((3, h_pad), jnp.int32),
                                  rchunks, jnp.asarray(freqs), rp.q, rp.r)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    np.testing.assert_array_equal(
        np.asarray(rref.sketch_query_ref(rplan, want, rchunks, rp.q, rp.r)),
        psq.sketch_query(pplan, got, chunks, pp.q, pp.r).numpy())
    assert dict(_cuda.LAUNCHES) == before


def test_kernel_sketch_guards_match_reference():
    rspec, pspec = _specs(*SPECS[1][1:])
    rp, pp = _shared(rspec, pspec)
    ks = pops.KernelSketch(pspec, (pp.q, pp.r), device="cpu")
    items, _ = _block(4, 0)
    for bad in (np.array([1, 2, -3, 4]), np.array([1, 1 << 24, 1, 1])):
        with pytest.raises(ValueError) as got:
            ks.update(items, bad)
        with pytest.raises(ValueError) as want:
            rops.check_linear_kernel_freqs(bad, jnp.int32)
        assert str(got.value) == str(want.value)
    assert int(ks.table.abs().sum()) == 0              # refused = untouched
    pops.check_linear_kernel_freqs(np.array([-5, 1 << 30]), torch.float32)
    cons = pops.KernelSketch(pspec, (pp.q, pp.r), device="cpu", mode="conservative")
    with pytest.raises(ValueError, match="non-negative"):     # its own refusal
        cons.update(items, np.array([1, 2, -3, 4]))
    cons.update(items, np.array([1, 1 << 24, 1, 1]))          # no limb split
    assert int(cons.table.max()) == 1 << 24
    signed = pops.KernelSketch(pspec, (pp.q, pp.r, pp.q, pp.r), device="cpu",
                               mode="signed")
    signed.update(items, np.array([1, 2, -3, 4]))      # turnstile: accepted
    assert signed.mode == "signed" and int(signed.table.min()) < 0
    with pytest.raises(ValueError, match="mode must be one of"):
        pops.KernelSketch(pspec, (pp.q, pp.r), device="cpu", mode="bogus")


def test_kernel_sketch_merge_and_refusals():
    rspec, pspec = _specs(*SPECS[1][1:])
    _, pp = _shared(rspec, pspec)
    a = pops.KernelSketch(pspec, (pp.q, pp.r), device="cpu")
    b = pops.KernelSketch(pspec, (pp.q, pp.r), device="cpu")
    ia, fa = _block(500, 1)
    ib, fb = _block(500, 2)
    a.update(ia, fa)
    b.update(ib, fb)
    both = pops.KernelSketch(pspec, (pp.q, pp.r), device="cpu")
    both.update(np.concatenate([ia, ib]), np.concatenate([fa, fb]))
    a.merge(b)
    assert torch.equal(a.table, both.table)
    other = pops.KernelSketch(pspec, torch.Generator().manual_seed(1), device="cpu")
    with pytest.raises(ValueError, match="identical hash params"):
        a.merge(other)
    wide = pops.KernelSketch(pspec, (pp.q, pp.r), device="cpu",
                             dtype=torch.float32)
    with pytest.raises(ValueError, match="identical table dtypes"):
        a.merge(wide)


def test_kernel_sketch_state_dict_round_trips_with_reference():
    rspec, pspec = _specs(*SPECS[1][1:])
    rp, pp = _shared(rspec, pspec)
    port = pops.KernelSketch(pspec, (pp.q, pp.r), device="cpu")
    items, freqs = _block(900, 3)
    port.update(items, freqs)
    ref = rops.KernelSketch(rspec, jax.random.PRNGKey(5))   # other params
    ref.load_state_dict(port.state_dict())
    np.testing.assert_array_equal(ref.table_view(), port.table_view())
    np.testing.assert_array_equal(np.asarray(ref.params.q), pp.q.numpy())
    rsd = ref.state_dict()
    back = pops.KernelSketch(pspec, torch.Generator().manual_seed(9), device="cpu")
    back.load_state_dict(rsd)
    psd = back.state_dict()
    assert rsd.keys() == psd.keys()
    for k in rsd:
        assert rsd[k].dtype == psd[k].dtype, k
        np.testing.assert_array_equal(rsd[k], psd[k])
    narrow = pops.KernelSketch(pspec, (pp.q, pp.r), tile_h=128, device="cpu")
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        narrow.load_state_dict(rsd)


@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_plain_k1f_matches_reference_oracle_float32(values):
    """K1f's plain version (a float32 table, float values) against the
    reference's jnp oracle: exact on integer-valued frequencies; within
    float32 rounding (rtol 1e-6) on Gaussian ones."""
    from repro_torch.kernels import _cuda

    rspec, pspec = _specs(*SPECS[1][1:])
    rp, pp = _shared(rspec, pspec)
    items, freqs = _block(900, 6)
    if values == "gaussian":
        freqs = np.random.default_rng(7).standard_normal(freqs.shape) * 100
    freqs = freqs.astype(np.float32)
    rplan, pplan = r_make_plan(rspec), p_make_plan(pspec)
    h_pad = psu.padded_table_size(pspec.table_size, 512)
    start = np.random.default_rng(8).integers(-99, 99, (3, h_pad)).astype(np.float32)
    before = dict(_cuda.LAUNCHES)
    chunks = pspec.schema.module_chunks(torch.from_numpy(items.astype(np.int64)))
    got = psu.sketch_update(pplan, torch.from_numpy(start.copy()), chunks,
                            torch.from_numpy(freqs), pp.q, pp.r)
    want = rref.sketch_update_ref(rplan, jnp.asarray(start),
                                  rspec.schema.module_chunks(jnp.asarray(items)),
                                  jnp.asarray(freqs), rp.q, rp.r)
    assert got.dtype == torch.float32
    if values == "integer":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()))
    assert dict(_cuda.LAUNCHES) == before
    # the float32 KernelSketch takes negative and large float frequencies
    ks = pops.KernelSketch(pspec, (pp.q, pp.r), dtype=torch.float32, device="cpu")
    ks.update(items, -np.abs(freqs) * (1 << 25))
    assert float(ks.table.min()) < 0
