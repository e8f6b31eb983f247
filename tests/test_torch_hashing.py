"""Port parity: hashing, chunking, spec construction and cell indices.

The same numpy inputs (made from a seed) go through the JAX reference
(``repro``) and the PyTorch port (``repro_torch``) on the CPU.  Hash values
and indices are integers, so the tolerance is exact equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as rh
from repro.core import sketch as rsk
from repro_torch.core import hashing as ph
from repro_torch.core import sketch as psk

DOMAINS = (1 << 32, 256, 1000, 70_000)


def _items(n, seed, domains=DOMAINS):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, d, n, dtype=np.uint64).astype(np.uint32)
                     for d in domains], axis=1)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _specs():
    """(name, partition, ranges) over DOMAINS: Count-Min, Equal-Sketch and
    a MOD-Sketch with a joint, out-of-order group."""
    return [("count_min", [(0, 1, 2, 3)], (5003,)),
            ("equal", [(0,), (1,), (2,), (3,)], (9, 8, 7, 6)),
            ("mod", [(3, 1), (0,), (2,)], (48, 90, 7))]


def test_module_chunks_match_reference():
    items = _items(500, 0)
    r_schema, p_schema = rh.KeySchema(DOMAINS), ph.KeySchema(DOMAINS)
    assert p_schema.chunk_counts == r_schema.chunk_counts == (2, 1, 1, 2)
    want = r_schema.module_chunks_np(items)
    np.testing.assert_array_equal(want, np.asarray(r_schema.module_chunks(jnp.asarray(items))))
    np.testing.assert_array_equal(want, p_schema.module_chunks_np(items))
    np.testing.assert_array_equal(want, p_schema.module_chunks(_t(items)).numpy())
    for m in range(len(DOMAINS)):
        assert p_schema.chunk_slice(m) == r_schema.chunk_slice(m)


@pytest.mark.parametrize("n_chunks", [1, 2, 3, 5, 8])
def test_cw_hash_matches_numpy_oracle_and_jnp(n_chunks):
    rng = np.random.default_rng(n_chunks)
    chunks = rng.integers(0, 1 << 16, (400, n_chunks)).astype(np.uint32)
    chunks[:8] = 0xFFFF                                  # extreme digits
    q = rh.draw_hash_params_np(rng, (n_chunks,))
    q[0] = int(rh.P31) - 1                               # extreme multiplier
    r = int(rh.P31) - 1
    want = rh.cw_hash_np(chunks, q, r)
    np.testing.assert_array_equal(
        want, np.asarray(rh.cw_hash(jnp.asarray(chunks), jnp.asarray(q),
                                    jnp.uint32(r))))
    np.testing.assert_array_equal(want, ph.cw_hash_np(chunks, q, r))
    got = ph.cw_hash(_t(chunks), _t(q), r)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("name,partition,ranges", _specs())
def test_compute_indices_match_reference(name, partition, ranges):
    rspec = rsk.mod_sketch_spec(rh.KeySchema(DOMAINS), partition, ranges, 4)
    pspec = psk.mod_sketch_spec(ph.KeySchema(DOMAINS), partition, ranges, 4)
    assert repr(pspec) == repr(rspec)           # shared state fingerprints
    assert pspec.strides == rspec.strides and pspec.table_size == rspec.table_size
    rng = np.random.default_rng(7)
    q = rh.draw_hash_params_np(rng, (4, rspec.schema.total_chunks))
    r = rh.draw_hash_params_np(rng, (4, rspec.n_groups))
    items = _items(700, 8)
    want = np.asarray(rsk.compute_indices(
        rspec, rsk.SketchParams(jnp.asarray(q), jnp.asarray(r)), jnp.asarray(items)))
    params = psk.resolve_params(pspec, (q, r), "cpu")
    got = psk.compute_indices(pspec, params, items)
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(want, psk.compute_indices_np(pspec, params, items))
    for g in range(len(partition)):
        vals = items[:, list(partition[g])]
        want_g = np.asarray(rsk.group_subindex(
            rspec, rsk.SketchParams(jnp.asarray(q), jnp.asarray(r)), g,
            jnp.asarray(vals)))
        np.testing.assert_array_equal(
            want_g, psk.group_subindex(pspec, params, g, vals).numpy())


@pytest.mark.parametrize("h,n", [(2, 3), (360_000, 2), (4096, 3), (10**6, 4), (7, 1)])
def test_spec_builders_match_reference(h, n):
    assert psk.equal_ranges(h, n) == rsk.equal_ranges(h, n)
    domains = DOMAINS[:n] if n <= len(DOMAINS) else DOMAINS
    assert repr(psk.equal_sketch_spec(ph.KeySchema(domains), h, 3)) == \
        repr(rsk.equal_sketch_spec(rh.KeySchema(domains), h, 3))
    assert repr(psk.count_min_spec(ph.KeySchema(domains), h, 2)) == \
        repr(rsk.count_min_spec(rh.KeySchema(domains), h, 2))


def test_spec_and_schema_validation_match_reference():
    for bad in [(), (1,), (1 << 33,)]:
        with pytest.raises(ValueError):
            rh.KeySchema(bad)
        with pytest.raises(ValueError):
            ph.KeySchema(bad)
    schema = ph.KeySchema((16, 16))
    with pytest.raises(ValueError, match="does not cover"):
        psk.mod_sketch_spec(schema, [(0,)], (4,), 2)
    with pytest.raises(ValueError, match="one range per group"):
        psk.mod_sketch_spec(schema, [(0,), (1,)], (4,), 2)


def test_torch_generator_draws_in_range_and_reproducibly():
    spec = psk.mod_sketch_spec(ph.KeySchema(DOMAINS), [(0,), (1, 2), (3,)],
                               (8, 8, 8), 5)
    a = psk.init_params(spec, torch.Generator().manual_seed(3), "cpu")
    b = psk.init_params(spec, torch.Generator().manual_seed(3), "cpu")
    assert tuple(a.q.shape) == (5, spec.schema.total_chunks)
    assert tuple(a.r.shape) == (5, 3)
    assert torch.equal(a.q, b.q) and torch.equal(a.r, b.r)
    for t in (a.q, a.r):
        assert t.dtype == torch.int64
        assert int(t.min()) >= 0 and int(t.max()) < int(ph.P31)
    with pytest.raises(ValueError, match="shapes"):
        psk.resolve_params(spec, (a.q[:, :2], a.r), "cpu")
