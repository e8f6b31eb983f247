"""The flat fold (K1, K1f) on the CPU: its launch deal
(``kernels/sketch_update.flat_deal``), and its plain version against the
reference at the accuracy path's shapes.

The deal is pure Python, no card: the CTAs a row and their span for the
blocks the port's callers fold (the accuracy and flat paths' 65,536 keys,
the training path's 8,184 bigrams) and for random ones, and a walk of the
kernel's grid-stride loop, which must cover every key exactly once.  The
plain version (``sketch_update_ref``, what the wrapper runs on CPU tensors)
is held bit for bit against the reference's ``core.sketch.update`` at
h = 4,096, w = 5 for the accuracy path's three spec kinds, on a block of a
source-sorted zipf stream (int32, tolerance 0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as rh
from repro.core import sketch as rsk
from repro_torch.core import hashing as ph
from repro_torch.core import sketch as psk
from repro_torch.kernels import hier_update as hu
from repro_torch.kernels import sketch_update as su
from repro_torch.kernels.hashes import make_plan
from repro_torch.streams import zipf_graph_stream

SMS = 132   # an H100 SXM


@pytest.mark.parametrize("w,n,deal", [
    (5, 65536, (128, 2)),     # the accuracy path: 1,280 CTAs at 1 tile, 1,056 fit
    (4, 65536, (256, 1)),     # the flat path: 1,024 CTAs fit at 1 tile
    (5, 8184, (32, 1)),       # the bigram fold
    (5, 262144, (205, 5)),
    (9, 1, (1, 1)),
    (5, 1 << 26, (4096, 64))])  # the span stops at SPAN_TILES
def test_callers_blocks_get_the_shortest_span_of_one_wave(w, n, deal):
    assert su.flat_deal(w, n, SMS) == deal


@pytest.mark.parametrize("seed", range(4))
def test_random_deals_run_in_one_wave(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        w = int(rng.integers(1, 10))
        n = int(rng.integers(1, 1 << 24))
        sms = int(rng.choice([1, 78, 132]))
        ctas, span = su.flat_deal(w, n, sms)
        tiles = -(-n // hu.THREADS)
        wave = max(1, sms * su.FLAT_CTAS_PER_SM // w)           # one wave's CTAs a row
        assert 1 <= span <= hu.SPAN_TILES
        assert ctas == -(-tiles // span)                       # a CTA a span
        if span < hu.SPAN_TILES:
            assert ctas <= wave
        if span > 1:                                           # and no longer spans
            assert -(-tiles // (span - 1)) > wave


def _walk(ctas, span_tiles, n):
    """The kernel's loop: CTA c takes spans c, c + ctas, ... of span_tiles
    tiles of THREADS keys each, cut at n."""
    span = span_tiles * hu.THREADS
    return [[(start, min(start + span, n))
             for start in range(c * span, n, ctas * span)] for c in range(ctas)]


@pytest.mark.parametrize("w", [1, 5, 9])
@pytest.mark.parametrize("n", [1, 255, 257, 4097, 65537, 1_000_003])
def test_the_walk_covers_every_key_once(w, n):
    walks = _walk(*su.flat_deal(w, n, SMS), n)
    ranges = sorted(rng for walk in walks for rng in walk)
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))   # no gap, no overlap
    assert all(len(walk) >= 1 for walk in walks)                   # every CTA works


# the accuracy path's spec kinds at quickstart's h = 4,096, w = 5; the
# mod-sketch at the Thm-3 ranges chip_smoke.py's seed-0 sample gives
ACCURACY_SPECS = [("count-min", None), ("equal-sketch", None), ("mod-sketch", (62, 66))]


def _accuracy_specs(kind, ranges):
    make = {"count-min": lambda m, s: m.count_min_spec(s, 4096, 5),
            "equal-sketch": lambda m, s: m.equal_sketch_spec(s, 4096, 5),
            "mod-sketch": lambda m, s: m.mod_sketch_spec(s, [(0,), (1,)], ranges, 5)}[kind]
    return (make(rsk, rh.KeySchema((1 << 32, 1 << 32))),
            make(psk, ph.KeySchema((1 << 32, 1 << 32))))


@pytest.fixture(scope="module")
def sorted_stream():
    """A source-sorted zipf edge stream (the generator's order), small."""
    return zipf_graph_stream(n_src=2_000, n_tgt=6_000, n_edges=20_000,
                             n_occurrences=200_000, seed=3)


@pytest.mark.parametrize("kind,ranges", ACCURACY_SPECS)
def test_plain_k1_matches_reference_update_at_accuracy_shape(sorted_stream, kind, ranges):
    rspec, pspec = _accuracy_specs(kind, ranges)
    rng = np.random.default_rng(5)
    q = rh.draw_hash_params_np(rng, (5, rspec.schema.total_chunks))
    r = rh.draw_hash_params_np(rng, (5, rspec.n_groups))
    rparams = rsk.SketchParams(q=jnp.asarray(q), r=jnp.asarray(r))
    pparams = psk.resolve_params(pspec, (q, r), "cpu")
    items, freqs = sorted_stream.items[:4096], sorted_stream.freqs[:4096].copy()
    freqs[::7] = 0                                          # zero rows mixed in
    assert np.unique(items[:, 0], return_counts=True)[1].max() > 64   # runs of a source
    want = rsk.update(rspec, rsk.SketchState(rparams, jnp.zeros((5, rspec.table_size),
                                                                jnp.int32)),
                      jnp.asarray(items), jnp.asarray(freqs))
    h_pad = su.padded_table_size(pspec.table_size, 512)
    assert h_pad == 4096
    chunks = pspec.schema.module_chunks(torch.from_numpy(items.astype(np.int64)))
    got = su.sketch_update_ref(make_plan(pspec), torch.zeros((5, h_pad), dtype=torch.int32),
                               chunks, torch.from_numpy(freqs), pparams.q, pparams.r)
    np.testing.assert_array_equal(np.asarray(want.table), got[:, : pspec.table_size].numpy())
    assert not bool(got[:, pspec.table_size:].any())
