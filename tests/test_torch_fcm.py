"""Port parity: FCM / FMOD (paper SVI-E) and the paper's remaining workloads.

The port's ``MisraGries``, ``pack_keys`` and ``FCM`` are held against the
reference's on the same seeded streams and the same hash draw (the
reference's ``sk.init_params`` as numpy, and the same ``seed`` for the
offset and gap hashes): Misra-Gries counters, tables and queries equal,
FCM (count-min cells) and FMOD (composite cells) alike, and the Fig. 10
ordering holds on the port.  ``ipv4_stream``, ``telecom_stream``,
``reinterpret_modularity`` and ``ngram_hh_workload`` return the
reference's arrays.  Tolerance 0.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import fcm as rfcm
from repro.core import hashing as rh
from repro.streams import ngram_hh_workload as r_ngram_hh_workload
from repro.streams import synthetic as rsyn
from repro_torch import interop
from repro_torch.core import fcm as pfcm
from repro_torch.core import sketch as psk
from repro_torch.core.hashing import KeySchema
from repro_torch.core.range_opt import optimal_ranges_mod2
from repro_torch.streams import ngram_hh_workload, observed_error
from repro_torch.streams import synthetic as psyn


def _assert_stream_equal(got, want):
    assert got.schema.domains == want.schema.domains and got.name == want.name
    assert got.items.dtype == want.items.dtype and got.freqs.dtype == want.freqs.dtype
    np.testing.assert_array_equal(got.items, want.items)
    np.testing.assert_array_equal(got.freqs, want.freqs)


@pytest.mark.parametrize("kw", [dict(), dict(n_src_hosts=3_000, n_tgt_hosts=400,
                                             n_pairs=20_000, n_occurrences=90_000, seed=4)])
def test_ipv4_stream_and_reinterpretations_match_reference(kw):
    got, want = psyn.ipv4_stream(**kw), rsyn.ipv4_stream(**kw)
    _assert_stream_equal(got, want)
    for words in (4, 8):
        _assert_stream_equal(psyn.reinterpret_modularity(got, words),
                             rsyn.reinterpret_modularity(want, words))
    with pytest.raises(ValueError, match="words"):
        psyn.reinterpret_modularity(got, 3)
    with pytest.raises(ValueError, match="two x 32-bit"):
        psyn.reinterpret_modularity(psyn.reinterpret_modularity(got, 4), 8)


@pytest.mark.parametrize("kw", [dict(), dict(n_users=2_000, n_calls=9_000, seed=5)])
def test_telecom_stream_matches_reference(kw):
    _assert_stream_equal(psyn.telecom_stream(**kw), rsyn.telecom_stream(**kw))


@pytest.mark.parametrize("kw", [dict(), dict(vocab_size=64, n=3, n_sequences=8,
                                             seq_len=64, phi=0.01, seed=2)])
def test_ngram_hh_workload_matches_reference(kw):
    got, want = ngram_hh_workload(**kw), r_ngram_hh_workload(**kw)
    _assert_stream_equal(got.stream, want.stream)
    assert got.threshold == want.threshold
    np.testing.assert_array_equal(got.exact_items, want.exact_items)
    np.testing.assert_array_equal(got.exact_freqs, want.exact_freqs)


@pytest.mark.parametrize("k", [4, 16, 300])
def test_misra_gries_matches_reference(k):
    rng = np.random.default_rng(k)
    heavy = np.full(5000, 7, dtype=np.uint64)
    noise = rng.integers(100, 10_000, size=20_000).astype(np.uint64)
    keys = np.concatenate([heavy, noise])
    rng.shuffle(keys)
    freqs = rng.integers(1, 5, size=keys.shape[0])
    got, want = pfcm.MisraGries(k), rfcm.MisraGries(k)
    for s in range(0, len(keys), 1000):
        got.offer(keys[s:s + 1000], freqs[s:s + 1000])
        want.offer(keys[s:s + 1000], freqs[s:s + 1000])
        assert got.heavy_hitters() == want.heavy_hitters() and got.total == want.total
    hh = got.heavy_hitters()
    assert 7 in hh and len(hh) <= k
    assert hh[7] >= int(freqs[keys == 7].sum()) - int(freqs.sum()) / k - 1
    np.testing.assert_array_equal(got.is_heavy(keys[:500]), want.is_heavy(keys[:500]))


def test_pack_keys_matches_reference():
    items = np.array([[1, 12], [11, 2], [0, 0], [99, 99]], dtype=np.uint32)
    got = pfcm.pack_keys(KeySchema((100, 100)), items)
    assert len(np.unique(got)) == 4
    np.testing.assert_array_equal(got, rfcm.pack_keys(rh.KeySchema((100, 100)), items))
    big = np.array([[0xFFFFFFFF, 0xFFFFFFFF], [1, 0]], dtype=np.uint32)
    np.testing.assert_array_equal(
        pfcm.pack_keys(KeySchema((1 << 32, 1 << 32)), big),
        rfcm.pack_keys(rh.KeySchema((1 << 32, 1 << 32)), big))


@functools.lru_cache(maxsize=1)
def _small_ipv4():
    return psyn.ipv4_stream(n_src_hosts=4_000, n_tgt_hosts=500, n_pairs=30_000,
                            n_occurrences=200_000, seed=2)


def _fcm_pair(kind, stream, h=512, w=5, mg_k=128, seed=3):
    rschema, pschema = rh.KeySchema(stream.schema.domains), KeySchema(stream.schema.domains)
    if kind == "fcm":
        rspec, pspec = rfcm.fcm_spec(rschema, h, w, mg_k), pfcm.fcm_spec(pschema, h, w, mg_k)
    else:
        rng = np.random.default_rng(0)
        s_items, s_freqs = stream.sample(0.03, rng)
        a, b = optimal_ranges_mod2(s_items, s_freqs, h)
        rspec = rfcm.fmod_spec(rschema, [(0,), (1,)], (a, b), w, mg_k)
        pspec = pfcm.fmod_spec(pschema, [(0,), (1,)], (a, b), w, mg_k)
    ref = rfcm.FCM(rspec, jax.random.PRNGKey(11), seed=seed)
    port = pfcm.FCM(pspec, (np.asarray(ref.params.q), np.asarray(ref.params.r)),
                    seed=seed, device="cpu")
    return ref, port


@pytest.mark.parametrize("kind", ["fcm", "fmod"])
def test_fcm_tables_and_queries_match_reference(kind):
    stream = _small_ipv4()
    ref, port = _fcm_pair(kind, stream)
    assert (port.spec.d_hf, port.spec.d_lf, port.spec.mg_k) == (
        ref.spec.d_hf, ref.spec.d_lf, ref.spec.mg_k)
    block = 1 << 13
    for s in range(0, stream.items.shape[0], block):
        ref.update(stream.items[s:s + block], stream.freqs[s:s + block])
        port.update(stream.items[s:s + block], stream.freqs[s:s + block])
    assert port.table.dtype == torch.int64
    np.testing.assert_array_equal(port.table.numpy(), ref.table)
    assert port.mg.heavy_hitters() == ref.mg.heavy_hitters()
    rng = np.random.default_rng(1)
    for qi, _ in (stream.random_k_queries(500, rng), stream.top_k_queries(200)):
        got, want = port.query(qi), ref.query(qi)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    # the state carried across by interop answers the same
    carried = interop.fcm_from_numpy(port.spec, np.asarray(ref.params.q),
                                     np.asarray(ref.params.r), ref.table, seed=3,
                                     counters=ref.mg.counters, mg_total=ref.mg.total,
                                     device="cpu")
    qi, _ = stream.random_k_queries(300, rng)
    np.testing.assert_array_equal(carried.query(qi), ref.query(qi))


def test_fcm_spec_validation_and_defaults():
    schema = KeySchema((1 << 32, 1 << 32))
    spec = pfcm.fcm_spec(schema, 4096, 5)
    assert (spec.d_hf, spec.d_lf, spec.mg_k) == (1, 3, 256)
    with pytest.raises(ValueError, match="row subset"):
        pfcm.FCMSpec(base=psk.count_min_spec(schema, 64, 3), d_hf=4, d_lf=1, mg_k=8)
    with pytest.raises(ValueError, match="does not match"):
        interop.fcm_from_numpy(spec, *[np.zeros((5, 4), np.uint32), np.zeros((5, 1),
                                                                             np.uint32)],
                               np.zeros((5, 7), np.int64), device="cpu")


def test_fcm_and_fmod_beat_count_min_on_skewed_stream():
    """Fig. 10 ordering on the port: FMOD <= FCM <= Count-Min observed error
    (within the reference test's 5% slack), in the paper's regime."""
    stream = psyn.zipf_graph_stream(n_src=20_000, n_tgt=60_000, n_edges=300_000,
                                    n_occurrences=1_500_000, s_src=0.7, s_tgt=0.7,
                                    seed=1)
    h, w = 2048, 6
    rng = np.random.default_rng(0)
    s_items, s_freqs = stream.sample(0.03, rng)
    a, b = optimal_ranges_mod2(s_items, s_freqs, h)
    gen = torch.Generator().manual_seed(0)
    cm_spec = psk.count_min_spec(stream.schema, h, w)
    cm = psk.build_sketch(cm_spec, gen, stream.items, stream.freqs, device="cpu")
    fcm = pfcm.FCM(pfcm.fcm_spec(stream.schema, h, w, mg_k=512), gen, device="cpu")
    fmod = pfcm.FCM(pfcm.fmod_spec(stream.schema, [(0,), (1,)], (a, b), w, mg_k=512),
                    gen, device="cpu")
    for s in range(0, len(stream.items), 1 << 15):
        fcm.update(stream.items[s:s + (1 << 15)], stream.freqs[s:s + (1 << 15)])
        fmod.update(stream.items[s:s + (1 << 15)], stream.freqs[s:s + (1 << 15)])
    qi, qf = stream.random_k_queries(500, rng)
    err_cm = observed_error(psk.query(cm_spec, cm, qi).numpy(), qf)
    err_fcm = observed_error(fcm.query(qi), qf)
    err_fmod = observed_error(fmod.query(qi), qf)
    assert err_fcm <= err_cm * 1.05
    assert err_fmod <= err_fcm * 1.05
