"""``examples_torch/heavy_hitters.py``, ``async_serving.py`` and
``sharded_serving.py`` against their examples.

Each twin runs on the CPU with the reference's key (``RefKey(0)``, the
examples' ``PRNGKey(0)``), at its example's own sizes; the test makes the
example's calls on the JAX package's jnp paths:

- ``heavy_hitters``: ``build_hierarchy`` and the jnp
  ``find_heavy_hitters`` (the example's ``use_kernel=True`` leg is its
  Pallas kernel, which the twin's plain and kernel legs are both held
  against through the jnp answer), two merged linear endpoints and a
  conservative endpoint;
- ``async_serving``: the engine's single-threaded first phase (its
  staleness readings) and a synchronous endpoint over the whole stream;
  the threaded phase's round count depends on timing and is not compared;
- every sharded part (``heavy_hitters``' 1- and 4-shard services,
  ``sharded_serving``'s promotion to 8 shards): the reference's sharded
  legs stop under jax 0.9 (its ``ShardingTypeError``), so their
  tables and answers are held against the reference's single-device
  endpoint fed the whole stream.

Tolerance 0 throughout (int32 tables and estimates).
"""
import functools

import numpy as np

from _twins import RefKey, load_twin
from repro.core import hierarchy as rhh
from repro.core import sketch as rsk
from repro.serving.sketch_engine import SketchServeEngine as RefEngine
from repro.serving.sketch_engine import SketchTopKEndpoint as RefEndpoint
from repro.streams import ngram_hh_workload as r_ngram_hh_workload
from repro.streams import zipf_hh_workload as r_zipf_hh_workload

KEY = RefKey(0).key


def _endpoint(spec, items, freqs, **kw):
    ep = RefEndpoint(spec, KEY, **kw)
    ep.ingest(items, freqs)
    return ep


def _tables(ep):
    return [np.asarray(st.table) for st in ep.state.states]


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# --------------------------------------------------------------------------
# heavy_hitters
# --------------------------------------------------------------------------

hh_twin = load_twin("heavy_hitters")


@functools.lru_cache(maxsize=1)
def _hh_twin():
    return hh_twin.run("cpu", RefKey(0))


@functools.lru_cache(maxsize=1)
def _hh_reference():
    descents = []
    for wl, ranges in ((r_zipf_hh_workload(n_occurrences=100_000), (256, 256)),
                       (r_ngram_hh_workload(vocab_size=512, n=2), (128, 128))):
        stream = wl.stream
        base = rsk.mod_sketch_spec(stream.schema, [(0,), (1,)], ranges, 4)
        hspec = rhh.HierarchySpec.from_spec(base)
        state = rhh.build_hierarchy(hspec, KEY, stream.items, stream.freqs)
        items, est = rhh.find_heavy_hitters(hspec, state, wl.threshold, wl.candidates(base))
        descents.append(dict(name=stream.name, total=stream.total, threshold=wl.threshold,
                             items=items, est=est))
    wl = r_zipf_hh_workload(n_occurrences=100_000, seed=1)
    items, freqs = wl.stream.items, wl.stream.freqs
    spec = rsk.mod_sketch_spec(wl.stream.schema, [(0,), (1,)], (256, 256), 4)
    half = len(items) // 2
    shards = [_endpoint(spec, items[:half], freqs[:half]),
              _endpoint(spec, items[half:], freqs[half:])]
    shards[0].merge_from(shards[1])
    whole = _endpoint(spec, items, freqs)
    cons = _endpoint(spec, items, freqs, mode="conservative")
    return dict(descents=descents, merged=shards[0].topk(10), whole=whole,
                whole_top=whole.topk(10), cons=cons.topk(10), exact_top=wl.exact_freqs[:10])


def test_heavy_hitters_descents_match_the_example():
    got, want = _hh_twin()["descents"], _hh_reference()["descents"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert (g["name"], g["total"], g["threshold"]) == (w["name"], w["total"],
                                                           w["threshold"])
        np.testing.assert_array_equal(g["items"], w["items"])
        np.testing.assert_array_equal(g["est"], w["est"])
        assert g["false_neg"] == 0


def test_heavy_hitters_endpoints_match_the_example():
    got, want = _hh_twin(), _hh_reference()
    _equal((got["topk_items"], got["topk_est"]), want["merged"])
    _equal((got["cons_items"], got["cons_est"]), want["cons"])
    np.testing.assert_array_equal(got["exact_top"], want["exact_top"])


def test_heavy_hitters_sharded_services_equal_the_single_endpoint():
    got, want = _hh_twin(), _hh_reference()
    _equal(got["sharded_tables"], _tables(want["whole"]))
    _equal((got["sharded_items"], got["sharded_est"]), want["whole_top"])


# --------------------------------------------------------------------------
# async_serving
# --------------------------------------------------------------------------

as_twin = load_twin("async_serving")


@functools.lru_cache(maxsize=1)
def _as_twin():
    return as_twin.run("cpu", RefKey(0))


@functools.lru_cache(maxsize=1)
def _as_reference():
    wl = r_zipf_hh_workload(n_occurrences=120_000, n_edges=12_000, seed=7)
    spec = rsk.mod_sketch_spec(wl.stream.schema, [(0,), (1,)], (128, 128), 4)
    items, freqs = wl.stream.items, wl.stream.freqs
    block = as_twin.BLOCK
    blocks = [(items[s:s + block], freqs[s:s + block]) for s in range(0, len(items), block)]
    bound = wl.stream.total // 4
    eng = RefEngine(RefEndpoint(spec, KEY), max_staleness=bound)
    staleness = []
    for b, (bi, bf) in enumerate(blocks[:len(blocks) // 2]):
        eng.ingest(bi, bf)
        if (b + 1) % 2 == 0:
            before = eng.staleness
            eng.topk(5)
            staleness.append((b + 1, before, eng.staleness))
    ref = _endpoint(spec, items, freqs)
    return dict(bound=bound, staleness=staleness, top=ref.topk(10),
                hh=ref.heavy_hitters(wl.threshold), threshold=wl.threshold)


def test_async_staleness_readings_match_the_example():
    got, want = _as_twin(), _as_reference()
    assert got["bound"] == want["bound"]
    assert got["staleness"] == want["staleness"]
    assert got["rounds"] >= 1


def test_async_answers_after_sync_equal_the_synchronous_endpoint():
    got, want = _as_twin(), _as_reference()
    _equal((got["topk_items"], got["topk_est"]), want["top"])
    _equal((got["hh_items"], got["hh_est"]), want["hh"])
    assert got["threshold"] == want["threshold"] and got["false_neg"] == 0


# --------------------------------------------------------------------------
# sharded_serving
# --------------------------------------------------------------------------

ss_twin = load_twin("sharded_serving")


@functools.lru_cache(maxsize=1)
def _ss_twin():
    return ss_twin.run("cpu", RefKey(0))


@functools.lru_cache(maxsize=1)
def _ss_reference():
    wl = r_zipf_hh_workload(n_occurrences=150_000, n_edges=15_000, seed=4)
    spec = rsk.mod_sketch_spec(wl.stream.schema, [(0,), (1,)], (256, 256), 4)
    items, freqs = wl.stream.items, wl.stream.freqs
    q = len(items) // 4
    whole = _endpoint(spec, items, freqs)
    return dict(endpoint_total=_endpoint(spec, items[:q], freqs[:q]).total,
                stream_total=wl.stream.total, tables=_tables(whole), top=whole.topk(10),
                hh=whole.heavy_hitters(wl.threshold), threshold=wl.threshold)


def test_sharded_serving_promotion_matches_the_example():
    got, want = _ss_twin(), _ss_reference()
    assert (got["endpoint_total"], got["stream_total"]) == (want["endpoint_total"],
                                                            want["stream_total"])
    assert (got["n_shards"], got["data_axes"]) == (8, ("data",))
    _equal(got["tables"], want["tables"])


def test_sharded_serving_answers_equal_the_single_endpoint():
    got, want = _ss_twin(), _ss_reference()
    _equal((got["topk_items"], got["topk_est"]), want["top"])
    _equal((got["hh_items"], got["hh_est"]), want["hh"])
    assert got["threshold"] == want["threshold"] and got["false_neg"] == 0
