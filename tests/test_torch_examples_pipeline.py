"""``examples_torch/stream_pipeline.py`` against ``examples/stream_pipeline.py``.

The twin runs on the CPU with the reference's keys (``RefKey(0)`` for the
search, ``RefKey(1)`` for the sketch and the baselines, as the example's
``PRNGKey(0)`` and ``PRNGKey(1)``); the test makes the example's calls on
the JAX package's jnp paths: ``greedy_config``, then in place of its
Pallas ``KernelSketch`` the same spec built by ``build_sketch`` (linear)
or folded by ``update_conservative`` block by block in stream order
(conservative: the fold is sequential in the items, so the blocks do not
change it), queried by ``query_jit``.  Sizes: linear at the example's
default 2,000,000 occurrences; conservative at 200,000, the smaller
``--occurrences`` its help text asks for (the jnp fold loops over the
items).  Tolerance 0 on every estimate and observed error (int32 tables).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _twins import RefKey, load_twin
from repro.core import greedy as rgr
from repro.core import sketch as rsk
from repro.streams import ipv4_stream as r_ipv4_stream
from repro.streams import observed_error as r_observed_error
from repro.streams import reinterpret_modularity as r_reinterpret_modularity

sp = load_twin("stream_pipeline")
H, W = 4096, 5
OCCURRENCES = {"linear": 2_000_000, "conservative": 200_000}


@functools.lru_cache(maxsize=None)
def _twin(mode):
    return sp.run("cpu", RefKey(0), RefKey(1), occurrences=OCCURRENCES[mode], mode=mode)


@functools.lru_cache(maxsize=None)
def _reference(mode):
    base = r_ipv4_stream(n_src_hosts=30_000, n_tgt_hosts=3_000, n_pairs=120_000,
                         n_occurrences=OCCURRENCES[mode])
    stream = r_reinterpret_modularity(base, 8)
    rng = np.random.default_rng(0)
    s_items, s_freqs = stream.sample(0.02, rng)
    g = rgr.greedy_config(s_items, s_freqs, stream.schema, H, W, jax.random.PRNGKey(0))
    key1 = jax.random.PRNGKey(1)
    if mode == "linear":
        state = rsk.build_sketch(g.spec, key1, stream.items, stream.freqs)
    else:
        state = rsk.init_state(g.spec, key1)
        for s in range(0, len(stream.items), sp.INGEST_BLOCK):
            state = rsk.update_conservative_jit(
                g.spec, state, jnp.asarray(stream.items[s : s + sp.INGEST_BLOCK]),
                jnp.asarray(stream.freqs[s : s + sp.INGEST_BLOCK]))
    queries = {}
    for qname, (qi, qf) in (("top-500", stream.top_k_queries(500)),
                            ("random-500", stream.random_k_queries(500, rng))):
        est = np.asarray(rsk.query_jit(g.spec, state, jnp.asarray(qi)))
        queries[qname] = dict(est=est, error=r_observed_error(est, qf))
    baselines = {}
    for name, spec in {"count-min": rsk.count_min_spec(stream.schema, H, W),
                       "equal-sketch": rsk.equal_sketch_spec(stream.schema, H, W)}.items():
        st = rsk.build_sketch(spec, key1, stream.items, stream.freqs)
        qi, qf = stream.top_k_queries(500)
        est = np.asarray(rsk.query_jit(spec, st, jnp.asarray(qi)))
        baselines[name] = dict(est=est, error=r_observed_error(est, qf))
    return dict(name=stream.name, distinct=len(stream.items), total=stream.total,
                n_candidates=g.n_candidates, describe=g.spec.describe(),
                seen=int(stream.freqs.sum()), queries=queries, baselines=baselines)


@pytest.mark.parametrize("mode", ["linear", "conservative"])
def test_stream_and_greedy_config_match_the_example(mode):
    got, want = _twin(mode), _reference(mode)
    for k in ("name", "distinct", "total", "n_candidates", "describe", "seen"):
        assert got[k] == want[k], k
    assert got["mode"] == mode and got["device"] == "the CPU"


@pytest.mark.parametrize("mode", ["linear", "conservative"])
def test_kernel_sketch_answers_as_the_example(mode):
    got, want = _twin(mode)["queries"], _reference(mode)["queries"]
    assert list(got) == list(want)
    for qname, q in want.items():
        np.testing.assert_array_equal(got[qname]["est"], q["est"], err_msg=qname)
        assert got[qname]["error"] == q["error"], qname


@pytest.mark.parametrize("mode", ["linear", "conservative"])
def test_baselines_answer_as_the_example(mode):
    got, want = _twin(mode)["baselines"], _reference(mode)["baselines"]
    assert list(got) == list(want)
    for name, b in want.items():
        np.testing.assert_array_equal(got[name]["est"], b["est"], err_msg=name)
        assert got[name]["error"] == b["error"], name


def test_conservative_is_tighter_than_linear_on_the_same_spec():
    """Where the two modes' greedy specs agree, every conservative estimate
    is at most the linear one over the same stream."""
    lin = sp.run("cpu", RefKey(0), RefKey(1), occurrences=OCCURRENCES["conservative"])
    cons = _twin("conservative")
    assert lin["describe"] == cons["describe"]
    for qname, q in cons["queries"].items():
        assert (q["est"] <= lin["queries"][qname]["est"]).all(), qname
