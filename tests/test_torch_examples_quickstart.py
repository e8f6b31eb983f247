"""``examples_torch/quickstart.py`` against ``examples/quickstart.py``.

The twin runs on the CPU with the reference's key (``_twins.RefKey(0)``);
the test makes the example's calls on the JAX package's jnp paths
(``choose_sketch``, ``build_sketch``, ``query_jit``) on the same stream,
at the example's own sizes.  Tolerances: 0 on every estimate and observed
error (int32 sketches); the selection's sigmas are float32 reductions
taken in another order, rtol 1e-5.  One test runs the twin's ``main``
end to end with ``--device cpu``.
"""
import functools

import jax.numpy as jnp
import numpy as np

from _twins import RefKey, load_twin
from repro.core import selection as rsel
from repro.core import sketch as rsk
from repro.streams import observed_error as r_observed_error
from repro.streams import zipf_graph_stream as r_zipf_graph_stream

qs = load_twin("quickstart")
H, W = 4096, 5


@functools.lru_cache(maxsize=1)
def _twin():
    return qs.run("cpu", RefKey(0))


@functools.lru_cache(maxsize=1)
def _reference():
    key = RefKey(0).key
    stream = r_zipf_graph_stream(**qs.STREAM)
    rng = np.random.default_rng(0)
    s_items, s_freqs = stream.sample(0.02, rng)
    result = rsel.choose_sketch(s_items, s_freqs, stream.schema, H, W, key)
    a, b = result.mod_ranges
    qsets = {"top-500": stream.top_k_queries(500),
             "random-500": stream.random_k_queries(500, rng)}
    methods = {}
    for name, spec in {
        "count-min": rsk.count_min_spec(stream.schema, H, W),
        "equal-sketch": rsk.equal_sketch_spec(stream.schema, H, W),
        "mod-sketch": rsk.mod_sketch_spec(stream.schema, [(0,), (1,)], (a, b), W),
        "selected": result.spec,
    }.items():
        state = rsk.build_sketch(spec, key, stream.items, stream.freqs)
        est = {qname: np.asarray(rsk.query_jit(spec, state, jnp.asarray(qi)))
               for qname, (qi, _) in qsets.items()}
        methods[name] = dict(describe=spec.describe(), est=est,
                             error={qname: r_observed_error(est[qname], qf)
                                    for qname, (_, qf) in qsets.items()})
    return dict(distinct=len(stream.items), total=stream.total, ranges=(a, b),
                choice=result.choice, sigma=result.sigma, methods=methods)


def test_stream_and_selection_match_the_example():
    got, want = _twin(), _reference()
    assert (got["distinct"], got["total"]) == (want["distinct"], want["total"])
    assert got["ranges"] == want["ranges"]
    assert got["sigma"].keys() == want["sigma"].keys()
    for name, sigma in want["sigma"].items():
        np.testing.assert_allclose(got["sigma"][name], sigma, rtol=1e-5)
    s = sorted(want["sigma"].values())
    assert s[1] - s[0] > 1e-5 * s[1], "the choice is a near tie; compare it by hand"
    assert got["choice"] == want["choice"]


def test_every_method_answers_as_the_example():
    got, want = _twin()["methods"], _reference()["methods"]
    assert list(got) == list(want)
    for name, m in want.items():
        assert got[name]["describe"] == m["describe"], name
        for qname, est in m["est"].items():
            np.testing.assert_array_equal(got[name]["est"][qname], est, err_msg=name)
            assert got[name]["error"][qname] == m["error"][qname], (name, qname)


def test_main_runs_on_the_cpu(capsys):
    assert qs.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("stream: ") and lines[1].startswith("Thm-3 ranges: ")
    assert [line.split()[0] for line in lines[2:]] == [
        "count-min", "equal-sketch", "mod-sketch", "selected"]
