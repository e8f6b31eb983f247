"""``examples_torch/ngram_stats.py`` against ``examples/ngram_stats.py``.

The twin trains on the CPU from the reference's own initial state (its
``init_train_state(cfg, tcfg, PRNGKey(0))``: weights and bigram hash
draw, carried across by ``repro_torch.interop``); the test runs the
example's jitted reference steps on the same synthetic batches, at the
example's own sizes (reduced gemma2, 40 steps of 8 x 64 tokens).

Tolerances:
- the bigram table, the top-10 bigrams and their sketch estimates: 0
  (int32 counts of the same tokens under the same hash);
- the first step's loss: rtol 1e-5, as ``test_torch_training.py``'s one
  train step (the same weights; bfloat16 matmuls summed in another order);
- every loss: finite, and within LOSS_RTOL (2e-4) of the reference's.
  The 40 bfloat16 steps drift apart by at most 4.84e-5 relative on a
  CPU (the first step by 3.8e-7); the bound leaves four times that.
"""
import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np

from _twins import RefKey, load_twin, ngram_train_config
from repro import configs as rconfigs
from repro.core import sketch as rsk
from repro.training import train_loop as rtl

ng = load_twin("ngram_stats")
STEPS, BATCH, SEQ = 40, 8, 64
LOSS_RTOL = 2e-4


@functools.lru_cache(maxsize=1)
def _twin():
    return ng.run("cpu", RefKey(0))


@functools.lru_cache(maxsize=1)
def _reference():
    cfg, tcfg = rconfigs.get_reduced("gemma2-9b"), ngram_train_config()
    state = RefKey(0).ref_train_state()
    step_fn = jax.jit(rtl.make_train_step(cfg, tcfg))
    data = rtl.synthetic_batches(cfg, BATCH, SEQ)
    exact = collections.Counter()
    losses = []
    for s in range(STEPS):
        toks = data(s)["tokens"]
        for row in toks:
            exact.update(zip(row[:-1].tolist(), row[1:].tolist()))
        state, metrics = step_fn(state, {"tokens": jnp.asarray(toks)})
        losses.append(float(metrics["loss"]))
    spec = rtl.make_sketch_spec(cfg)
    sketch_state = rsk.SketchState(params=state["sketch_params"], table=state["sketch_table"])
    top = exact.most_common(10)
    grams = np.array([g for g, _ in top], dtype=np.uint32)
    est = np.asarray(rsk.query_jit(spec, sketch_state, jnp.asarray(grams)))
    return dict(losses=losses, grams=grams, exact=np.array([c for _, c in top]), est=est,
                table=np.asarray(sketch_state.table))


def test_bigram_sketch_equals_the_example():
    got, want = _twin(), _reference()
    np.testing.assert_array_equal(got["table"], want["table"])
    np.testing.assert_array_equal(got["grams"], want["grams"])
    np.testing.assert_array_equal(got["exact"], want["exact"])
    np.testing.assert_array_equal(got["est"], want["est"])
    assert got["total_mass"] == STEPS * BATCH * (SEQ - 1)
    assert (got["est"] >= got["exact"]).all()


def test_first_step_loss_matches_the_example():
    np.testing.assert_allclose(_twin()["losses"][0], _reference()["losses"][0], rtol=1e-5)


def test_losses_stay_within_the_drift_of_bfloat16_steps():
    got, want = np.array(_twin()["losses"]), np.array(_reference()["losses"])
    assert got.shape == (STEPS,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]
