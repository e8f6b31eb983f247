"""``examples_torch/windowed_topk.py`` against ``examples/windowed_topk.py``.

The twin runs on the CPU with the reference's key (``RefKey(0)``); the
test drives the reference's three windowed services (tumbling, decay 0.5,
landmark) with the reference's DStream harness over the same drifting
batches, on its jnp paths, and compares every batch's report, the
tumbling and decayed windows' merged tables and the tumbling top-5.

Size: 10 of the example's 16 batches of 4,000 rows: five epochs of two
batches on a ring of three, so the ring wraps twice and the heavy set
drifts once (at batch 8, as in the example).  The reference's harness
re-jits its queries at every batch: all 16 take over a minute on a CPU, more
than this file's budget.  ``chip_smoke.py``'s examples phase runs all 16
on the card and on the CPU.

Tolerance 0: int32 tables and estimates, and the decayed window's float32
tables too (the port's Horner step rounds as the reference's fused
multiply-add does, ``core/window.merge_horner``).
"""
import dataclasses
import functools

import numpy as np

from _twins import RefKey, load_twin
from repro.core import sketch as rsk
from repro.serving.windowed_topk import WindowedTopKService as RefService
from repro.streams import dstream as rds

KEY = RefKey(0).key

wt = load_twin("windowed_topk")
N_BATCHES = 10


@functools.lru_cache(maxsize=1)
def _wt_twin():
    return wt.run("cpu", RefKey(0), n_batches=N_BATCHES)


@functools.lru_cache(maxsize=1)
def _wt_reference():
    spec = rsk.mod_sketch_spec(rsk.KeySchema(domains=wt.DOMAINS), [(0,), (1,)], (64, 64), 4)
    services = {
        "tumbling": RefService(spec, KEY, n_epochs=3),
        "decay": RefService(spec, KEY, n_epochs=3, window_mode="decay", decay=0.5),
        "landmark": RefService(spec, KEY, n_epochs=3, window_mode="landmark"),
    }
    reports = {}
    for name, svc in services.items():
        harness = rds.DStreamHarness(svc, k=16, phi=0.01)
        for batch in rds.drifting_batches(wt.DOMAINS, N_BATCHES, rows_per_batch=4_000,
                                          batches_per_epoch=2, drift_every=4,
                                          n_keys=1_000, seed=0):
            harness.step(batch)
        reports[name] = harness.reports
    return dict(reports=reports,
                tumbling_tables=[np.asarray(st.table)
                                 for st in services["tumbling"].state().states],
                decay_tables=[np.asarray(st.table) for st in services["decay"].state().states],
                top=services["tumbling"].topk(5))


def test_windowed_reports_match_the_example():
    got, want = _wt_twin()["reports"], _wt_reference()["reports"]
    assert list(got) == list(want)
    for name, reports in want.items():
        assert len(got[name]) == len(reports) == N_BATCHES
        for g, w in zip(got[name], reports):
            assert dataclasses.asdict(g) == dataclasses.asdict(w), (name, g.batch)
        assert got[name][-1].recall == 1.0


def test_windowed_tables_and_topk_match_the_example():
    got, want = _wt_twin(), _wt_reference()
    for which in ("tumbling_tables", "decay_tables"):
        assert len(got[which]) == len(want[which])
        for g, w in zip(got[which], want[which]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w, err_msg=which)
    np.testing.assert_array_equal(got["topk_items"], np.asarray(want["top"][0]))
    np.testing.assert_array_equal(got["topk_est"], np.asarray(want["top"][1]))
