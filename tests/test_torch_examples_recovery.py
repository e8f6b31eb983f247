"""``examples_torch/fault_recovery.py`` against ``examples/fault_recovery.py``.

The twin runs on the CPU with the reference's key (``RefKey(0)``), at
the example's own sizes; the test runs the uninterrupted endpoint and
both supervised crashes (the kill, the corrupted snapshot) on the
reference's ``ServingSupervisor`` and jnp endpoint.  The example's
2 -> 4 shard remesh stops in the reference under jax 0.9 (its
``ShardingTypeError``), so the twin's remeshed service is held against
the single-device endpoint.  Tolerance 0 (int32 tables and estimates).
"""
import functools
import tempfile

import numpy as np

from _twins import RefKey, load_twin
from repro.core import sketch as rsk
from repro.serving.faults import FaultPlan as RefPlan
from repro.serving.faults import ServingSupervisor as RefSupervisor
from repro.serving.sketch_engine import SketchTopKEndpoint as RefEndpoint
from repro.streams import zipf_hh_workload as r_zipf_hh_workload

KEY = RefKey(0).key

fr = load_twin("fault_recovery")


@functools.lru_cache(maxsize=1)
def _fr_twin():
    return fr.run("cpu", RefKey(0))


@functools.lru_cache(maxsize=1)
def _fr_reference():
    wl = r_zipf_hh_workload(n_occurrences=60_000, n_edges=8_000, seed=5)
    spec = rsk.mod_sketch_spec(wl.stream.schema, [(0,), (1,)], (128, 128), 4)
    items, freqs = wl.stream.items, wl.stream.freqs
    ops = [("block", items[s:s + fr.BLOCK], freqs[s:s + fr.BLOCK])
           for s in range(0, len(items), fr.BLOCK)]
    ref = RefEndpoint(spec, KEY)
    for _, it, f in ops:
        ref.ingest(it, f)
    recoveries = {}
    for name, corrupt in (("kill", False), ("corrupt", True)):
        with tempfile.TemporaryDirectory() as d:
            sup = RefSupervisor(d, lambda: RefEndpoint(spec, KEY), snapshot_every=8)
            eng, rep = sup.run(ops, RefPlan(crash_after_ops=len(ops) // 2,
                                            corrupt_newest_snapshot=corrupt))
            r = rep.recoveries[-1]
            recoveries[name] = dict(restored_step=r.restored_step,
                                    replayed_blocks=r.replayed_blocks,
                                    corrupted_steps=list(r.corrupted_steps),
                                    top=eng.topk(10))
    return dict(n_ops=len(ops), stream_total=wl.stream.total, top=ref.topk(10),
                recoveries=recoveries)


def test_fault_recovery_reports_match_the_example():
    got, want = _fr_twin(), _fr_reference()
    assert (got["n_ops"], got["stream_total"]) == (want["n_ops"], want["stream_total"])
    for name, r in want["recoveries"].items():
        assert got["recoveries"][name] == {k: v for k, v in r.items() if k != "top"}, name
        np.testing.assert_array_equal(r["top"][0], want["top"][0])


def test_fault_recovery_answers_equal_the_uninterrupted_endpoint():
    """The twin's recovered engines and its remeshed service answer as its
    own uninterrupted endpoint (asserted inside ``run``), which answers as
    the reference's."""
    got, want = _fr_twin(), _fr_reference()
    np.testing.assert_array_equal(got["topk_items"], want["top"][0])
    np.testing.assert_array_equal(got["topk_est"], want["top"][1])
    assert got["remesh_total"] == want["stream_total"]
