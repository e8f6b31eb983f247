"""The harness around the systems: the traffic generator, and what
``run.py`` does where it cannot run."""
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import harness

STREAM = {"n_src": 40, "n_tgt": 124, "n_edges": 500, "n_occurrences": 5000,
          "s_src": 0.79, "s_tgt": 0.79}


@pytest.mark.parametrize("order", ["random", "source"])
def test_edge_blocks(order):
    gen = harness.generator("edge_blocks")
    traffic = {"stream_seed": 11, "block_rows": 32, "pool_blocks": 6, "order": order}
    keys, counts = gen.generate(STREAM, traffic, 5, "cpu")
    again, _ = gen.generate(STREAM, traffic, 5, "cpu")
    other, _ = gen.generate(STREAM, traffic, 6, "cpu")
    assert keys.shape == (6, 32, 2) and keys.dtype == np.uint32
    assert counts.shape == (6, 32) and (counts > 0).all()
    for block in keys:                                         # distinct edges in a block
        assert len(np.unique(block, axis=0)) == block.shape[0]
    assert np.array_equal(keys, again) and not np.array_equal(keys, other)
    # the blocks are the pass's first intervals, aggregated
    g = torch.Generator().manual_seed(11)       # the stream's edges and arrivals
    edges, arrivals = gen.one_pass(STREAM, g)
    g.manual_seed(5)                             # their order
    arrivals = arrivals[torch.randperm(arrivals.numel(), generator=g)]
    ends = gen.interval_ends(arrivals, 32, 6)
    assert counts.sum() == int(ends[-1])
    # every seed's blocks draw on the same edges
    known = {(int(e) >> 32 & 0xFFFFFFFF, int(e) & 0xFFFFFFFF) for e in edges}
    assert {tuple(map(int, k)) for k in other.reshape(-1, 2)} <= known
    packed = keys[..., 0].astype(np.uint64) << np.uint64(32) | keys[..., 1]
    for b in range(6):
        lo = 0 if b == 0 else int(ends[b - 1])
        seen, n = np.unique(edges[arrivals[lo:int(ends[b])]].numpy().astype(np.uint64),
                            return_counts=True)
        order_b = np.argsort(packed[b])
        assert np.array_equal(packed[b][order_b], seen)
        assert np.array_equal(counts[b][order_b], n)
        if order == "source":
            assert (np.diff(packed[b].astype(np.float64)) > 0).all()


def test_intervals_are_cut_greedily():
    arrivals = torch.tensor([0, 1, 0, 2, 1, 3, 3, 4, 0, 5, 6, 5, 7])
    # intervals of 3 distinct values: [0 1 0 2 1] [3 3 4 0] [5 6 5 7 ...
    assert gen_ends(arrivals, 3, 2) == [5, 9]
    with pytest.raises(RuntimeError):
        gen_ends(arrivals, 3, 3)          # the third holds 3 values, not 4 with the next


def gen_ends(arrivals, rows, blocks):
    return harness.generator("edge_blocks").interval_ends(arrivals, rows, blocks).tolist()


def test_a_metric_split_by_what_it_moves_shares_a_reader():
    shared = harness.metric_reader("idle_pct.ingest").__file__
    assert shared.endswith("metrics/idle_pct.py")
    assert harness.metric_reader("idle_pct.train").__file__ == shared
    with pytest.raises(harness.BenchError):
        harness.metric_reader("no_such_metric.ingest")


def test_host_readings():
    got = harness.host_readings({"t": 0.0, "cpu_s": 1.0}, {"t": 2.0, "cpu_s": 2.0})
    assert got == {"process_cpu_pct": 50.0}
    probe = harness.host_probe_ms(reps=1)
    assert set(probe) == {"copy", "alloc"} and min(probe.values()) > 0


def _run(cwd, *extra):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", "twitter-cu.ingest",
                           "--seed", "1", "--seconds", "1", *extra],
                          capture_output=True, text=True, timeout=240, cwd=cwd)


def test_no_result_without_a_card():
    out = _run(harness.ROOT)
    assert out.returncode == 3 and out.stdout == ""


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "perfbench")
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
