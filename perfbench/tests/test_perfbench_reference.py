"""The plain references, against loops written out item by item."""
import numpy as np
import pytest
import torch

from perfbench import trace
from perfbench import harness
from perfbench.reference import conservative, hashing
from perfbench.tests import tiny

P31 = (1 << 31) - 1


def _cell_loop(key, q, r, domains, partition, ranges):
    """One key's cell in one row, with Python integers."""
    digits = []
    for m, d in enumerate(domains):
        nd = max(1, ((d - 1).bit_length() + 15) // 16)
        digits.append([(key[m] >> (16 * c)) & 0xFFFF for c in range(nd)])
    cell, start = 0, [0]
    for m in range(len(domains)):
        start.append(start[-1] + len(digits[m]))
    for j, group in enumerate(partition):
        acc = int(r[j])
        for m in group:
            for c, x in enumerate(digits[m]):
                acc += int(q[start[m] + c]) * x
        stride = int(np.prod(ranges[j + 1:], dtype=np.int64))
        cell += (acc % P31 % ranges[j]) * stride
    return cell


@pytest.mark.parametrize("domains,partition,ranges", [
    ((1 << 32, 1 << 32), [[0], [1]], (16, 8)),
    ((1 << 32, 1 << 32), [[0, 1]], (64,)),
    ((300, 70000, 5), [[2], [0, 1]], (3, 11)),
])
def test_cells_against_a_loop(domains, partition, ranges):
    g = torch.Generator().manual_seed(1)
    nd = sum(hashing.digits_per_module(domains))
    q = torch.randint(0, P31, (3, nd), generator=g)
    r = torch.randint(0, P31, (3, len(partition)), generator=g)
    keys = torch.stack([torch.randint(0, d, (40,), generator=g) for d in domains], dim=1)
    got = hashing.cells(keys, q, r, domains, partition, ranges)
    for k in range(3):
        for b in range(keys.shape[0]):
            assert got[k, b] == _cell_loop(keys[b].tolist(), q[k].tolist(), r[k].tolist(),
                                           domains, partition, ranges)


def _stream(seed, n=400, h=24, w=3, repeat=True):
    g = torch.Generator().manual_seed(seed)
    cells = torch.randint(0, h, (w, n), generator=g)
    if repeat:   # runs of one key and repeated keys, as blocks of real streams have
        cells[:, 10:20] = cells[:, 10:11]
        cells[:, 300:] = cells[:, :100]
    freqs = torch.randint(0, 50, (n,), generator=g)
    freqs[::7] = 0
    return cells, freqs


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_rounds_fold_is_the_per_item_fold(seed, dtype):
    cells, freqs = _stream(seed)
    want = conservative.fold_per_item_(torch.zeros((3, 24), dtype=dtype), cells, freqs)
    folder = conservative.SerialFolder(torch.zeros((3, 24), dtype=dtype))
    for lo in range(0, cells.shape[1], 150):   # units, one after another
        folder.fold_(cells[:, lo:lo + 150], freqs[lo:lo + 150])
    assert torch.equal(folder.table, want)
    assert folder.rounds < cells.shape[1]


def test_rounds_of_a_unit_serve_every_pass_over_it():
    cells, freqs = _stream(4)
    table = torch.zeros((3, 24), dtype=torch.int32)
    want = table.clone()
    rounds = conservative.schedule(cells)
    folder = conservative.SerialFolder(table)
    for _ in range(3):
        conservative.fold_per_item_(want, cells, freqs)
        folder.fold_(cells, freqs, rounds)
    assert torch.equal(table, want)


def test_int32_wraps_as_the_program_does():
    table = torch.full((2, 4), (1 << 31) - 10, dtype=torch.int32)
    cells = torch.tensor([[0, 0], [1, 1]])
    freqs = torch.tensor([5, 20])
    want = conservative.fold_per_item_(table.clone(), cells, freqs)
    got = conservative.fold_serial_(table.clone(), cells, freqs)
    assert torch.equal(got, want)
    assert int(want[0, 0]) == (1 << 31) - 5   # the second estimate wrapped negative
    # the benchmark's int64 reference does not wrap, so a wrapped table differs
    wide = conservative.fold_serial_(table.to(torch.int64), cells, freqs)
    assert int(wide[0, 0]) == (1 << 31) + 15
    assert int((want.to(torch.int64) != wide).sum()) == 2


def test_scratch_of_the_schedule_is_left_as_found():
    cells, _ = _stream(5)
    first = torch.full((3, 24), torch.iinfo(torch.int32).max, dtype=torch.int32)
    again = first.clone()
    got = conservative.schedule(cells, first=first)
    assert torch.equal(first, again)
    assert [r.tolist() for r in got] == [r.tolist() for r in conservative.schedule(cells)]


@pytest.mark.parametrize("n_blocks", [7, 20, 53])
def test_units_over_passes_are_the_per_item_fold(n_blocks):
    """The system's reference (units of 16 blocks, the pool passed over
    again) against the per-item loop over the same sequence of blocks."""
    r = tiny.ingest(seed=3)
    system = harness.system(r.config["system"])
    made = system.inputs(r)
    keys, freqs = made[0], made[1]
    pool_cells, ref, want = system.reference(r, made, n_blocks)
    n_pool, rows = freqs.shape
    loop = torch.zeros_like(ref)
    for i in range(n_blocks):
        p = i % n_pool
        conservative.fold_per_item_(loop, pool_cells[:, p * rows:(p + 1) * rows],
                                    torch.from_numpy(freqs[p]))
    assert ref.dtype == torch.int64 and torch.equal(ref, loop)
    _, control, _ = system.reference(r, made, n_blocks, block_parallel=True)
    assert int((control != loop).sum()) > 0


def test_block_parallel_control_breaks_the_serial_fold():
    cells, freqs = _stream(3)
    serial = conservative.fold_serial_(torch.zeros((3, 24), dtype=torch.int32), cells, freqs)
    control = conservative.fold_block_parallel_(torch.zeros((3, 24), dtype=torch.int32),
                                                cells, freqs, 64)
    assert int((serial != control).sum()) > 0
    assert torch.equal(conservative.point_query(serial, cells[:, :5]),
                       serial.gather(1, cells[:, :5]).min(dim=0).values)


def test_trace_reader_matches_kernels_to_spans():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "span", "ts": 0, "dur": 10, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2, "dur": 1,
         "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12, "dur": 1,
         "tid": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "k_in", "ts": 5, "dur": 4, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k_out", "ts": 14, "dur": 2,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 20,
         "dur": 5, "args": {"bytes": 64}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 9, "dur": 11, "tid": 1},
    ]
    t = trace.parse({"traceEvents": ev})
    assert [k.name for k in trace.kernels_in_spans(t, "span")] == ["k_in"]
    assert trace.busy_us(t, 0, 30) == 4 + 2 + 5
    assert trace.top_device_ops(t, 0, 30)[0] == ["Memcpy HtoD (Pageable -> Device)", 5e-6]
    # idle [0, 5], [9, 14], [16, 20], [25, 30], longest first, each named by the
    # innermost host op at its midpoint
    assert trace.idle_gaps(t, 0, 30) == [["cudaLaunchKernel", 5e-6], ["aten::copy_", 5e-6],
                                         ["(no host op)", 5e-6], ["aten::copy_", 4e-6]]
