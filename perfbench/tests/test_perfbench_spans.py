"""The readers of the program's own spans (``program_spans.py`` and the
metrics built on it): on a chrome trace written by hand, and on a traced
CPU run of the system, which holds the names copied here against the
program."""
import pytest

from perfbench import harness, program_spans
from perfbench import trace
from perfbench.tests import tiny

IDLE = {"keys": "idle_keys_ms.ingest", "freqs": "idle_freqs_ms.ingest",
        "launch": "idle_launch_ms.ingest", "update": "idle_update_ms.ingest",
        "caller": "idle_caller_ms.ingest"}
OPS = "device_ops_per_block.ingest"


def _x(cat, name, ts, dur, tid=None, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if tid is not None:
        ev["tid"] = tid
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


# window [0, 100] on thread 1; one update [10, 70] with its steps
SPANS = [
    _x("user_annotation", program_spans.UPDATE, 10, 60, tid=1),
    _x("user_annotation", program_spans.CHECK, 12, 3, tid=1),
    _x("user_annotation", program_spans.KEYS, 15, 15, tid=1),
    _x("user_annotation", program_spans.FREQS, 30, 10, tid=1),
    _x("user_annotation", program_spans.CONSERVATIVE, 40, 10, tid=1),
    # another thread's program span is not the caller's
    _x("user_annotation", program_spans.KEYS, 50, 50, tid=2),
]
OTHER = [
    _x("user_annotation", harness.WINDOW_SPAN, 0, 100, tid=1),
    # operators and runtime calls are passed over, even where innermost
    _x("cpu_op", "aten::copy_", 16, 19, tid=1),
    _x("cuda_runtime", "cudaMemsetAsync", 18, 1, tid=1, corr=4),
    _x("cuda_runtime", "cudaMemcpyAsync", 20, 1, tid=1, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 42, 1, tid=1, corr=2),
    _x("cuda_runtime", "cudaMemcpyAsync", 80, 1, tid=1, corr=3),   # outside every update
    _x("kernel", "k_before", 0, 5, corr=9),
    _x("gpu_memset", "Memset (Device)", 20, 1, corr=4),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 20, 2, corr=1),
    _x("kernel", "k_fold", 45, 35, corr=2),
    _x("kernel", "k_empty", 30, 0, corr=10),                       # splits a gap, no time
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 85, 5, corr=3),
]
# idle [5, 20], [22, 45], [80, 85], [90, 100], in microseconds by part
WANT_US = {"caller": 5 + 5 + 10, "update": 2 + 3, "keys": 5 + 8, "freqs": 10, "launch": 5}


def _readings(events, blocks=2):
    return harness.Readings(trace=trace.parse({"traceEvents": events}), window_us=(0, 100),
                            window_s=1e-4, counters={"blocks": blocks})


def test_idle_split_at_span_edges_innermost_first():
    t = trace.parse({"traceEvents": SPANS + OTHER})
    assert program_spans.caller_tid(t, 0) == 1
    split = program_spans.idle_split(t, 0, 100, 1)
    assert split == {program_spans.CALLER: 20, program_spans.UPDATE: 2,
                     program_spans.CHECK: 3, program_spans.KEYS: 13,
                     program_spans.FREQS: 10, program_spans.CONSERVATIVE: 5}
    assert sum(split.values()) == 100 - trace.busy_us(t, 0, 100)


def test_ops_launched_inside_the_spans():
    t = trace.parse({"traceEvents": SPANS + OTHER})
    ops = program_spans.ops_in_spans(t, program_spans.UPDATE, 0, 100)
    assert sorted(op.kind for op in ops) == ["kernel", "memcpy", "memset"]
    assert all(op.ts < 80 for op in ops)                  # not the copy launched at 80
    assert program_spans.ops_in_spans(t, program_spans.UPDATE, 11, 100) == []


def test_metrics_read_the_parts_per_block():
    r = _readings(SPANS + OTHER)
    got = {part: harness.metric_reader(name).read(r) for part, name in IDLE.items()}
    assert got == pytest.approx({part: us / 1e3 / 2 for part, us in WANT_US.items()})
    idle_ms = harness.metric_reader("idle_pct.ingest").read(r) / 100 * 0.1
    assert sum(got.values()) * 2 == pytest.approx(idle_ms)
    assert harness.metric_reader(OPS).read(r) == 3


def test_metrics_read_nothing_without_program_spans():
    r = _readings(OTHER)
    assert all(harness.metric_reader(name).read(r) is None for name in [*IDLE.values(), OPS])


def test_a_traced_run_records_every_span_the_readers_read():
    r = tiny.ingest(seconds=0.2)
    r.trace = True
    out = harness.system(r.config["system"]).run(r)
    assert out.checks.ok
    rd = out.readings
    t0, t1 = rd.window_us
    blocks = rd.counters["blocks"]
    assert blocks > 0
    assert len([s for s in rd.trace.spans(program_spans.UPDATE) if t0 <= s.ts < t1]) == blocks
    recorded = {op.name for op in rd.trace.host if op.name.startswith(program_spans.PREFIX)}
    assert recorded == set(program_spans.INGEST)
    assert all(program_spans.part_of(name) for name in recorded)
    parts = [harness.metric_reader(name).read(rd) for name in IDLE.values()]
    idle_ms = harness.metric_reader("idle_pct.ingest").read(rd) / 100 * (t1 - t0) / 1e3
    assert sum(parts) * blocks == pytest.approx(idle_ms, rel=1e-6)
    assert harness.metric_reader(OPS).read(rd) == 0        # the CPU launches nothing
