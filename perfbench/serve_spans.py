"""What the serving cells' readers take from a traced window: the device
operations (kernels, copies, sets) launched inside the benchmark's spans
around ``transformer.prefill`` and ``decode_step`` (names in the traced
run's counters), matched by correlation id."""
from __future__ import annotations

from typing import List, Optional, Tuple

from perfbench import program_spans
from perfbench import trace as tr


def ops_per_span(r, key: str) -> Optional[Tuple[int, List[tr.Op]]]:
    """(spans named by ``r.counters[key]`` that start in the window, the
    device ops launched inside them), or None where there are none."""
    name = r.counters.get(key)
    if name is None:
        return None
    t0, t1 = r.window_us
    spans = [op for op in r.trace.spans(name) if t0 <= op.ts < t1]
    ops = program_spans.ops_in_spans(r.trace, name, t0, t1)
    if not spans or not ops:
        return None
    return len(spans), ops


def device_ms_per_span(r, key: str) -> Optional[float]:
    """Device milliseconds of the ops launched inside a span, per span."""
    got = ops_per_span(r, key)
    if got is None:
        return None
    n, ops = got
    return sum(op.dur for op in ops) / 1e3 / n
