"""Readers of the spans the program records inside itself.

While a profiler records, the port records spans (``record_function``)
around the steps of its ingest path; they land in the traced window's
chrome trace on the caller's thread, on the clock of the card's kernels
and copies.  Their names are copied here, not imported, so that a change
to the program cannot move the yardstick; ``tests/test_perfbench_spans.py``
holds the copies against a traced run of the program.

:func:`idle_split` cuts each idle interval of the card at the spans' edges
and gives each piece to the innermost program span open on the caller's
thread at that time, or to the caller where none is open: the parts add up
to the window's idle time.  Operators and runtime calls (``aten::*``,
``cuda*``) are not the program's steps and are passed over.
:func:`ops_in_spans` counts the kernels, copies and sets launched inside
the spans of one name.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional

from perfbench import harness
from perfbench import trace as tr

PREFIX = "repro_torch."
UPDATE = "repro_torch.ingest.update"      # KernelSketch.update, the whole call
CHECK = "repro_torch.ingest.check"        # the host's scans of the frequencies
KEYS = "repro_torch.ingest.keys"          # int64 cast, copy, digit split
FREQS = "repro_torch.ingest.freqs"        # copy and cast of the frequencies
KERNELS = "repro_torch.kernels."          # a wrapper, named by its launch counter's key
CONSERVATIVE = KERNELS + "sketch_update_conservative"
# every span a conservative ingest records, once a block
INGEST = (UPDATE, CHECK, KEYS, FREQS, CONSERVATIVE)
CALLER = "caller"                         # no program span open

PARTS = ("keys", "freqs", "launch", "update", "caller")


def part_of(name: str) -> Optional[str]:
    """Which of :data:`PARTS` an innermost span (or :data:`CALLER`) is."""
    if name == KEYS:
        return "keys"
    if name == FREQS:
        return "freqs"
    if name.startswith(KERNELS):
        return "launch"
    if name in (UPDATE, CHECK):
        return "update"
    if name == CALLER:
        return "caller"
    return None


def caller_tid(trace: tr.Trace, t0: float):
    """The thread that opened the window (the benchmark's span at ``t0``)."""
    for op in trace.spans(harness.WINDOW_SPAN):
        if op.ts == t0:
            return op.tid
    return None


def idle_split(trace: tr.Trace, t0: float, t1: float, tid) -> Optional[Dict[str, float]]:
    """{innermost span's name or :data:`CALLER`: idle microseconds} over
    the card's idle intervals in [t0, t1], split at the edges of the
    program's spans on thread ``tid``; None where no program span lies
    in the window."""
    spans = [op for op in trace.host if op.tid == tid and op.name.startswith(PREFIX)
             and op.end > t0 and op.ts < t1]
    if not spans:
        return None
    edges = [(t0, t0)] + tr.union(trace.device, t0, t1) + [(t1, t1)]
    gaps = [(edges[i][1], edges[i + 1][0]) for i in range(len(edges) - 1)
            if edges[i + 1][0] > edges[i][1]]
    # (time, order, span): at one time a span opens before any closes (a
    # span of no length is left closed) and a gap ends before the next one
    # starts (an op of no length between them leaves the card idle)
    events = [(max(op.ts, t0), 0, op) for op in spans]
    events += [(min(op.end, t1), 1, op) for op in spans]
    events += [(e, 2, None) for _, e in gaps] + [(s, 3, None) for s, _ in gaps]
    events.sort(key=lambda e: (e[0], e[1]))
    out: Dict[str, float] = {}
    open_: List[tr.Op] = []
    idle, prev = False, t0
    for t, kind, op in events:
        if idle and t > prev:
            inner = max(open_, key=lambda o: (o.ts, -o.end)).name if open_ else CALLER
            out[inner] = out.get(inner, 0.0) + (t - prev)
        prev = t
        if kind == 0:
            open_.append(op)
        elif kind == 1:
            open_.remove(op)
        else:
            idle = kind == 3
    return out


def idle_ms_per_block(r, part: str) -> Optional[float]:
    """Idle milliseconds of the card per block of the traced window whose
    innermost program span falls in ``part`` (:data:`PARTS`)."""
    t0, t1 = r.window_us
    blocks = r.counters.get("blocks")
    split = idle_split(r.trace, t0, t1, caller_tid(r.trace, t0))
    if not blocks or split is None:
        return None
    return sum(us for name, us in split.items() if part_of(name) == part) / 1e3 / blocks


def ops_in_spans(trace: tr.Trace, name: str, t0: float, t1: float) -> List[tr.Op]:
    """Every kernel, copy and set launched inside a host span named
    ``name`` that starts in [t0, t1): the launches on the span's thread
    that fall inside it, matched to the device's ops by correlation id."""
    spans = [op for op in trace.spans(name) if t0 <= op.ts < t1]
    starts = [s.ts for s in spans]
    corr = set()
    for op in trace.launches:
        i = bisect.bisect_right(starts, op.ts) - 1
        if i >= 0 and op.ts <= spans[i].end and op.tid == spans[i].tid and op.corr is not None:
            corr.add(op.corr)
    return [op for op in trace.device if op.corr in corr]
