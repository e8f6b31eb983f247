"""Reader of the chrome trace that ``torch.profiler`` exports.

A copy of what the port's ``trace_analysis.py`` does (device ops, the
union of their intervals, the idle gaps), kept here so that a change to
the program cannot move the yardstick, plus what the benchmark needs
beyond it: the host spans the benchmark records (``record_function``) and
the kernels launched inside them, matched by the profiler's correlation
ids between a launch on the host and its kernel on the device.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    kind: str          # kernel | memcpy | memset | launch | host
    ts: float          # microseconds, the trace's clock
    dur: float
    tid: object = None
    corr: Optional[int] = None

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclasses.dataclass
class Trace:
    device: List[Op]
    launches: List[Op]
    host: List[Op]

    def spans(self, name: str) -> List[Op]:
        """The host spans (``record_function``) of one name, in time order."""
        return sorted((op for op in self.host if op.name == name), key=lambda o: o.ts)


def _corr(args: dict) -> Optional[int]:
    c = args.get("correlation")
    return int(c) if c is not None else None


def parse(trace: dict) -> Trace:
    device, launches, host = [], [], []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, name, args = ev.get("cat", ""), ev.get("name", ""), ev.get("args", {}) or {}
        ts, dur, tid = float(ev["ts"]), float(ev["dur"]), ev.get("tid")
        if cat in DEVICE_CATS:
            device.append(Op(name, DEVICE_CATS[cat], ts, dur, tid, _corr(args)))
        elif cat in LAUNCH_CATS:
            launches.append(Op(name, "launch", ts, dur, tid, _corr(args)))
        elif cat in HOST_CATS:
            host.append(Op(name, "host", ts, dur, tid))
    device.sort(key=lambda o: o.ts)
    return Trace(device, launches, host)


def load(path) -> Trace:
    return parse(json.loads(Path(path).read_text()))


def clip(ops: Iterable[Op], t0: float, t1: float) -> List[Op]:
    """The ops that start inside [t0, t1)."""
    return [op for op in ops if t0 <= op.ts < t1]


def union(ops: Iterable[Op], t0: float, t1: float) -> List[Tuple[float, float]]:
    """Busy intervals of ``ops`` inside [t0, t1], merged."""
    spans = sorted((max(op.ts, t0), min(op.end, t1)) for op in ops
                   if op.end > t0 and op.ts < t1)
    out: List[Tuple[float, float]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_us(trace: Trace, t0: float, t1: float) -> float:
    """Microseconds of [t0, t1] in which a kernel, copy or set ran."""
    return sum(e - s for s, e in union(trace.device, t0, t1))


def kernels_in_spans(trace: Trace, name: str) -> List[Op]:
    """Every device kernel launched inside a host span named ``name``: the
    launches on the span's thread that fall inside it, matched to their
    kernels by correlation id."""
    spans = trace.spans(name)
    if not spans:
        return []
    starts = [s.ts for s in spans]
    corr = set()
    for op in trace.launches:
        i = bisect.bisect_right(starts, op.ts) - 1
        if i >= 0 and op.ts <= spans[i].end and op.tid == spans[i].tid and op.corr is not None:
            corr.add(op.corr)
    return [op for op in trace.device if op.kind == "kernel" and op.corr in corr]


def top_device_ops(trace: Trace, t0: float, t1: float, n: int = 10) -> List[list]:
    """[[name, seconds], ...]: the device ops that took most time in
    [t0, t1), by name, largest first."""
    tot: Dict[str, float] = {}
    for op in clip(trace.device, t0, t1):
        tot[op.name] = tot.get(op.name, 0.0) + op.dur / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(trace: Trace, t0: float, t1: float, n: int = 10) -> List[list]:
    """[[what the host was doing, seconds], ...]: the longest idle gaps of
    the device in [t0, t1], each named by the innermost host op (a span,
    an operator or a launch) running at the gap's midpoint."""
    busy = union(trace.device, t0, t1)
    edges = [(t0, t0)] + busy + [(t1, t1)]
    gaps = sorted(((edges[i][1], edges[i + 1][0]) for i in range(len(edges) - 1)
                   if edges[i + 1][0] > edges[i][1]), key=lambda g: g[0] - g[1])[:n]
    host = trace.host + trace.launches
    out = []
    for s, e in gaps:
        mid = (s + e) / 2
        inner = [op for op in host if op.ts <= mid <= op.end]
        label = min(inner, key=lambda o: o.dur).name if inner else "(no host op)"
        out.append([label, (e - s) / 1e6])
    return out
