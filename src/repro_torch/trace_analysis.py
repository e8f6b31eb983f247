"""A reader of ``torch.profiler`` traces, the port's counterpart of
``repro/hlo_analysis.py``.

The reference counts FLOPs, bytes and collectives in XLA's compiled HLO;
the port has no compiled module to read, and what it runs on the card is
what the profiler recorded.  This module reads one traced window, given
either a profiler's events (``prof.events()``, or the profile itself) or
an exported chrome trace (``prof.export_chrome_trace(path)``: the path,
or the JSON already loaded), and returns:

  * each CUDA kernel's device time and launch count, by name;
  * the device's busy seconds (the sum of its kernels', copies' and sets'
    durations, and the union of their intervals) and its idle share of the
    wall time;
  * the longest idle gaps between device work;
  * memcpy counts, milliseconds and bytes by kind (HtoD, DtoH, DtoD,
    PtoP; the bytes only from a chrome trace, whose events carry them);
  * collective kernels (``nccl*``), counted and summed, if any appear.

Host operators (``aten::*`` and the like) are read too, by name.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple, Union

MEMCPY_KINDS = ("HtoD", "DtoH", "DtoD", "PtoP")


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    kind: str                      # "kernel" | "memcpy" | "memset"
    start_us: float
    dur_us: float
    bytes: Optional[int] = None    # memcpy bytes, where the trace has them


@dataclasses.dataclass
class Trace:
    device: List[DeviceOp]
    host: List[Tuple[str, float, float]]   # (name, start_us, dur_us)

    @property
    def span_us(self) -> float:
        """First start to last end over every event, host and device."""
        ends = [(s, s + d) for _, s, d in self.host] + \
            [(op.start_us, op.start_us + op.dur_us) for op in self.device]
        return max(e for _, e in ends) - min(s for s, _ in ends) if ends else 0.0


def _kind(name: str, cat: str = "") -> str:
    if cat == "gpu_memcpy" or name.startswith("Memcpy"):
        return "memcpy"
    if cat == "gpu_memset" or name.startswith("Memset"):
        return "memset"
    return "kernel"


def memcpy_kind(name: str) -> Optional[str]:
    """HtoD, DtoH, DtoD or PtoP from a memcpy's name."""
    return next((k for k in MEMCPY_KINDS if k in name), None)


def _from_events(events) -> Trace:
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        start, dur = e.time_range.start, e.time_range.elapsed_us()
        if e.device_type == DeviceType.CUDA:
            device.append(DeviceOp(e.name, _kind(e.name), start, dur))
        else:
            host.append((e.name, start, dur))
    return Trace(device, host)


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _from_chrome(trace: dict) -> Trace:
    device, host = [], []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        start, dur = float(ev["ts"]), float(ev["dur"])
        if cat in _DEVICE_CATS:
            nbytes = ev.get("args", {}).get("bytes")
            device.append(DeviceOp(name, _kind(name, cat), start, dur,
                                   int(nbytes) if nbytes is not None else None))
        elif cat in ("cpu_op", "user_annotation", "python_function"):
            host.append((name, start, dur))
    return Trace(device, host)


def read(source: Union[str, Path, dict, Iterable]) -> Trace:
    """A :class:`Trace` from a profile, its ``events()``, a chrome-trace
    path or the loaded chrome-trace JSON."""
    if isinstance(source, (str, Path)):
        source = json.loads(Path(source).read_text())
    if isinstance(source, dict):
        return _from_chrome(source)
    if hasattr(source, "events") and callable(source.events):
        source = source.events()
    return _from_events(source)


def _union(ops: List[DeviceOp]) -> List[Tuple[float, float]]:
    """The device's busy intervals, in microseconds after its first op
    (timestamps are about 1e12 us: relative times keep their digits)."""
    t0 = min((op.start_us for op in ops), default=0.0)
    spans = sorted((op.start_us - t0, op.start_us - t0 + op.dur_us) for op in ops)
    out: List[Tuple[float, float]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _totals(spans: Iterable[Tuple[str, float]]) -> Dict[str, List[float]]:
    """{name: [ms, count]} of (name, microseconds) pairs, largest time
    first."""
    by: Dict[str, List[float]] = {}
    for name, us in spans:
        tot = by.setdefault(name, [0.0, 0])
        tot[0] += us / 1e3
        tot[1] += 1
    return dict(sorted(by.items(), key=lambda kv: -kv[1][0]))


def _named(ops: Iterable[DeviceOp]):
    return ((op.name, op.dur_us) for op in ops)


def summarize(trace: Trace, wall_s: Optional[float] = None, n_gaps: int = 5) -> dict:
    """The window's device figures.  ``wall_s`` is the window's wall time
    (the caller's host clock); without it, the trace's own span."""
    ops = trace.device
    wall = trace.span_us / 1e6 if wall_s is None else wall_s
    busy = sum(op.dur_us for op in ops) / 1e6
    union = _union(ops)
    busy_union = sum(e - s for s, e in union) / 1e6
    gaps = sorted(((union[i][1], union[i + 1][0] - union[i][1])
                   for i in range(len(union) - 1)), key=lambda g: -g[1])[:n_gaps]
    kernels = [op for op in ops if op.kind == "kernel"]
    copies = [op for op in ops if op.kind == "memcpy"]
    nccl = [op for op in kernels if op.name.lower().startswith("nccl")]
    memcpy = {}
    for k in MEMCPY_KINDS:
        mine = [op for op in copies if memcpy_kind(op.name) == k]
        if mine:
            known = [op.bytes for op in mine if op.bytes is not None]
            memcpy[k] = {"count": len(mine), "ms": sum(op.dur_us for op in mine) / 1e3,
                         "bytes": sum(known) if len(known) == len(mine) else None}
    return {
        "wall_s": wall,
        "device_busy_s": busy,
        "device_busy_union_s": busy_union,
        "idle_share": 1 - busy / wall if wall else None,
        "kernels": _totals(_named(kernels)),
        "by_name": _totals(_named(ops)),
        "launches": len(kernels),
        "longest_gaps": [{"after_ms": s / 1e3, "gap_ms": g / 1e3} for s, g in gaps],
        "memcpy": memcpy,
        "memsets": sum(1 for op in ops if op.kind == "memset"),
        "collectives": {"count": len(nccl), "ms": sum(op.dur_us for op in nccl) / 1e3,
                        "by_name": _totals(_named(nccl))},
    }


def host_totals(trace: Trace) -> Dict[str, List[float]]:
    """{host operator: [ms, calls]}, largest time first."""
    return _totals((name, d) for name, _, d in trace.host)
