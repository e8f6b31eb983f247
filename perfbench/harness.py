"""What every run shares: the manifest and the files it names, the result
line, the checks that decide ``correct``, seeds, and the traced window.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric lives in a file of its own, found by its name:

    BENCHMARK.json                          the manifest (cells, metrics)
    perfbench/configs/<config>.json         a configuration (its ``system``)
    perfbench/systems/<system>.py           the system: set-up, window, reference
    perfbench/traffic/<traffic>.json        a traffic mix (its ``generator``)
    perfbench/generators/<generator>.py     the generator that reads it
    perfbench/cells/<cell>.json             a cell's limits and trace window
    perfbench/metrics/<metric>.py           a per-layer metric's reader; a metric
                                            named ``<reader>.<part>`` without a file
                                            of its own takes ``metrics/<reader>.py``
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "perfbench"
# top-level module names that may not be loaded in a run (compared whole:
# the port's package, ``repro_torch``, starts with ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class BenchError(RuntimeError):
    """A run that cannot produce a result (a missing file or card)."""


def load_json(path: Path) -> Any:
    if not path.is_file():
        raise BenchError(f"missing {path.relative_to(ROOT) if path.is_relative_to(ROOT) else path}")
    return json.loads(path.read_text())


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(man: dict, name: str) -> dict:
    for wl in man["workloads"]:
        if wl["name"] == name:
            return wl
    raise BenchError(f"no workload {name!r} in BENCHMARK.json")


def config_of(man: dict, wl: dict) -> dict:
    for cfg in man["configs"]:
        if cfg["name"] == wl["config"]:
            return load_json(ROOT / cfg["file"])
    raise BenchError(f"no config {wl['config']!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def cell(name: str) -> dict:
    return load_json(BENCH / "cells" / f"{name}.json")


def load_module(path: Path, name: str):
    """Import a file of the benchmark by path (metric files carry dots in
    their names)."""
    if not path.is_file():
        raise BenchError(f"missing {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def system(name: str):
    return load_module(BENCH / "systems" / f"{name}.py", f"perfbench_system_{name}")


def generator(name: str):
    return load_module(BENCH / "generators" / f"{name}.py", f"perfbench_generator_{name}")


def metric_reader(name: str):
    """The reader of a per-layer metric: ``metrics/<name>.py``, or, for a
    metric split by the end-to-end metric it moves (``idle_pct.ingest``),
    the shared ``metrics/<name before the first dot>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        path = BENCH / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path, "perfbench_metric_" + name.replace(".", "_"))


def end_to_end_metrics(man: dict, wl_name: str) -> List[dict]:
    return [m for m in man["end_to_end"] if wl_name in m.get("workloads", [wl_name])]


def per_layer_metrics(man: dict, wl_name: str) -> List[dict]:
    """The per-layer metrics a cell reports: those that list it, and those
    without a ``workloads`` key whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_metrics(man, wl_name)}
    return [m for m in man["per_layer"]
            if wl_name in m.get("workloads", [wl_name] if m["moves"] in e2e else [])]


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that a run may not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def seed_for(seed: int, *tags: int) -> int:
    """A 63-bit seed for a torch or numpy generator, derived from the
    run's ``--seed`` and the stream's tags; any whole number works."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *tags])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def host_snapshot() -> Dict[str, float]:
    """The host clock and this process's CPU seconds, for :func:`host_readings`."""
    import time

    return {"t": time.perf_counter(), "cpu_s": time.process_time()}


def host_readings(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    """This process's CPU seconds between two snapshots, as a share of
    one core in %: where the host's pace moves a rate, this and the
    probes (:func:`host_probe_ms`) say why."""
    return {"process_cpu_pct": 100.0 * (b["cpu_s"] - a["cpu_s"]) / max(b["t"] - a["t"], 1e-9)}


def host_probe_ms(reps: int = 9) -> Dict[str, float]:
    """The median milliseconds of two fixed host tasks like the ingest
    path's own cast of a block: 4 MiB of uint32 cast to int64 into a
    buffer already mapped (``copy``: the host's memory and core speed) and
    into a fresh array (``alloc``: the same, and the kernel's page faults
    on a new allocation)."""
    import time

    x = np.arange(1 << 20, dtype=np.uint32)
    out = np.empty(x.shape, np.int64)
    times: Dict[str, list] = {"copy": [], "alloc": []}
    for _ in range(reps):
        t = time.perf_counter()
        np.copyto(out, x)
        times["copy"].append(time.perf_counter() - t)
        t = time.perf_counter()
        x.astype(np.int64)
        times["alloc"].append(time.perf_counter() - t)
    return {k: float(np.median(v)) * 1e3 for k, v in times.items()}


class Checks:
    """The numbers compared with the plain reference, each with its limit:
    a run is correct when no number passes its limit."""

    def __init__(self, limits: Dict[str, float]):
        self.limits = limits
        self.values: Dict[str, float] = {}

    def add(self, name: str, value: float) -> None:
        if name not in self.limits:
            raise BenchError(f"check {name!r} has no limit in the cell's file")
        self.values[name] = float(value)

    @property
    def ok(self) -> bool:
        return (set(self.values) == set(self.limits)
                and all(v <= self.limits[k] for k, v in self.values.items()))

    def as_dict(self) -> Dict[str, dict]:
        return {k: {"value": v, "limit": self.limits[k]} for k, v in self.values.items()}

    def lines(self) -> List[str]:
        return [f"check {k} {v!r} limit {self.limits[k]!r}" for k, v in self.values.items()]


@dataclasses.dataclass
class Run:
    """One run of one cell, as ``run.py`` hands it to a system."""
    workload: str
    config: dict
    traffic: dict
    cell: dict
    seed: int
    seconds: float
    trace: bool
    t_process: float                 # host clock at the process's start
    device: str = "cuda"


@dataclasses.dataclass
class Readings:
    """What a traced run hands the per-layer metrics' readers."""
    trace: Any                       # perfbench.trace.Trace
    window_us: Tuple[float, float]   # the window on the trace's clock
    window_s: float                  # its length by the host clock
    counters: Dict[str, Any]


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: Checks
    peak_bytes: int
    readings: Optional[Readings] = None
    details: Optional[dict] = None   # what the checks were computed from (perfbench/calibrate.py)
    host: Optional[dict] = None      # the host's pace around the window (host_readings)


WINDOW_SPAN = "perfbench.window"


class TracedWindow:
    """``torch.profiler`` over a traced run's window: started before the
    window opens (its start-up counts as set-up), the benchmark's span
    ``perfbench.window`` around the window, exported to a chrome trace
    under ``TMPDIR`` and read back by :func:`finish`."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self._span = None
        self.host_s = 0.0

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()

    def open(self) -> None:
        if self.prof is not None:
            import torch

            self._span = torch.profiler.record_function(WINDOW_SPAN)
            self._span.__enter__()

    def close(self, host_s: float) -> None:
        """End the traced window (the caller has synchronised the card)."""
        if self.prof is not None and self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None
            self.prof.__exit__(None, None, None)
            self.host_s = host_s

    def finish(self):
        """(trace, window on the trace's clock) of the traced window."""
        import os
        import tempfile

        from perfbench import trace as tr

        fd, path = tempfile.mkstemp(prefix="perfbench-", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            t = tr.load(path)
        finally:
            os.unlink(path)
        spans = t.spans(WINDOW_SPAN)
        if not spans:
            raise BenchError("the traced window's span is missing from the trace")
        return t, (spans[0].ts, spans[0].end)
