"""Fault tolerance: supervised restarts, straggler detection, elastic
remesh.  PyTorch port of ``repro/training/fault_tolerance.py``.

  * :class:`Supervisor` -- wraps the step loop; any exception (device loss,
    preemption, an injected test failure) triggers restore-from-latest-
    checkpoint and replay, up to ``max_restarts``.  Data order is keyed by
    the step number, so replayed steps consume identical batches.
  * :class:`StragglerMonitor` -- EWMA of per-host step times; flags hosts
    slower than ``threshold`` x the fleet median.
  * :func:`elastic_remesh` -- re-places live state onto a rebuilt
    :class:`~repro_torch.launch.mesh.Mesh` (survivor-only continuation
    instead of a full restart).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.training import checkpoint as ckpt

PyTree = Any


@dataclasses.dataclass
class StragglerReport:
    step: int
    host_times: Dict[int, float]
    median: float
    stragglers: List[int]


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, ewma: float = 0.7):
        self.threshold = threshold
        self.ewma = ewma
        self._smoothed: Dict[int, float] = {}
        self.reports: List[StragglerReport] = []

    def record(self, step: int, host_times: Dict[int, float]) -> StragglerReport:
        for h, t in host_times.items():
            prev = self._smoothed.get(h, t)
            self._smoothed[h] = self.ewma * prev + (1 - self.ewma) * t
        med = float(np.median(list(self._smoothed.values())))
        stragglers = [h for h, t in self._smoothed.items() if t > self.threshold * med]
        rep = StragglerReport(step=step, host_times=dict(host_times), median=med,
                              stragglers=stragglers)
        self.reports.append(rep)
        return rep


class Supervisor:
    """Run a step function with checkpoint/restart fault tolerance."""

    def __init__(self, ckpt_dir: str, save_every: int = 50, max_restarts: int = 3,
                 keep_last: int = 3, async_save: bool = True,
                 restart_backoff: float = 0.0):
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.writer = ckpt.AsyncCheckpointer(ckpt_dir, keep_last) if async_save else None
        self.keep_last = keep_last
        # exponential backoff between restarts: a crash-looping fleet must
        # not hammer the checkpoint store at full speed
        self.restart_backoff = float(restart_backoff)
        self.restarts = 0
        self.monitor = StragglerMonitor()

    def run(self, state: Dict[str, PyTree],
            step_fn: Callable[[int, Dict[str, PyTree]], Dict[str, PyTree]],
            start_step: int, num_steps: int,
            on_metrics: Optional[Callable[[int, Dict[str, Any]], None]] = None,
            ) -> Tuple[int, Dict[str, PyTree]]:
        """Advance ``num_steps`` steps with restart-on-failure."""
        step = start_step
        end = start_step + num_steps
        while step < end:
            try:
                t0 = time.perf_counter()
                state = step_fn(step, state)
                dt = time.perf_counter() - t0
                self.monitor.record(step, {ckpt._process_index(): dt})
                step += 1
                if step % self.save_every == 0:
                    self._save(step, state)
                if on_metrics:
                    on_metrics(step, {"step_time_s": dt})
            except KeyboardInterrupt:
                raise
            except Exception as e:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise RuntimeError(f"exceeded max_restarts={self.max_restarts}") from e
                if self.restart_backoff > 0:
                    time.sleep(self.restart_backoff * 2 ** (self.restarts - 1))
                step, state = self._restore(state)
        self._save(step, state)
        if self.writer:
            self.writer.wait()
        return step, state

    def _save(self, step: int, state: Dict[str, PyTree]) -> None:
        if self.writer:
            self.writer.submit(step, state)
        else:
            ckpt.save(self.ckpt_dir, step, state, self.keep_last)

    def _restore(self, templates: Dict[str, PyTree]) -> Tuple[int, Dict[str, PyTree]]:
        if self.writer:
            self.writer.wait()
        if ckpt.latest_step(self.ckpt_dir) is None:
            return 0, templates  # no checkpoint yet: restart from scratch
        return ckpt.restore(self.ckpt_dir, templates)


def elastic_remesh(state: PyTree, new_mesh) -> PyTree:
    """Re-place live state onto a rebuilt mesh (after losing or adding
    hosts): every tensor leaf is COPIED, never aliased, onto the new mesh's
    first device, where the port keeps replicated state.  Dicts, lists,
    tuples and NamedTuples are walked; ``None`` stays."""
    return _map_tensors(lambda t: t.to(new_mesh.first_device, copy=True), state)


def _map_tensors(fn, node):
    if isinstance(node, torch.Tensor):
        return fn(node)
    if isinstance(node, dict):
        return {k: _map_tensors(fn, v) for k, v in node.items()}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_map_tensors(fn, v) for v in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_map_tensors(fn, v) for v in node)
    return node
