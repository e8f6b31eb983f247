"""The shared engine protocol both serving stacks sit behind (port of
``repro/serving/protocol.py``, verbatim).

The model engine (serving/model_engine.SlotScheduler) and the sketch
engine (serving/sketch_engine.SketchServeEngine) serve different requests
-- token generations vs threshold/top-k sketch queries -- but expose the
same request lifecycle, so launchers and benchmarks can drive either
through one shape:

  ``submit(request)``  enqueue one request; cheap, never blocks on device
                       work;
  ``flush()``          run every pending request to completion (batched
                       however the engine sees fit) and return the
                       completed requests/results, FIFO.

The protocol is deliberately minimal: batching policy (decode slots vs
packed descent grids), state (KV caches vs table snapshots), and staleness
semantics are engine concerns, not protocol concerns.
"""
from __future__ import annotations

from typing import Any, Protocol, Sequence, runtime_checkable


@runtime_checkable
class ServeEngineProtocol(Protocol):
    """Submit/flush request lifecycle shared by the serving engines."""

    def submit(self, request: Any) -> Any:
        """Enqueue one request for the next :meth:`flush`."""
        ...

    def flush(self) -> Sequence[Any]:
        """Run all pending requests to completion; return them in FIFO
        submission order."""
        ...
