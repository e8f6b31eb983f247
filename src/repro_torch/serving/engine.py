"""Compatibility shim: the serving engine split into model + sketch halves
(port of ``repro/serving/engine.py``).

``engine`` used to hold both the LLM serving engine and the streaming
sketch endpoint in one module.  They now live in

  * serving/model_engine.py -- ServeConfig, ServeEngine, Request,
    SlotScheduler (token generation, KV-cache decode slots);
  * serving/sketch_engine.py -- SketchTopKEndpoint plus the async
    SketchServeEngine (pipelined ingest, snapshot queries, batched
    descent);

behind the shared submit/flush protocol of serving/protocol.py.  This
module re-exports every pre-split name so existing imports keep working;
new code should import from the split modules directly.
"""
from __future__ import annotations

from repro_torch.serving.model_engine import (
    PyTree,
    Request,
    ServeConfig,
    ServeEngine,
    SlotScheduler,
)
from repro_torch.serving.sketch_engine import SketchTopKEndpoint

__all__ = [
    "PyTree",
    "Request",
    "ServeConfig",
    "ServeEngine",
    "SlotScheduler",
    "SketchTopKEndpoint",
]
