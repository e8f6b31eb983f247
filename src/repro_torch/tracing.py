"""Spans that the program records while a ``torch.profiler`` records.

:func:`span` returns ``torch.profiler.record_function(name)`` while a
profiler records, and one shared no-op context otherwise.  The test is the
profiler's own flag, read at each call, so nothing here is switched on or
off: the spans record exactly when someone profiles.  Without the flag a
``record_function`` costs about as much as a whole span's work (it enters
and leaves a dispatcher op even with no profiler), which a host-paced
ingest of 2 ms blocks would pay on every block.

A span lands in the profiler's chrome trace as a ``user_annotation`` event
on the calling thread, on the same clock as the card's kernels and copies
(CUPTI), which ``torch.profiler`` matches to the host calls that launched
them by correlation id.  Spans on one thread nest by time: a span's parent
is the span that encloses it.

The spans the program records, each once a call:

``repro_torch.ingest.update``
    ``kernels/ops.py`` ``KernelSketch.update``, every mode: the whole call.
``repro_torch.ingest.check``
    inside it, the host's scans of the frequencies (``_check_freqs``).
``repro_torch.ingest.keys``
    inside it, the keys: the cast to int64 on the host, the copy to the
    table's device and the split into digits (``_chunks``).
``repro_torch.ingest.freqs``
    inside it, the frequencies: their copy to the table's device and the
    cast to the table's dtype.
``repro_torch.kernels.sketch_update_conservative``
    ``kernels/sketch_update_conservative.py`` ``sketch_update_conservative``,
    inside ``update`` in conservative mode, once a block: the wrapper's
    checks, the frequencies' cast, the route and the launch of K5 (on CPU
    tensors, the plain fold).

A kernel's span is named ``repro_torch.kernels.`` and the key under which
``kernels/_cuda.LAUNCHES``, the program's one counter, counts its
launches.
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` while a profiler records; else a
    shared no-op."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
