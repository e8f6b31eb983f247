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
    inside it, the keys.  Host arrays bound for the card: the wait for a
    free slot of the sketch's staging ring (``repro_torch/staging.py``),
    the copy into its page-locked buffer, the non-blocking copy of the
    32-bit words to the card, their widening to int64 there and the split
    into digits.  Otherwise: ``device.as_index_tensor`` and the split into
    digits.
``repro_torch.ingest.freqs``
    inside it, the frequencies: the copy into the slot's page-locked
    buffer and the non-blocking copy to the card (otherwise
    ``core/sketch.as_freqs``), then the cast to the table's dtype.
``repro_torch.kernels.sketch_update_conservative``
    ``kernels/sketch_update_conservative.py`` ``sketch_update_conservative``,
    inside ``update`` in conservative mode, once a block: the wrapper's
    checks, the frequencies' cast, the route and the launch of K5 (on CPU
    tensors, the plain fold).

A kernel's span is named ``repro_torch.kernels.`` and the key under which
``kernels/_cuda.LAUNCHES`` counts its launches.

The program's counters, plain integers read at any time:

``kernels/_cuda.LAUNCHES``
    launches by kernel, process-wide.
``KernelSketch.staging.staged_blocks``
    per sketch: the ``update`` calls whose host block crossed to the card
    through the staging ring.
``KernelSketch.staging.staging_waits``
    per sketch: of those, the calls that found their slot's copy still
    pending and waited for the card, inside ``.keys``.  Near one a block,
    the host runs ahead of the card; near zero, the card waits for the
    host.
``KernelSketch.fold_scratch.stats``
    per conservative sketch whose table K5's claim rounds may fold: an
    int64 tensor on the card that K5 adds to, [blocks folded in claim
    rounds, their rounds, items folded in rounds, items handed to the
    one-CTA tail] (``kernels/sketch_update_conservative.RoundScratch``).
    Reading it waits for the card, so only tools and tests read it
    (``.counts()``), never ``update``.
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
