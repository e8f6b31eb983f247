"""Kernels, copies and sets launched inside the program's spans
``repro_torch.ingest.update`` in the traced window, over the number of
those spans: the device operations one ``KernelSketch.update`` costs."""
from perfbench import program_spans


def read(r):
    t0, t1 = r.window_us
    calls = [op for op in r.trace.spans(program_spans.UPDATE) if t0 <= op.ts < t1]
    if not calls:
        return None
    return len(program_spans.ops_in_spans(r.trace, program_spans.UPDATE, t0, t1)) / len(calls)
