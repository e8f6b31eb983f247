"""Kernels, copies and sets launched inside the benchmark's span
``perfbench.decode`` a decode step of the traced window: the device
operations one ``transformer.decode_step`` costs."""
from perfbench import serve_spans


def read(r):
    got = serve_spans.ops_per_span(r, "decode_span")
    if got is None:
        return None
    n, ops = got
    return len(ops) / n
