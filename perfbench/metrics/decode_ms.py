"""Device milliseconds a decode step: the kernels, copies and sets
launched inside the benchmark's span ``perfbench.decode`` around each
``transformer.decode_step`` of the traced window, over those steps."""
from perfbench import serve_spans


def read(r):
    return serve_spans.device_ms_per_span(r, "decode_span")
