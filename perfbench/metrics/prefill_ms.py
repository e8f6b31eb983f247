"""Device milliseconds a cohort's prefill: the kernels, copies and sets
launched inside the benchmark's span ``perfbench.prefill`` around
``transformer.prefill`` in the traced window, per prefill."""
from perfbench import serve_spans


def read(r):
    return serve_spans.device_ms_per_span(r, "prefill_span")
