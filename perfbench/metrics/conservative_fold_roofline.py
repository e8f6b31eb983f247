"""Share of its roofline that the conservative fold reaches, in %: the
least time the card could take, the fold's bytes (each key and count
read once, each touched cell read and written once) over the HBM
bandwidth, over the device time of every kernel launched inside the
benchmark's span around each ``update`` call (hashing, chunking and the
fold, whatever kernels implement them).  Bytes alone bound it: no
integer peak is published (perfbench/peaks.py)."""
from perfbench import peaks, trace


def read(r):
    kernels = trace.kernels_in_spans(r.trace, r.counters["update_span"])
    device_us = sum(op.dur for op in kernels)
    if not device_us:
        return None
    return 100.0 * (r.counters["fold_bytes"] / peaks.HBM_BYTES_PER_S) / (device_us / 1e6)
