"""Share of the bandwidth bound that a decode step reaches, in %: the
bytes the traced window's decode steps must move (``counts_serve.
decode_bytes``: the weights outside the experts, the experts their tokens
route to, the key/value cache up to each step's position) over the HBM
bandwidth, over the device time of the ops launched inside the
benchmark's span ``perfbench.decode``."""
from perfbench import peaks, serve_spans


def read(r):
    got = serve_spans.ops_per_span(r, "decode_span")
    moved = r.counters.get("decode_bytes")
    if got is None or not moved:
        return None
    device_s = sum(op.dur for op in got[1]) / 1e6
    return 100.0 * (moved / peaks.HBM_BYTES_PER_S) / device_s
