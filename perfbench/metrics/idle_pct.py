"""Share of the traced window in which nothing ran on the card: no
kernel, copy or set (the union of their intervals), in %."""
from perfbench import trace


def read(r):
    t0, t1 = r.window_us
    if t1 <= t0:
        return None
    return 100.0 * (1.0 - trace.busy_us(r.trace, t0, t1) / (t1 - t0))
