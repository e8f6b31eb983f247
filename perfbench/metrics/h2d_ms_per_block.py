"""Device milliseconds of host-to-device copies per block folded in the
traced window (the keys and counts the ingest path moves to the card)."""
from perfbench import trace


def read(r):
    t0, t1 = r.window_us
    blocks = r.counters.get("blocks")
    copies = [op for op in trace.clip(r.trace.device, t0, t1)
              if op.kind == "memcpy" and "HtoD" in op.name]
    if not blocks or not copies:
        return None
    return sum(op.dur for op in copies) / 1e3 / blocks
