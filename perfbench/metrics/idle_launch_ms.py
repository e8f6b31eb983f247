"""Idle milliseconds of the card per block while the host was innermost in
a kernel wrapper's span ``repro_torch.kernels.*``: its checks, the
frequencies' cast, the route and the launch."""
from perfbench import program_spans


def read(r):
    return program_spans.idle_ms_per_block(r, "launch")
