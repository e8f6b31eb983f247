"""Idle milliseconds of the card per block while the host was innermost in
the program's span ``repro_torch.ingest.keys``: the keys' int64 cast on
the host, their copy to the card and the split into digits."""
from perfbench import program_spans


def read(r):
    return program_spans.idle_ms_per_block(r, "keys")
