"""Idle milliseconds of the card per block while the host was innermost in
the program's span ``repro_torch.ingest.update`` itself (between its
steps) or in ``repro_torch.ingest.check`` (the host's scans of the
frequencies)."""
from perfbench import program_spans


def read(r):
    return program_spans.idle_ms_per_block(r, "update")
