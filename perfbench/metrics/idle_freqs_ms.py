"""Idle milliseconds of the card per block while the host was innermost in
the program's span ``repro_torch.ingest.freqs``: the frequencies' copy to
the card and their cast to the table's dtype."""
from perfbench import program_spans


def read(r):
    return program_spans.idle_ms_per_block(r, "freqs")
