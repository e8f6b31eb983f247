"""Idle milliseconds of the card per block with no program span open on
the caller's thread: the caller's loop and the gaps between its calls.
With ``idle_keys_ms``, ``idle_freqs_ms``, ``idle_launch_ms`` and
``idle_update_ms`` it partitions the window's idle time."""
from perfbench import program_spans


def read(r):
    return program_spans.idle_ms_per_block(r, "caller")
