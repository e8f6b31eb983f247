"""Bytes of the work the benchmark measures, counted from shapes by the
benchmark's own formulas (none is read from the program).

Roofline bytes follow the on-chip guide's rule: each input byte read once
and each output byte written once, whatever a kernel reads again.
"""
from __future__ import annotations


def conservative_fold_bytes(rows: int, key_bytes: int, freq_bytes: int,
                            touched_cells: int, cell_bytes: int) -> int:
    """Bytes a conservative fold of one block needs: every key and
    frequency read once, every distinct (row, cell) it touches read once
    and written once."""
    return rows * (key_bytes + freq_bytes) + 2 * touched_cells * cell_bytes
