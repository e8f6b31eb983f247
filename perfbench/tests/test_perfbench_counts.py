"""Byte counts on hand-worked shapes."""
from perfbench import counts


def test_fold_bytes_by_hand():
    # 2 rows of 8-byte keys and 8-byte counts, 5 cells read and written at 4 bytes
    assert counts.conservative_fold_bytes(2, 8, 8, 5, 4) == 32 + 40
    # no cell touched: the keys and counts alone
    assert counts.conservative_fold_bytes(3, 8, 8, 0, 4) == 48
