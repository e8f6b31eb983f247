"""Distributed sketch runtime, PyTorch port -- this slice carries only the
block padding the single-shard endpoint uses.

The reference's shard_map/psum runtime (``repro/core/distributed.py``)
arrives on ``torch.distributed`` with the sharding slice (ROADMAP item 12).
"""
from __future__ import annotations

import numpy as np


def pad_block_pow2(items: np.ndarray, freqs: np.ndarray, n_shards: int):
    """Pad a stream block so each of ``n_shards`` contiguous slices has the
    same power-of-two length.

    Zero-frequency pad rows are no-ops under the linear update and are
    skipped by the candidate pools, so padding never changes any table.
    Kept from the reference (where it bounds the number of compiled
    variants) so the port's plain endpoint folds exactly the blocks the
    reference folds.

    Returns (items, freqs, rows_per_shard).
    """
    n = items.shape[0]
    per = -(-n // n_shards)
    per = 1 << max(per - 1, 0).bit_length()
    m = per * n_shards
    if m != n:
        items = np.pad(items, ((0, m - n), (0, 0)))
        freqs = np.pad(freqs, (0, m - n))
    return items, freqs, per
