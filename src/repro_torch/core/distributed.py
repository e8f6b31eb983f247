"""Distributed sketch runtime, PyTorch port -- this slice carries only the
block padding the single-shard endpoint uses and the linear-mode guard of
every sharded and merge entry point.

The reference's shard_map/psum runtime (``repro/core/distributed.py``)
arrives on ``torch.distributed`` with the sharding slice (ROADMAP item 12).
"""
from __future__ import annotations

import numpy as np


def require_linear(mode: str, entry: str) -> None:
    """Refuse conservative tables on any sharded/merge entry point, with the
    reference's message: a psum (or cell-wise sum) of conservatively built
    tables is not the table of the union stream.  Linear and signed tables
    are linear in the stream and pass."""
    if mode not in ("linear", "signed"):
        raise ValueError(
            f"{entry} is only defined for linear tables (got mode="
            f"{mode!r}): conservative tables are not linear in the stream, "
            "so per-shard folds cannot be psum-merged -- conservative mode "
            "is single-shard by construction")


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
