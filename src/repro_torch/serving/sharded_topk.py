"""Sharded heavy-hitter serving, PyTorch port -- this slice carries only the
top-k threshold descent the single-shard endpoint shares.

``ShardedTopKService`` arrives on ``torch.distributed`` with the sharding
slice (ROADMAP item 12).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np


def threshold_descent_topk(
    heavy_hitters_fn: Callable[..., Tuple[np.ndarray, np.ndarray]],
    candidates: Sequence[np.ndarray],
    k: int,
    *,
    total: int,
    n_modules: int,
    min_threshold: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k by estimate: geometric threshold descent until k keys found.

    ``min_threshold`` floors the descent; the default scales with the
    stream (total / 2^17) because at threshold ~1 every candidate survives
    every level and the leaf evaluates the full candidate cross-product.
    Pass ``min_threshold=1`` explicitly to force exhaustive descent on
    small candidate pools.
    """
    if min_threshold is None:
        min_threshold = max(1, total >> 17)
    thr = max(total, 1)
    items = np.zeros((0, n_modules), np.uint32)
    est = np.zeros((0,), np.int64)
    while thr >= min_threshold:
        items, est = heavy_hitters_fn(thr, candidates=candidates)
        if len(est) >= k or thr == min_threshold:
            break
        thr = max(min_threshold, thr // 4)
    return items[:k], est[:k]
