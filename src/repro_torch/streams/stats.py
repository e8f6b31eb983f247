"""Exact stream statistics: ground truth + evaluation metrics.

``observed_error`` is the paper's SVI-A4 aggregate metric;
``average_relative_error`` / ``exact_f2`` / ``sketch_f2_upper`` are the
live-accuracy metrics the batched streaming harness (streams/dstream.py)
reports per batch against exact windowed ground truth.

Port of ``repro/streams/stats.py`` (numpy; the point estimates of
:func:`hierarchy_point_estimates` come from the port's own
``core.sketch.query``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def observed_error(est: np.ndarray, true: np.ndarray) -> float:
    """SVI-A4: sum_i |est_i - true_i| / sum_i true_i over queried items."""
    est = np.asarray(est, dtype=np.float64)
    true = np.asarray(true, dtype=np.float64)
    return float(np.abs(est - true).sum() / max(float(true.sum()), 1.0))


def average_relative_error(est: np.ndarray, true: np.ndarray) -> float:
    """Mean per-item relative error: mean_i |est_i - true_i| / true_i.

    The DStream-style live metric (per-key, unlike the mass-weighted
    ``observed_error``): heavy and light queried keys count equally, so a
    sketch that nails the head but garbles the queried tail is penalized.
    Zero-truth rows contribute |est| per unit (denominator floored at 1)
    instead of dividing by zero.  Empty query sets score 0.
    """
    est = np.asarray(est, dtype=np.float64)
    true = np.asarray(true, dtype=np.float64)
    if est.shape != true.shape:
        raise ValueError(f"est/true shape mismatch: {est.shape} vs {true.shape}")
    if est.size == 0:
        return 0.0
    return float(np.mean(np.abs(est - true) / np.maximum(true, 1.0)))


def exact_f2(freqs: np.ndarray) -> float:
    """Second frequency moment of a compressed stream: sum_i f_i**2."""
    f = np.asarray(freqs, dtype=np.float64)
    return float(np.dot(f, f))


def sketch_f2_upper(table: np.ndarray) -> float:
    """F2 upper bound from a linear Count-Min table: min over rows of the
    row's sum of squared cells.

    Each cell holds the sum of its colliding keys' frequencies, so a row's
    sum of squares is F2 plus non-negative cross terms -- an overestimate
    for every row; the min is the tightest.  (Unbiased F2 needs sign
    hashes -- Count-Sketch / AMS -- which this table family does not carry;
    the bound still tracks F2 well at the usual loads and is what the
    streaming harness reports.)  Only meaningful for linearly built
    tables: conservative cells under-count collisions, voiding the
    row-wise >= F2 argument.
    """
    t = np.asarray(table, dtype=np.float64)
    if t.ndim != 2:
        raise ValueError(f"table must be [w, h], got shape {t.shape}")
    return float(np.min(np.sum(t * t, axis=1)))


def hierarchy_point_estimates(hspec, state, query_items: np.ndarray) -> np.ndarray:
    """CM point estimates for schema-ordered keys from a hierarchy's finest level.

    The shared scoring primitive of the DStream harness
    (streams/dstream.py) and the autotune launcher
    (launch/serve.run_sketch_autotune): map the schema-ordered query rows
    to the finest level's module order (``hspec.level_items`` -- identity
    only when the partition happens to be in schema order) and point-query
    that level's table.  Returns float64 estimates, one per query row.
    """
    from repro_torch.core import sketch as sk

    fine = hspec.levels[-1]
    level_items = hspec.level_items(
        hspec.n_levels - 1, np.asarray(query_items, dtype=np.uint32))
    est = sk.query(fine, state.states[-1], np.ascontiguousarray(level_items))
    return est.cpu().numpy().astype(np.float64)


def topk_point_are(hspec, state, query_items: np.ndarray,
                   true_freqs: np.ndarray) -> float:
    """ARE of a hierarchy's point estimates over a fixed query set.

    ``average_relative_error(estimates, truth)`` with the estimates drawn
    by :func:`hierarchy_point_estimates` -- the twin-endpoint scoring the
    autotune launcher prints (auto-tuned vs frozen-spec endpoint on the
    same window) and the per-batch top-k ARE of the streaming harness.
    """
    est = hierarchy_point_estimates(hspec, state, query_items)
    return average_relative_error(est, np.asarray(true_freqs,
                                                  dtype=np.float64))


def exact_marginals(items: np.ndarray, freqs: np.ndarray, cols: Sequence[int]) -> np.ndarray:
    """O(value(cols), *) at every item row, from the full stream."""
    sub = np.ascontiguousarray(items[:, list(cols)])
    _, inv = np.unique(sub, axis=0, return_inverse=True)
    sums = np.bincount(inv, weights=np.asarray(freqs, dtype=np.float64))
    return sums[inv]


def degree_stats(items: np.ndarray, freqs: np.ndarray) -> dict:
    """Source/target distinct counts + marginal skew (paper Table III)."""
    n_src = len(np.unique(items[:, 0]))
    n_tgt = len(np.unique(items[:, 1]))
    o1 = exact_marginals(items, freqs, [0])
    o2 = exact_marginals(items, freqs, [1])
    return {
        "n_sources": n_src,
        "n_targets": n_tgt,
        "alpha_median": float(np.median(o1 / o2)),
        "total": int(np.asarray(freqs).sum()),
        "max_freq": int(np.asarray(freqs).max()),
        "distinct": len(items),
    }
