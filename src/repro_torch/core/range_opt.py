"""Data-dependent hash-range optimization (paper Thm 3 and SV-B1).

Given a uniform sample of the stream, estimate per-item

    alpha = O(x1, *) / O(*, x2)

from the sample marginals, aggregate over sampled occurrences (the paper's
default: frequency-weighted median, SIV-A / Example 1 / Fig. 11), and set the
range ratio ``beta = a/b = 1/alpha_agg`` with ``a*b = h``:

    a = sqrt(h / alpha_agg),    b = sqrt(h * alpha_agg)

(This is the AM-GM optimum of the Thm 2/3 error bound.)

For m > 2 separately-hashed parts, the recursive strategy of SV-B1 peels the
last part: beta_m = a_m / a_{1..m-1} with alpha_m = O(*,..,*,y_m) /
O(y_1..y_{m-1}, *), then recurses on the prefix with budget h / a_m.
Computed alpha aggregates are memoized (``beta_cache``) and reused across
greedy stages (SV-B2 "re-using of range ratio estimation").

Port of ``repro/core/range_opt.py`` (numpy, kept as the port's own copy so
the port imports nothing of the JAX package).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Aggregate = str  # 'median' | 'mean' | 'min' | 'max'

# Clamp on the estimated ratio so degenerate samples can't produce ranges < 2.
_BETA_MIN, _BETA_MAX = 1e-6, 1e6


# --------------------------------------------------------------------------
# Sample marginals
# --------------------------------------------------------------------------

def aggregate_sample(items: np.ndarray, freqs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Collapse a sampled stream to (distinct item, sampled frequency)."""
    items = np.ascontiguousarray(np.asarray(items, dtype=np.uint32))
    freqs = np.asarray(freqs, dtype=np.int64)
    uniq, inv = np.unique(items, axis=0, return_inverse=True)
    agg = np.bincount(inv, weights=freqs.astype(np.float64), minlength=len(uniq))
    return uniq, agg.astype(np.int64)


def marginal_per_item(items: np.ndarray, freqs: np.ndarray, cols: Sequence[int]) -> np.ndarray:
    """For each row, the total sampled frequency of items that agree on ``cols``.

    I.e. O(value-of-cols, *) evaluated at every sampled item.
    """
    sub = np.ascontiguousarray(items[:, list(cols)])
    _, inv = np.unique(sub, axis=0, return_inverse=True)
    sums = np.bincount(inv, weights=freqs.astype(np.float64))
    return sums[inv]


def weighted_median(values: np.ndarray, weights: np.ndarray) -> float:
    """Median of the multiset where value v appears weight(v) times (Ex. 1)."""
    order = np.argsort(values, kind="stable")
    v = np.asarray(values, dtype=np.float64)[order]
    w = np.asarray(weights, dtype=np.float64)[order]
    cw = np.cumsum(w)
    cut = 0.5 * cw[-1]
    return float(v[np.searchsorted(cw, cut)])


def aggregate_alpha(alphas: np.ndarray, freqs: np.ndarray, agg: Aggregate = "median") -> float:
    """Aggregate per-item alphas over sampled occurrences (Fig. 11 variants)."""
    a = np.asarray(alphas, dtype=np.float64)
    f = np.asarray(freqs, dtype=np.float64)
    if agg == "median":
        val = weighted_median(a, f)
    elif agg == "mean":
        val = float(np.sum(a * f) / np.sum(f))
    elif agg == "min":
        val = float(np.min(a))
    elif agg == "max":
        val = float(np.max(a))
    else:
        raise ValueError(f"unknown aggregate {agg!r}")
    return float(np.clip(val, _BETA_MIN, _BETA_MAX))


def estimate_alpha(
    items: np.ndarray,
    freqs: np.ndarray,
    first_cols: Sequence[int],
    second_cols: Sequence[int],
    agg: Aggregate = "median",
) -> float:
    """alpha_agg = aggregate of O(first,*)/O(*,second) over the sample."""
    uniq, f = aggregate_sample(items, freqs)
    m1 = marginal_per_item(uniq, f, first_cols)
    m2 = marginal_per_item(uniq, f, second_cols)
    return aggregate_alpha(m1 / m2, f, agg)


# --------------------------------------------------------------------------
# Range splitting
# --------------------------------------------------------------------------

def split_range(h: float, beta: float) -> Tuple[int, int]:
    """Integer (a, b) with a/b ~ beta and a*b ~ h (Thm 3).

    a = sqrt(h*beta), b = sqrt(h/beta).  Paper example: h = 360000,
    beta = 2 -> (849, 424); the paper itself reports 848 x 424, i.e. integer
    products are approximate by design.
    """
    beta = float(np.clip(beta, _BETA_MIN, _BETA_MAX))
    a = max(2, int(round(math.sqrt(h * beta))))
    b = max(2, int(round(h / a)))
    return a, b


def optimal_ranges_mod2(
    items: np.ndarray,
    freqs: np.ndarray,
    h: int,
    agg: Aggregate = "median",
) -> Tuple[int, int]:
    """Thm 3 end-to-end for modularity-2 keys: sample -> alpha_agg -> (a, b)."""
    alpha = estimate_alpha(items, freqs, [0], [1], agg)
    return split_range(h, 1.0 / alpha)


# --------------------------------------------------------------------------
# Recursive ranges for m separately-hashed parts (SV-B1)
# --------------------------------------------------------------------------

BetaCache = Dict[Tuple[Tuple[int, ...], ...], float]


def _alpha_for_split(
    uniq: np.ndarray,
    f: np.ndarray,
    prefix_groups: Sequence[Sequence[int]],
    last_group: Sequence[int],
    agg: Aggregate,
) -> float:
    prefix_cols = [c for g in prefix_groups for c in g]
    m_last = marginal_per_item(uniq, f, list(last_group))
    m_prefix = marginal_per_item(uniq, f, prefix_cols)
    # alpha_m = O(*,...,*, y_m) / O(y_1..y_{m-1}, *)
    return aggregate_alpha(m_last / m_prefix, f, agg)


def recursive_ranges(
    items: np.ndarray,
    freqs: np.ndarray,
    groups: Sequence[Sequence[int]],
    h: float,
    agg: Aggregate = "median",
    beta_cache: Optional[BetaCache] = None,
) -> Tuple[int, ...]:
    """Optimal ranges a_1..a_m for parts ``groups`` with prod ~ h (SV-B1).

    beta_m = 1/alpha_m gives a_m = sqrt(h * beta_m); recurse on the prefix
    with budget h / a_m until one part remains.  ``beta_cache`` memoizes
    alpha aggregates keyed by the (prefix, last) group structure so greedy
    stages can reuse earlier estimates (SV-B2).
    """
    groups = [tuple(int(c) for c in g) for g in groups]
    uniq, f = aggregate_sample(items, freqs)
    cache: BetaCache = beta_cache if beta_cache is not None else {}

    ranges_rev: List[int] = []
    budget = float(h)
    live = list(groups)
    while len(live) > 1:
        key = tuple(tuple(g) for g in live)
        if key in cache:
            beta_m = cache[key]
        else:
            alpha_m = _alpha_for_split(uniq, f, live[:-1], live[-1], agg)
            beta_m = 1.0 / alpha_m
            cache[key] = beta_m
        a_m, _ = split_range(budget, beta_m)
        a_m = min(a_m, max(2, int(budget // (2 ** (len(live) - 1)))))  # leave >=2 per prefix part
        a_m = max(2, a_m)
        ranges_rev.append(a_m)
        budget = max(2.0, budget / a_m)
        live = live[:-1]
    ranges_rev.append(max(2, int(round(budget))))
    return tuple(reversed(ranges_rev))
