"""Exhaustive baseline (paper SVI-A2 comparing method (3)).

Enumerate every set partition of the modules (T(n) of them, Thm 6); for each
partition, *experimentally* search hash-range allocations and keep the
configuration with the smallest observed error on sample queries.  Exactly as
in the paper, this is exponential and guarded to small modularity (the paper
itself could not finish n = 8 within 100 hours).

Port of ``repro/core/exhaustive.py``.  Configuration ``ri`` of partition
``pi`` is hashed with ``draw(7919 * pi + ri, spec)``, the integer the
reference folds into its key (see core/selection.py for the ``draw``
convention).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import sketch as sk
from repro_torch.core.hashing import KeySchema
from repro_torch.core.partition import all_partitions, bell_number
from repro_torch.core.range_opt import aggregate_sample, recursive_ranges
from repro_torch.core.selection import Draw, seeded_draw
from repro_torch.device import DeviceLike


def observed_error(est: np.ndarray, true: np.ndarray) -> float:
    """Paper SVI-A4 metric: sum |est - true| / sum true over queried items."""
    true = np.asarray(true, dtype=np.float64)
    est = np.asarray(est, dtype=np.float64)
    denom = float(true.sum())
    return float(np.abs(est - true).sum() / max(denom, 1.0))


def _range_candidates(m: int, h: float, items, freqs, groups, grid: int) -> List[Tuple[int, ...]]:
    """Candidate range allocations for one partition.

    Includes the equal split, the SV-B1 recursive solution, and (for m == 2)
    a geometric sweep over a -- the 'experimentally find the best choice'
    step of the paper, made tractable.
    """
    cands: List[Tuple[int, ...]] = []
    base = max(2, int(round(h ** (1.0 / m))))
    eq = [base] * m
    eq[-1] = max(2, int(round(h / max(1, int(np.prod(eq[:-1], dtype=np.int64))))))
    cands.append(tuple(eq))
    cands.append(recursive_ranges(items, freqs, groups, h, "median", {}))
    if m == 2:
        for t in np.linspace(-0.8, 0.8, grid):
            a = max(2, int(round(math.sqrt(h) * (10.0 ** t))))
            b = max(2, int(round(h / a)))
            cands.append((a, b))
    elif m > 2:
        # perturb the recursive solution multiplicatively on each axis, then
        # renormalize a partner axis so the product stays ~ h (space budget)
        rec = list(cands[-1])
        for axis in range(m):
            for f in (0.5, 2.0):
                c = list(rec)
                c[axis] = max(2, int(round(c[axis] * f)))
                partner = (axis + 1) % m
                rest = np.prod([c[i] for i in range(m) if i != partner], dtype=np.float64)
                c[partner] = max(2, int(round(h / max(1.0, rest))))
                cands.append(tuple(c))
    # dedup + enforce the space budget (reject > 1.15x h cells per row)
    out, seen = [], set()
    for c in cands:
        prod = float(np.prod(c, dtype=np.float64))
        if c not in seen and prod <= 1.15 * h:
            seen.add(c)
            out.append(c)
    return out


@dataclasses.dataclass
class ExhaustiveResult:
    spec: sk.SketchSpec
    error: float
    n_configs: int
    elapsed_s: float


def exhaustive_config(
    items: np.ndarray,
    freqs: np.ndarray,
    schema: KeySchema,
    h: int,
    w: int,
    draw: Optional[Draw] = None,
    grid: int = 9,
    max_modularity: int = 4,
    query_top: int = 200,
    *,
    device: DeviceLike = None,
) -> ExhaustiveResult:
    """Best (partition, ranges) by brute force over the sample.

    Error is evaluated on the sample's top-`query_top` items against the
    sample's exact frequencies (the paper's observed-error protocol applied
    to the search sample).
    """
    n = schema.modularity
    if n > max_modularity:
        raise ValueError(
            f"exhaustive search over modularity {n} enumerates T({n}) = "
            f"{bell_number(n)} partitions; refusing beyond {max_modularity} "
            "(the paper's Exhaustive did not finish n=8 in 100 hours)"
        )
    draw = draw or seeded_draw()
    t0 = time.perf_counter()
    uniq, f = aggregate_sample(items, freqs)
    top = np.argsort(-f)[:query_top]
    q_items, q_true = uniq[top], f[top]

    best: Optional[Tuple[float, sk.SketchSpec]] = None
    n_configs = 0
    for pi, part in enumerate(all_partitions(range(n))):
        groups = [list(g) for g in part]
        for ri, ranges in enumerate(_range_candidates(len(part), float(h), uniq, f, groups, grid)):
            spec = sk.SketchSpec(schema, part, ranges, w)
            state = sk.build_sketch(spec, draw(7919 * pi + ri, spec), uniq, f,
                                    device=device)
            est = sk.query(spec, state, np.asarray(q_items, dtype=np.uint32)).cpu().numpy()
            err = observed_error(est, q_true)
            n_configs += 1
            if best is None or err < best[0]:
                best = (err, spec)
    return ExhaustiveResult(spec=best[1], error=best[0], n_configs=n_configs,
                            elapsed_s=time.perf_counter() - t0)
