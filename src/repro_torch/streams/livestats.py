"""Live stream statistics from serving-endpoint state (no extra passes).

Port of ``repro/streams/livestats.py``, on the port's ``sk.query`` /
``sk.query_marginal`` (plain reads of the level tables, where the
reference reads through its jnp ones) and its ``greedy_config`` /
``recursive_ranges``.  Where the reference takes a random key,
:func:`propose_spec` takes a ``draw(n, spec)``
(``repro_torch.core.selection``).

The offline strategy search (core/greedy.py, core/range_opt.py) consumes a
uniform weighted sample of the stream.  A production endpoint has no such
sample lying around -- but it DOES maintain, for free:

  * per-group **space-saving pools** (core/summary.py): every group value
    carrying more than total/m of the stream's weight is in its pool, with
    a count that upper-bounds its true weight;
  * per-level **hierarchy tables** (core/hierarchy.py): the level-L table
    holds the mass of every group-prefix, and ``sk.query_marginal`` reads
    any single group's marginal mass straight off the finest table.

``collect_live_stats`` combines the two into a :class:`LiveStats` bundle:
the heavy-hitter descent (pools supply candidate values, level tables
supply prefix mass) yields a weighted *proxy sample* of the stream's head
-- joint keys with their sketch estimates -- plus per-group marginal-skew
summaries.  ``propose_spec`` feeds the proxy sample into the existing
greedy search to re-draw the composite strategy online.

The proxy sample is head-biased by construction (it holds the estimated
top-K keys, not a uniform thinning), which is the right bias for the
range-ratio estimates: the paper's alpha aggregates are frequency-weighted
(SIV-A), so the head dominates them on the skewed streams this matters
for.  When the keyspace is small enough that the pools are under capacity
and the tables collision-free, the proxy sample IS the exact compressed
stream and the re-search is exactly the offline search.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core import sketch as sk
from repro_torch.core.hashing import KeySchema
from repro_torch.core.selection import Draw


@dataclasses.dataclass
class LiveStats:
    """Stream statistics derived from an endpoint's sketch + pool state.

    ``items``/``freqs`` are the weighted proxy sample (schema module
    order, sketch estimates as weights) that feeds the greedy re-search;
    ``group_values``/``group_mass`` are the raw per-group heavy values
    from the pools with their marginal masses read off the level tables.
    """
    schema: KeySchema
    items: np.ndarray                 # uint32[K, n_modules], schema order
    freqs: np.ndarray                 # int64[K] sketch estimates (>= true)
    total: int                        # endpoint's ingested stream mass
    group_values: List[np.ndarray]    # per partition group: uint32[C_j, |g_j|]
    group_mass: List[np.ndarray]      # per group: int64[C_j] marginal mass

    @property
    def coverage(self) -> float:
        """Estimated stream-mass fraction the proxy sample accounts for.

        Can exceed 1.0 under heavy collisions (estimates overcount)."""
        if self.total <= 0:
            return 0.0
        return float(self.freqs.sum() / self.total)

    def group_skew(self, j: int) -> float:
        """Top-value mass fraction of group j's marginal (1.0 = one value
        carries everything; ~C/total... -> uniform).  The per-module skew
        signal that makes re-tuning worthwhile when it drifts."""
        if self.total <= 0 or len(self.group_mass[j]) == 0:
            return 0.0
        return float(self.group_mass[j].max() / self.total)

    def describe(self) -> str:
        gs = " ".join(
            f"g{j}:C={len(v)},skew={self.group_skew(j):.3f}"
            for j, v in enumerate(self.group_values))
        return (f"live-stats: {len(self.items)} proxy keys "
                f"({self.coverage:.2f} of {self.total} mass) {gs}")


def group_marginal_mass(endpoint, j: int, values: np.ndarray) -> np.ndarray:
    """Marginal mass O(*,..,value_of_group_j,..,*) for each value, read off
    the endpoint's level tables.

    Group 0's marginal IS the level-0 table (the coarsest prefix sketch);
    any other group's marginal comes from ``sk.query_marginal`` on the
    finest level, summing the cells that share the group's sub-index --
    the structural capability composite hashing buys over Count-Min.
    """
    values = np.asarray(values, dtype=np.uint32)
    if values.shape[0] == 0:
        return np.zeros((0,), dtype=np.int64)
    state = endpoint.state
    if callable(state):      # the windowed service exposes state() as a method
        state = state()
    hspec = endpoint.hspec
    if j == 0:
        est = sk.query(hspec.levels[0], state.states[0],
                       np.ascontiguousarray(values))
    else:
        est = sk.query_marginal(hspec.levels[-1], state.states[-1], j,
                                np.ascontiguousarray(values))
    return est.cpu().numpy().astype(np.int64)


def collect_live_stats(endpoint, *, k: int = 512,
                       min_threshold: Optional[int] = None) -> LiveStats:
    """Derive :class:`LiveStats` from a serving endpoint's live state.

    ``endpoint`` is anything with the SketchTopKEndpoint query surface
    (``hspec``, ``state``/``state()``, ``candidates()``, ``topk``,
    ``total``) -- the windowed service qualifies.  ``k`` bounds the proxy
    sample (the estimated top-k keys); ``min_threshold`` floors the
    descent exactly as in ``topk`` (pass 1 to force exhaustive descent on
    small keyspaces).

    No stream pass happens here: everything is read from the pools (heavy
    group values) and the level tables (prefix / marginal mass).
    """
    items, est = endpoint.topk(int(k), min_threshold=min_threshold)
    items = np.asarray(items, dtype=np.uint32)
    est = np.asarray(est, dtype=np.int64)

    group_values, group_mass = [], []
    for j, vals in enumerate(endpoint.candidates()):
        vals = np.asarray(vals, dtype=np.uint32)
        group_values.append(vals)
        group_mass.append(group_marginal_mass(endpoint, j, vals))

    return LiveStats(
        schema=endpoint.hspec.base.schema,
        items=items, freqs=est, total=int(endpoint.total),
        group_values=group_values, group_mass=group_mass)


def propose_spec(stats: LiveStats, h: int, w: int, draw: Optional[Draw] = None,
                 agg: str = "median", partition=None, *, device=None):
    """Re-run the strategy search over the live proxy sample.

    With ``partition=None`` this is the full greedy re-search (paper
    Algorithm 1): partition AND per-group ranges are re-drawn with prod ~
    h, width w.  Passing a ``partition`` (usually the endpoint's current
    one) keeps the group structure -- and with it the hierarchy's descent
    levels -- and re-optimizes only the per-group ranges via the SIV-A
    alpha-ratio rule (core.range_opt.recursive_ranges), the knob that
    actually tracks per-module skew drift: when a narrow hot module goes
    wide, its optimal range grows at the expense of the others.

    ``draw`` hashes the greedy search's candidates (``greedy_config``'s
    ``draw``; the range-only path draws nothing); ``device`` is where their
    sample sketches are built.

    Returns a :class:`repro_torch.core.greedy.GreedyResult` either way (the
    range-only path with an empty trace), so callers read ``.spec``
    uniformly.  Whether the proposal is worth a hot migration is the
    caller's call -- serving/autotune.py compares cell-std sigmas
    (core.selection.migration_gain) before pulling the trigger.
    """
    from repro_torch.core.greedy import GreedyResult, greedy_config
    from repro_torch.core.range_opt import recursive_ranges

    if stats.items.shape[0] < 2:
        raise ValueError(
            "propose_spec needs at least 2 proxy keys; the endpoint has "
            "not seen enough distinct stream mass to re-tune from")
    if partition is not None:
        ranges = recursive_ranges(stats.items, stats.freqs, partition,
                                  float(h), agg)
        spec = sk.SketchSpec(stats.schema, tuple(tuple(g) for g in partition),
                             tuple(int(r) for r in ranges), int(w))
        return GreedyResult(spec=spec, trace=[],
                            n_candidates=len(partition), beta_cache_hits=0)
    return greedy_config(stats.items, stats.freqs, stats.schema,
                         int(h), int(w), draw, agg=agg, device=device)
