"""Greedy hashing-strategy search for modularity > 2 (paper Algorithm 1, SV-B).

Walk the modules in order.  At the stage of module j the committed config
covers some prefix of modules; the (n-k+1) choices are:

    * hash x_j as its own part, or
    * combine x_j with a remaining module x_r (r > j) -- joining x_r's
      existing group if an earlier stage already grouped it (Fig. 3c).

Each choice is scored by building the induced *partial* sketch over the
uniform sample -- total range h^((#covered)/n), per-part ranges from the
SV-B1 recursive ratio method -- and comparing cell standard deviations
(the SIV-B criterion).  Range-ratio estimates are memoized in a shared
``beta_cache`` and reused across stages (SV-B2).  Total candidates scored:
sum_k (n-k+1) = O(n^2), vs. the Bell number T(n) for the exact search.

Port of ``repro/core/greedy.py``.  Candidate ``ci`` of stage ``j`` is hashed
with ``draw(1000 * j + ci, spec)``, the integer the reference folds into its
key (see core/selection.py for the ``draw`` convention).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import sketch as sk
from repro_torch.core.hashing import KeySchema
from repro_torch.core.partition import canonical
from repro_torch.core.range_opt import Aggregate, BetaCache, recursive_ranges
from repro_torch.core.selection import Draw, sample_cell_std, seeded_draw
from repro_torch.device import DeviceLike


@dataclasses.dataclass
class GreedyTrace:
    """One scored candidate (kept for tests / Fig. 6-9 style reporting)."""
    stage: int
    partition: Tuple[Tuple[int, ...], ...]
    covered: Tuple[int, ...]
    ranges: Tuple[int, ...]
    sigma: float
    chosen: bool


@dataclasses.dataclass
class GreedyResult:
    spec: sk.SketchSpec
    trace: List[GreedyTrace]
    n_candidates: int
    beta_cache_hits: int


def _projected_spec(
    schema: KeySchema,
    groups: Sequence[Sequence[int]],
    covered: Sequence[int],
    ranges: Sequence[int],
    w: int,
) -> Tuple[sk.SketchSpec, List[int]]:
    """Spec over the sub-key of ``covered`` modules (renumbered 0..c-1)."""
    covered = sorted(covered)
    remap = {m: i for i, m in enumerate(covered)}
    sub_schema = KeySchema(domains=tuple(schema.domains[m] for m in covered))
    sub_groups = tuple(tuple(remap[m] for m in g) for g in groups)
    return sk.SketchSpec(sub_schema, sub_groups, tuple(ranges), w), covered


def _score_partition(
    items: np.ndarray,
    freqs: np.ndarray,
    schema: KeySchema,
    groups: Sequence[Sequence[int]],
    total_range: float,
    w: int,
    draw: Draw,
    n_draw: int,
    agg: Aggregate,
    beta_cache: BetaCache,
    device: DeviceLike,
) -> Tuple[float, Tuple[int, ...]]:
    groups = canonical(groups)
    covered = sorted(m for g in groups for m in g)
    sub_items = np.ascontiguousarray(items[:, covered])
    # renumber groups into the projected column space for the marginal calc
    remap = {m: i for i, m in enumerate(covered)}
    proj_groups = [tuple(remap[m] for m in g) for g in groups]
    ranges = recursive_ranges(sub_items, freqs, proj_groups, total_range, agg, beta_cache)
    spec, _ = _projected_spec(schema, groups, covered, ranges, w)
    sigma = sample_cell_std(spec, draw(n_draw, spec), sub_items, freqs, device)
    return sigma, ranges


def greedy_config(
    items: np.ndarray,
    freqs: np.ndarray,
    schema: KeySchema,
    h: int,
    w: int,
    draw: Optional[Draw] = None,
    agg: Aggregate = "median",
    *,
    device: DeviceLike = None,
) -> GreedyResult:
    """Algorithm 1: greedy composite-hashing strategy for modularity-n keys."""
    draw = draw or seeded_draw()
    n = schema.modularity
    if n < 2:
        raise ValueError("greedy search needs modularity >= 2")

    group_of: Dict[int, int] = {}          # module -> group id
    groups: Dict[int, List[int]] = {}      # group id -> members
    next_gid = 0
    beta_cache: BetaCache = {}
    trace: List[GreedyTrace] = []
    n_candidates = 0
    cache_hits = 0

    for j in range(n):
        if j in group_of:
            continue  # already combined by an earlier stage
        # ------------------------------------------------------ candidates
        # each candidate: (description, groups-after-choice)
        cands: List[Tuple[str, List[List[int]]]] = []
        base = [sorted(members) for members in groups.values()]
        cands.append(("separate", base + [[j]]))
        seen_struct = set()
        for r in range(j + 1, n):
            if r in group_of:
                tgt = sorted(groups[group_of[r]] + [j])
                rest = [sorted(m) for gid, m in groups.items() if gid != group_of[r]]
                struct = canonical(rest + [tgt])
            else:
                struct = canonical(base + [[j, r]])
            if struct in seen_struct:
                continue
            seen_struct.add(struct)
            cands.append((f"merge({j},{r})", [list(g) for g in struct]))

        # ------------------------------------------------------ score
        best = None
        stage_traces = []
        for ci, (_, cand_groups) in enumerate(cands):
            covered = sorted(m for g in cand_groups for m in g)
            total_range = float(h) ** (len(covered) / n)
            before = len(beta_cache)
            sigma, ranges = _score_partition(
                items, freqs, schema, cand_groups, total_range, w,
                draw, 1000 * j + ci, agg, beta_cache, device,
            )
            n_candidates += 1
            if len(beta_cache) == before and len(cand_groups) > 1:
                cache_hits += 1  # every ratio this candidate needed was cached
            t = GreedyTrace(
                stage=j, partition=canonical(cand_groups), covered=tuple(covered),
                ranges=ranges, sigma=sigma, chosen=False,
            )
            stage_traces.append((sigma, t, cand_groups))
            if best is None or sigma < best[0]:
                best = (sigma, t, cand_groups)

        best[1].chosen = True
        trace.extend(t for _, t, _ in stage_traces)

        # ------------------------------------------------------ commit
        groups = {}
        group_of = {}
        for gi, g in enumerate(canonical(best[2])):
            groups[gi] = list(g)
            for m in g:
                group_of[m] = gi
        next_gid = len(groups)

    # final ranges over the full key with the full budget h
    final_partition = canonical([g for g in groups.values()])
    ranges = recursive_ranges(items, freqs, final_partition, float(h), agg, beta_cache)
    spec = sk.SketchSpec(schema, final_partition, tuple(ranges), w)
    return GreedyResult(spec=spec, trace=trace, n_candidates=n_candidates,
                        beta_cache_hits=cache_hits)
