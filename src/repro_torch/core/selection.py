"""Sketch selection by cell-value standard deviation (paper Thm 4/5, SIV-B).

Port of ``repro/core/selection.py``.  Between two equal-size sketches built
over the *same uniform sample*, the one with smaller cell-value standard
deviation yields smaller estimation error with high probability
(Cantelli).  Thm 5 shows the sample decision transfers to the full stream
since (sigma^p)^2 = p * sigma^2 under uniform sampling.

Hash draws.  The reference derives one jax key per scored candidate with
``jax.random.fold_in(key, n)``, which torch cannot reproduce.  The port's
search functions take a ``draw(n, spec)`` in its place: it returns the hash
params of candidate ``n`` (a ``SketchParams`` or a ``(q, r)`` pair of
arrays), where ``n`` is the integer the reference folds in.
``seeded_draw(0)`` is the default; passing the reference's own draws
through ``draw`` builds the same sketches on both sides.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import sketch as sk
from repro_torch.core.hashing import KeySchema
from repro_torch.core.range_opt import Aggregate, optimal_ranges_mod2
from repro_torch.device import DeviceLike

Draw = Callable[[int, sk.SketchSpec], object]


def seeded_draw(seed: int = 0) -> Draw:
    """The default ``draw``: candidate ``n``'s params from a
    ``torch.Generator`` seeded by ``(seed, n)``, on the CPU (the builds
    move them to their device)."""
    def draw(n: int, spec: sk.SketchSpec) -> sk.SketchParams:
        state = np.random.SeedSequence([int(seed), int(n)]).generate_state(1, np.uint64)
        gen = torch.Generator().manual_seed(int(state[0]))
        return sk.init_params(spec, gen, "cpu")

    return draw


def sample_cell_std(
    spec: sk.SketchSpec,
    params,
    items: np.ndarray,
    freqs: np.ndarray,
    device: DeviceLike = None,
) -> float:
    """Build ``spec`` over the sample and return the cell std statistic.
    ``params``: a ``torch.Generator`` or a ``(q, r)`` draw."""
    state = sk.build_sketch(spec, params, items, freqs, device=device)
    return float(sk.cell_std(state.table))


@dataclasses.dataclass
class SelectionResult:
    choice: str                       # 'count-min' | 'mod-sketch'
    spec: sk.SketchSpec
    sigma: Dict[str, float]
    mod_ranges: Tuple[int, ...]


def choose_sketch(
    items: np.ndarray,
    freqs: np.ndarray,
    schema: KeySchema,
    h: int,
    w: int,
    draw: Optional[Draw] = None,
    agg: Aggregate = "median",
    candidates: Optional[Dict[str, sk.SketchSpec]] = None,
    *,
    device: DeviceLike = None,
) -> SelectionResult:
    """Paper SIV summary steps (1)-(3) for modularity-2 keys.

    (1) the caller supplies the uniform sample; (2) find optimal MOD ranges
    (a, b) via Thm 3; (3) store the sample in both Count-Min and MOD-Sketch
    and keep the one with smaller cell std.  ``candidates`` may override /
    extend the compared specs.  Candidate i is hashed with ``draw(i, spec)``.
    """
    draw = draw or seeded_draw()
    if candidates is None:
        a, b = optimal_ranges_mod2(items, freqs, h, agg)
        candidates = {
            "count-min": sk.count_min_spec(schema, h, w),
            "mod-sketch": sk.mod_sketch_spec(schema, [(0,), (1,)], (a, b), w),
        }
    sigma: Dict[str, float] = {}
    for i, (name, spec) in enumerate(candidates.items()):
        sigma[name] = sample_cell_std(spec, draw(i, spec), items, freqs, device)
    choice = min(sigma, key=sigma.get)
    spec = candidates[choice]
    mod_ranges = candidates.get("mod-sketch", spec).ranges
    return SelectionResult(choice=choice, spec=spec, sigma=sigma, mod_ranges=mod_ranges)


def migration_gain(
    current: sk.SketchSpec,
    proposed: sk.SketchSpec,
    items: np.ndarray,
    freqs: np.ndarray,
    draw: Optional[Draw] = None,
    *,
    device: DeviceLike = None,
) -> Tuple[float, float]:
    """Thm 4/5 criterion applied to a hot-migration decision.

    Builds both specs over the SAME weighted sample (hashed with draws 0
    and 1) and returns ``(sigma_current, sigma_proposed)``; the smaller
    cell-value standard deviation predicts the smaller estimation error
    with high probability (Cantelli).
    """
    draw = draw or seeded_draw()
    sigma_cur = sample_cell_std(current, draw(0, current), items, freqs, device)
    sigma_new = sample_cell_std(proposed, draw(1, proposed), items, freqs, device)
    return sigma_cur, sigma_new
