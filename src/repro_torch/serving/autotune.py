"""Online strategy auto-tuning: live stats -> greedy re-search -> migration.

Port of ``repro/serving/autotune.py``.  Where the reference derives each
evaluation's randomness from its key folded with the round, and folds
further integers into that key for the search, the sigma sample and the
successor, the port takes a ``draw(path, spec)``: the hash params of
``spec`` that the reference would draw from its key folded with each
integer of ``path`` in turn (:data:`KeyDraw`).  Round r asks for ``(r, 0,
n)`` for the greedy search's candidate n, ``(r, 1, 0)`` and ``(r, 1, 1)``
for the current and proposed specs' sigma samples, and ``(r, 2)`` for the
successor's params; a test hands the port the reference's own draws this
way.  The default is :func:`seeded_key_draw`.

Closes the loop the offline pipeline leaves open.  The offline flow picks
a composite-hash strategy from a pre-stream sample (core/greedy.py) and
then the spec is frozen -- if the stream's per-module skew drifts (a
narrow hot module goes wide, a wide one collapses), the frozen strategy
keeps paying collision error the drifted stream no longer justifies.

:class:`AutoTuner` watches a serving endpoint and periodically:

  1. derives :class:`repro.streams.livestats.LiveStats` from state the
     endpoint already maintains (pools + level tables -- no stream pass);
  2. re-runs the greedy search over the live proxy sample
     (``propose_spec``) under the SAME space budget (h, w) as the
     current spec unless overridden;
  3. scores current vs proposed spec on that sample
     (core.selection.migration_gain, the Thm 4/5 cell-std criterion) and
     triggers ``endpoint.begin_migration`` only when the proposal wins by
     a real margin (``sigma_new < min_improvement * sigma_cur``);
  4. the endpoint then runs the double-write warmup window and cuts over
     on its own (serving/migration.py) -- the tuner never serves queries
     and never touches tables.

Everything here is policy; mechanism lives in livestats / selection /
migration.  Linear mode only, inherited from ``begin_migration``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import sketch as sk
from repro_torch.core.selection import migration_gain
from repro_torch.streams.livestats import LiveStats, collect_live_stats, propose_spec

KeyDraw = Callable[[Tuple[int, ...], sk.SketchSpec], object]


def seeded_key_draw(seed: int = 0) -> KeyDraw:
    """The default :data:`KeyDraw`: the params of ``spec`` from a
    ``torch.Generator`` seeded by ``(seed, *path)``, on the CPU (the builds
    move them to their device)."""
    def draw(path: Tuple[int, ...], spec: sk.SketchSpec) -> sk.SketchParams:
        state = np.random.SeedSequence([int(seed), *map(int, path)]).generate_state(
            1, np.uint64)
        return sk.init_params(spec, torch.Generator().manual_seed(int(state[0])), "cpu")

    return draw


@dataclasses.dataclass
class TuneDecision:
    """One auto-tune evaluation (kept for tests / bench reporting)."""
    at_total: int                 # endpoint mass when evaluated
    sigma_current: float
    sigma_proposed: float
    migrated: bool
    reason: str                   # 'migrated' | 'no-gain' | 'same-spec'
    #                             | 'too-few-keys' | 'already-migrating'
    proposed_partition: Optional[tuple] = None
    proposed_ranges: Optional[tuple] = None


class AutoTuner:
    """Periodic re-tune policy over one serving endpoint.

    ``endpoint`` is a SketchTopKEndpoint (anything with ``hspec``,
    ``total``, ``topk``, ``candidates``, ``migrating`` and
    ``begin_migration``).  Call :meth:`step` after ingesting -- it is a
    cheap no-op until ``retune_every`` stream mass has accumulated since
    the last evaluation.  ``draw`` is the :data:`KeyDraw` of the module
    docstring (default ``seeded_key_draw(0)``).  The search's and the
    sigma's sample sketches are built on the endpoint's device.

    ``h``/``w`` default to the current spec's budget (prod(ranges),
    width), so re-tuning never changes the memory footprint unless asked.
    ``min_improvement`` guards against migration churn: the proposed
    spec's sample cell-std must be below ``min_improvement * sigma_cur``
    (strictly) to justify a double-write window.

    ``search='greedy'`` re-draws the full strategy (Algorithm 1);
    ``search='ranges'`` keeps the current partition -- and with it the
    hierarchy's descent levels -- and re-optimizes only the per-group
    ranges from the live alpha ratios (SIV-A), the cheaper knob that
    tracks per-module skew drift.
    """

    def __init__(self, endpoint, draw: Optional[KeyDraw] = None, *,
                 retune_every: int,
                 warmup: int,
                 h: Optional[int] = None,
                 w: Optional[int] = None,
                 min_improvement: float = 0.9,
                 sample_k: int = 512,
                 min_threshold: Optional[int] = None,
                 agg: str = "median",
                 search: str = "greedy"):
        if retune_every < 1:
            raise ValueError("retune_every must be >= 1 stream mass units")
        if not (0.0 < min_improvement <= 1.0):
            raise ValueError("min_improvement must be in (0, 1]")
        if search not in ("greedy", "ranges"):
            raise ValueError(f"search must be 'greedy' or 'ranges', got {search!r}")
        self.endpoint = endpoint
        self.draw = draw or seeded_key_draw()
        self.retune_every = int(retune_every)
        self.warmup = int(warmup)
        base = endpoint.hspec.base
        self.h = int(h) if h is not None else int(np.prod(base.ranges))
        self.w = int(w) if w is not None else int(base.width)
        self.min_improvement = float(min_improvement)
        self.sample_k = int(sample_k)
        self.min_threshold = min_threshold
        self.agg = agg
        self.search = search
        self._next_at = int(endpoint.total) + self.retune_every
        self._round = 0
        self.decisions: List[TuneDecision] = []

    # -- policy ----------------------------------------------------------

    @property
    def last_decision(self) -> Optional[TuneDecision]:
        return self.decisions[-1] if self.decisions else None

    def step(self) -> Optional[TuneDecision]:
        """Evaluate a re-tune if due; returns the decision, else None."""
        total = int(self.endpoint.total)
        if total < self._next_at:
            return None
        self._next_at = total + self.retune_every
        return self._evaluate(total)

    def force(self) -> TuneDecision:
        """Evaluate a re-tune now regardless of the schedule."""
        total = int(self.endpoint.total)
        self._next_at = total + self.retune_every
        return self._evaluate(total)

    # -- one evaluation --------------------------------------------------

    def _record(self, d: TuneDecision) -> TuneDecision:
        self.decisions.append(d)
        return d

    def _round_draw(self, *path: int):
        """The draw of this round's key folded with ``path``: a ``draw(n,
        spec)`` for the search and the sigma samples."""
        head = (self._round,) + path
        return lambda n, spec: self.draw(head + (n,), spec)

    def _evaluate(self, total: int) -> TuneDecision:
        self._round += 1
        if self.endpoint.migrating:
            return self._record(TuneDecision(
                at_total=total, sigma_current=float("nan"),
                sigma_proposed=float("nan"), migrated=False,
                reason="already-migrating"))

        stats: LiveStats = collect_live_stats(
            self.endpoint, k=self.sample_k, min_threshold=self.min_threshold)
        if stats.items.shape[0] < 2:
            return self._record(TuneDecision(
                at_total=total, sigma_current=float("nan"),
                sigma_proposed=float("nan"), migrated=False,
                reason="too-few-keys"))

        current = self.endpoint.hspec.base
        proposal = propose_spec(
            stats, self.h, self.w, self._round_draw(0), agg=self.agg,
            partition=current.partition if self.search == "ranges" else None,
            device=self.endpoint.device)
        new_spec = proposal.spec
        if (new_spec.partition == current.partition
                and new_spec.ranges == current.ranges):
            return self._record(TuneDecision(
                at_total=total, sigma_current=0.0, sigma_proposed=0.0,
                migrated=False, reason="same-spec",
                proposed_partition=new_spec.partition,
                proposed_ranges=new_spec.ranges))

        sigma_cur, sigma_new = migration_gain(
            current, new_spec, stats.items, stats.freqs, self._round_draw(1),
            device=self.endpoint.device)
        if not sigma_new < self.min_improvement * sigma_cur:
            return self._record(TuneDecision(
                at_total=total, sigma_current=sigma_cur,
                sigma_proposed=sigma_new, migrated=False, reason="no-gain",
                proposed_partition=new_spec.partition,
                proposed_ranges=new_spec.ranges))

        self.endpoint.begin_migration(
            new_spec, self.draw((self._round, 2), new_spec), warmup=self.warmup)
        return self._record(TuneDecision(
            at_total=total, sigma_current=sigma_cur,
            sigma_proposed=sigma_new, migrated=True, reason="migrated",
            proposed_partition=new_spec.partition,
            proposed_ranges=new_spec.ranges))
