"""DStream-style batched streaming harness with live accuracy tracking.

Port of ``repro/streams/dstream.py`` (numpy over the port's ``sampling`` and
``stats``).  Feeds a stream of TIMESTAMPED batches through a windowed heavy-hitter
service (serving/windowed_topk.py), advancing the service's epoch clock
from the timestamps, and after every batch scores the service against
exact windowed ground truth maintained alongside:

  * average relative error (streams.stats.average_relative_error) over the
    window's exact top-k keys,
  * heavy-hitter recall/precision at a phi-fraction threshold of the
    window mass,
  * F2: the exact second moment of the window vs the sketch's row-min
    upper bound (streams.stats.sketch_f2_upper), as relative error.

This is the single-device answer to the Spark-cluster style discretized-
stream evaluation loops (batch -> update sketch -> compare against exact
counts -> report ARE/F2): the exact counter here is a ring of per-epoch
dicts that expires with the service, so ground truth and sketch always
describe the SAME window.  The harness can also thin the stream through a
BernoulliSampler (streams/sampling.py) on the side -- the paper's 2-4%
uniform sample, kept live for offline range re-tuning -- without touching
the ground truth.

The harness reads the service's tables to the host for F2 each batch, and
its point estimates (``hierarchy_point_estimates``) are plain gathers on
the tables' device: it scores the service, it is not its serving path.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.streams.sampling import BernoulliSampler
from repro_torch.streams.stats import (
    average_relative_error,
    exact_f2,
    hierarchy_point_estimates,
    sketch_f2_upper,
)


# --------------------------------------------------------------------------
# Exact windowed ground truth
# --------------------------------------------------------------------------

class ExactWindowCounter:
    """Ring of per-epoch exact counters mirroring the service's window.

    Same epoch semantics as core/window.py: tumbling drops expired epochs,
    landmark folds them into a retired counter, decay weights epoch age a
    by decay**a (applied at read time over the live ring -- exact, no
    accumulating float drift).  Memory is O(distinct keys in the window),
    which is the price of ground truth and why it lives in the evaluation
    harness, not the serving path.
    """

    def __init__(self, n_epochs: int, mode: str = "tumbling",
                 decay: float = 1.0):
        if mode not in ("tumbling", "landmark", "decay"):
            raise ValueError(f"unknown mode {mode!r}")
        self.n_epochs = int(n_epochs)
        self.mode = mode
        self.decay = float(decay)
        self._ring: List[Counter] = [Counter() for _ in range(self.n_epochs)]
        self._retired: Counter = Counter()
        self._head = 0
        self._epoch = 0

    def ingest(self, items: np.ndarray, freqs: np.ndarray) -> None:
        c = self._ring[self._head]
        for row, f in zip(np.asarray(items).tolist(),
                          np.asarray(freqs).tolist()):
            if f:
                c[tuple(row)] += f

    def advance(self) -> None:
        self._head = (self._head + 1) % self.n_epochs
        if self.mode == "landmark":
            self._retired.update(self._ring[self._head])
        self._ring[self._head] = Counter()
        self._epoch += 1

    def window_counts(self) -> Dict[tuple, float]:
        """Exact key -> (possibly decay-weighted) frequency of the window."""
        n_live = min(self._epoch + 1, self.n_epochs)
        out: Dict[tuple, float] = dict(self._retired) \
            if self.mode == "landmark" else {}
        for a in reversed(range(n_live)):            # oldest -> newest
            slot = (self._head - a) % self.n_epochs
            wgt = self.decay ** a if self.mode == "decay" else 1.0
            for k, f in self._ring[slot].items():
                out[k] = out.get(k, 0.0) + wgt * f
        return out


# --------------------------------------------------------------------------
# Timestamped batches
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Batch:
    """One discretized-stream arrival: a weighted key block at a time."""
    t: int                    # epoch timestamp (non-decreasing)
    items: np.ndarray         # uint32[B, n_modules]
    freqs: np.ndarray         # int64[B]


def timestamped_batches(items: np.ndarray, freqs: np.ndarray,
                        n_batches: int, batches_per_epoch: int = 1,
                        ) -> Iterator[Batch]:
    """Cut a compressed stream into ``n_batches`` equal arrival batches,
    ``batches_per_epoch`` of them per epoch tick."""
    items = np.asarray(items, dtype=np.uint32)
    freqs = np.asarray(freqs)
    edges = np.linspace(0, items.shape[0], n_batches + 1).astype(int)
    for b, (s, e) in enumerate(zip(edges[:-1], edges[1:])):
        yield Batch(t=b // batches_per_epoch, items=items[s:e],
                    freqs=freqs[s:e])


def drifting_batches(schema_domains: Tuple[int, int], n_batches: int,
                     rows_per_batch: int, *, batches_per_epoch: int = 1,
                     drift_every: int = 4, n_keys: int = 2_000,
                     s: float = 1.2, seed: int = 0) -> Iterator[Batch]:
    """Zipf key stream whose popularity RANKING is re-permuted every
    ``drift_every`` epochs -- the workload where "since boot" and "last
    hour" genuinely disagree, used by the window benchmark's accuracy
    sweep.  Keys are 2-module (edge-like) over ``schema_domains``."""
    rng = np.random.default_rng(seed)
    keys = np.stack([
        rng.choice(schema_domains[0], size=n_keys, replace=False),
        rng.choice(schema_domains[1], size=n_keys, replace=False),
    ], axis=1).astype(np.uint32)
    p = np.arange(1, n_keys + 1, dtype=np.float64) ** (-s)
    p /= p.sum()
    perm = rng.permutation(n_keys)
    for b in range(n_batches):
        epoch = b // batches_per_epoch
        if b and b % (drift_every * batches_per_epoch) == 0:
            perm = rng.permutation(n_keys)       # new heavy set
        draws = rng.choice(n_keys, size=rows_per_batch, p=p)
        picked = keys[perm[draws]]
        uniq, inv = np.unique(picked, axis=0, return_inverse=True)
        yield Batch(t=epoch, items=uniq,
                    freqs=np.bincount(inv).astype(np.int64))


def skew_flip_batches(schema_domains: Tuple[int, int], n_batches: int,
                      rows_per_batch: int, *, batches_per_epoch: int = 1,
                      flip_after: Optional[int] = None, narrow: int = 8,
                      wide: int = 1_024, s: float = 1.4,
                      seed: int = 0) -> Iterator[Batch]:
    """Two-module stream whose per-MODULE marginal skew flips mid-stream.

    Unlike :func:`drifting_batches` (which re-permutes the joint ranking
    but keeps each module's marginal shape), this drifts the statistic the
    composite-hash strategy is actually tuned to: before the flip, module
    0's marginal is concentrated on ``narrow`` hot values (zipf ``s``)
    while module 1 is near-uniform over ``wide`` values; after batch
    ``flip_after`` (default: halfway) the roles swap.  Modules are drawn
    independently, so the optimal per-group ranges (a, b) under the
    paper's alpha-ratio rule flip with them -- a spec tuned on the first
    phase is measurably stale on the second, which is what the online
    auto-tuner (serving/autotune.py) exists to catch.
    """
    if flip_after is None:
        flip_after = n_batches // 2
    rng = np.random.default_rng(seed)
    d0, d1 = schema_domains
    narrow = min(narrow, d0, d1)
    vals0 = rng.choice(d0, size=min(wide, d0), replace=False).astype(np.uint32)
    vals1 = rng.choice(d1, size=min(wide, d1), replace=False).astype(np.uint32)

    def _marginal_p(n_vals: int, skewed: bool) -> np.ndarray:
        if skewed:
            p = np.zeros(n_vals, dtype=np.float64)
            p[:narrow] = np.arange(1, narrow + 1, dtype=np.float64) ** (-s)
        else:
            p = np.ones(n_vals, dtype=np.float64)
        return p / p.sum()

    for b in range(n_batches):
        hot0 = b < flip_after                  # module 0 skewed first phase
        c0 = rng.choice(len(vals0), size=rows_per_batch,
                        p=_marginal_p(len(vals0), skewed=hot0))
        c1 = rng.choice(len(vals1), size=rows_per_batch,
                        p=_marginal_p(len(vals1), skewed=not hot0))
        picked = np.stack([vals0[c0], vals1[c1]], axis=1)
        uniq, inv = np.unique(picked, axis=0, return_inverse=True)
        yield Batch(t=b // batches_per_epoch, items=uniq,
                    freqs=np.bincount(inv).astype(np.int64))


# --------------------------------------------------------------------------
# Harness
# --------------------------------------------------------------------------

@dataclasses.dataclass
class BatchReport:
    """Live accuracy of the service after one batch, vs exact window truth."""
    batch: int
    epoch: int
    window_total: float       # exact (decay-weighted) window mass
    window_distinct: int
    are_topk: float           # ARE over the exact top-k window keys
    recall: float             # heavy hitters found / exact heavy hitters
    precision: float          # exact among reported heavy hitters
    f2_exact: float
    f2_est: float             # sketch row-min upper bound
    f2_rel_err: float         # (f2_est - f2_exact) / f2_exact  (>= 0 linear)


class DStreamHarness:
    """Drive a WindowedTopKService over timestamped batches, scoring live.

    ``k`` sizes the ARE query set (the window's exact top-k); ``phi``
    sets the heavy-hitter threshold as a fraction of the exact window
    mass.  ``sample_p`` optionally maintains a Bernoulli-thinned side
    sample of everything ingested (``.sample()``), the paper's uniform
    stream sample kept warm for offline strategy re-tuning.
    """

    def __init__(self, service, *, k: int = 32, phi: float = 0.01,
                 sample_p: Optional[float] = None, sample_seed: int = 0):
        self.service = service
        self.k = int(k)
        self.phi = float(phi)
        self.exact = ExactWindowCounter(
            service.wspec.n_epochs, mode=service.wspec.mode,
            decay=service.wspec.decay)
        self.sampler = (BernoulliSampler(sample_p, seed=sample_seed)
                        if sample_p else None)
        self.reports: List[BatchReport] = []
        self._batch = 0
        self._clock = 0

    def sample(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.sampler is None:
            raise ValueError("harness built without sample_p")
        return self.sampler.sample()

    def step(self, batch: Batch) -> BatchReport:
        """Ingest one batch (advancing epochs to its timestamp), then score."""
        if batch.t < self._clock:
            raise ValueError(
                f"batch timestamps must be non-decreasing (got {batch.t} "
                f"after {self._clock})")
        while self._clock < batch.t:
            self.service.advance()
            self.exact.advance()
            self._clock += 1
        self.service.ingest(batch.items, batch.freqs)
        self.exact.ingest(batch.items, batch.freqs)
        if self.sampler is not None:
            self.sampler.offer(batch.items, batch.freqs)
        report = self._score()
        self.reports.append(report)
        self._batch += 1
        return report

    def run(self, batches: Iterable[Batch]) -> List[BatchReport]:
        for batch in batches:
            self.step(batch)
        return self.reports

    def _score(self) -> BatchReport:
        truth = self.exact.window_counts()
        total = float(sum(truth.values()))
        ranked = sorted(truth.items(), key=lambda kv: (-kv[1], kv[0]))

        # ARE over the exact top-k window keys (point queries against the
        # merged window state -- the descent is not needed for scoring)
        top = ranked[: self.k]
        if top:
            qi = np.asarray([k for k, _ in top], dtype=np.uint32)
            qt = np.asarray([f for _, f in top], dtype=np.float64)
            est = hierarchy_point_estimates(
                self.service.hspec, self.service.state(), qi)
            are = average_relative_error(est, qt)
        else:
            are = 0.0

        # heavy hitters at phi * window mass
        thr = max(1, int(self.phi * total))
        exact_hh = {k for k, f in truth.items() if f >= thr}
        got_items, _ = self.service.heavy_hitters(thr)
        got_hh = {tuple(r) for r in got_items.tolist()}
        recall = (len(exact_hh & got_hh) / len(exact_hh)) if exact_hh else 1.0
        precision = (len(exact_hh & got_hh) / len(got_hh)) if got_hh else 1.0

        # F2 of the window: exact vs the finest level's row-min bound
        f2 = exact_f2(np.asarray(list(truth.values())))
        finest = self.service.state().states[-1].table.cpu().numpy()
        f2_est = sketch_f2_upper(finest)
        f2_err = (f2_est - f2) / f2 if f2 > 0 else 0.0

        return BatchReport(
            batch=self._batch, epoch=self._clock, window_total=total,
            window_distinct=len(truth), are_topk=are, recall=recall,
            precision=precision, f2_exact=f2, f2_est=f2_est,
            f2_rel_err=f2_err)

