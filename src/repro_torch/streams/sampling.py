"""Uniform stream sampling (paper SIV: "sample a small portion, 2~4%").

Two modes:
  * ``Stream.sample`` (synthetic.py): Binomial per-item thinning of a
    compressed stream -- the exact distribution of a uniform occurrence
    sample of the flat stream.
  * :class:`BernoulliSampler` here: online single-pass thinning for flat
    arrival blocks (what the training-loop integration uses).
  * :class:`ReservoirSampler`: fixed-budget variant (weighted reservoir,
    A-ES) when the stream length is unknown and memory is the constraint.

Port of ``repro/streams/sampling.py`` (numpy, the port's own copy).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class BernoulliSampler:
    """Keep each stream occurrence independently with probability p."""

    def __init__(self, p: float, seed: int = 0):
        if not (0.0 < p <= 1.0):
            raise ValueError("p in (0, 1] required")
        self.p = float(p)
        self.rng = np.random.default_rng(seed)
        self._items: List[np.ndarray] = []
        self._freqs: List[np.ndarray] = []

    def offer(self, items: np.ndarray, freqs: Optional[np.ndarray] = None) -> None:
        items = np.asarray(items, dtype=np.uint32)
        if freqs is None:
            freqs = np.ones(items.shape[0], dtype=np.int64)
        kept = self.rng.binomial(np.asarray(freqs, dtype=np.int64), self.p)
        mask = kept > 0
        if mask.any():
            self._items.append(items[mask])
            self._freqs.append(kept[mask])

    def sample(self) -> Tuple[np.ndarray, np.ndarray]:
        if not self._items:
            return np.zeros((0, 1), dtype=np.uint32), np.zeros((0,), dtype=np.int64)
        return np.concatenate(self._items, axis=0), np.concatenate(self._freqs)


class ReservoirSampler:
    """Weighted reservoir (Efraimidis-Spirakis A-ES) of stream occurrences."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = int(capacity)
        self.rng = np.random.default_rng(seed)
        self._keys: Optional[np.ndarray] = None   # float64 priorities
        self._items: Optional[np.ndarray] = None
        self._freqs: Optional[np.ndarray] = None

    def offer(self, items: np.ndarray, freqs: Optional[np.ndarray] = None) -> None:
        items = np.asarray(items, dtype=np.uint32)
        if freqs is None:
            freqs = np.ones(items.shape[0], dtype=np.int64)
        freqs = np.asarray(freqs, dtype=np.float64)
        pri = self.rng.random(items.shape[0]) ** (1.0 / np.maximum(freqs, 1e-12))
        if self._keys is None:
            self._keys, self._items, self._freqs = pri, items, freqs.astype(np.int64)
        else:
            self._keys = np.concatenate([self._keys, pri])
            self._items = np.concatenate([self._items, items], axis=0)
            self._freqs = np.concatenate([self._freqs, freqs.astype(np.int64)])
        if len(self._keys) > self.capacity:
            top = np.argpartition(-self._keys, self.capacity)[: self.capacity]
            self._keys = self._keys[top]
            self._items = self._items[top]
            self._freqs = self._freqs[top]

    def sample(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._items is None:
            return np.zeros((0, 1), dtype=np.uint32), np.zeros((0,), dtype=np.int64)
        return self._items, self._freqs
