"""Space-saving (Misra-Gries style) summaries of weighted value streams.

Port of ``repro/core/summary.py``, verbatim numpy: dict insertion order is
part of the bitwise top-k tie order, so the port keeps the reference's
exact data structures rather than importing them (importing any ``repro``
module pulls in jax).

Used by the serving endpoint's candidate-pool admission
(serving/sketch_engine.py): each partition group keeps one bounded summary of the
group values seen so far, so late-arriving heavy values still enter the
candidate sets by evicting the lightest entry instead of being dropped by a
first-come cap.

Standard weighted space-saving (Metwally et al. 2005): at capacity, an
unseen value replaces the minimum-count entry and inherits its count (the
``err`` field records that inherited overestimate).  Guarantees, with
capacity m over total weight W:

  * count(v) >= true(v)            (counts only overestimate),
  * count(v) - true(v) <= W / m    (the inherited error is bounded),
  * every value with true(v) > W / m is in the summary.

Counts are float64 so fractional weights (f32 gradient streams) admit
normally; float64 sums of integer weights stay exact below 2^53.  Only the
*values* feed the heavy-hitter descent (estimates come from the sketch
tables, not from these counts), so the counts' job is eviction ranking and
the W/m admission guarantee.  Eviction uses a lazy min-heap (stale entries
skipped on pop), so a block of d distinct rows costs O(d log m), not
O(d * m).
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

import numpy as np

Row = Tuple[int, ...]


class SpaceSaving:
    """Bounded weighted summary over fixed-width uint32 value rows."""

    def __init__(self, capacity: int, n_cols: int):
        if capacity < 1:
            raise ValueError("capacity >= 1 required")
        self.capacity = int(capacity)
        self.n_cols = int(n_cols)
        self._count: Dict[Row, float] = {}
        self._err: Dict[Row, float] = {}
        self._heap: List[Tuple[float, Row]] = []   # lazy: may hold stale counts

    def __len__(self) -> int:
        return len(self._count)

    def offer(self, values: np.ndarray, freqs: np.ndarray | None = None) -> None:
        """Fold a block of value rows with weights into the summary."""
        values = np.asarray(values, dtype=np.uint32)
        if values.ndim != 2 or values.shape[1] != self.n_cols:
            raise ValueError(f"values must be [N, {self.n_cols}]")
        if values.shape[0] == 0:
            return
        if freqs is None:
            freqs = np.ones(values.shape[0], dtype=np.int64)
        freqs = np.asarray(freqs, dtype=np.float64)
        # aggregate the block first: one summary op per *distinct* row
        uniq, inv = np.unique(values, axis=0, return_inverse=True)
        tot = np.bincount(inv.reshape(-1), weights=freqs)
        for row, f in zip(uniq.tolist(), tot.tolist()):
            if f <= 0:
                continue  # zero-weight pad rows are not observations
            self._insert(tuple(row), float(f))

    def _pop_min(self) -> Tuple[float, Row]:
        """Pop the live minimum-count entry, discarding stale heap entries."""
        while True:
            c, row = heapq.heappop(self._heap)
            if self._count.get(row) == c:
                return c, row

    def _insert(self, row: Row, f: float) -> None:
        if row in self._count:
            self._count[row] += f
        elif len(self._count) < self.capacity:
            self._count[row] = f
            self._err[row] = 0.0
        else:
            floor, victim = self._pop_min()
            del self._count[victim]
            del self._err[victim]
            self._count[row] = floor + f
            self._err[row] = floor
        heapq.heappush(self._heap, (self._count[row], row))
        if len(self._heap) > 4 * self.capacity:
            self._compact_heap()

    def _compact_heap(self) -> None:
        """Drop stale entries (bounds the heap at O(capacity) regardless of
        how many increments long-lived hot rows accumulate)."""
        self._heap = [(c, r) for r, c in self._count.items()]
        heapq.heapify(self._heap)

    def values(self) -> np.ndarray:
        """All summarized rows: uint32[K, n_cols] (admission order arbitrary)."""
        if not self._count:
            return np.zeros((0, self.n_cols), dtype=np.uint32)
        return np.asarray(list(self._count), dtype=np.uint32)

    def counts(self) -> Dict[Row, float]:
        return dict(self._count)

    # -- durable state (serving/recovery.py snapshot currency) --------------

    def state_dict(self) -> Dict[str, np.ndarray]:
        """The summary as three flat arrays: rows / counts / errs.

        Row order is the dict's insertion order, which matters: the plain
        endpoint feeds ``values()`` to the descent unsorted, so a restore
        that permuted rows could permute top-k tie order.  ``load_state``
        re-inserts in the same order, making the round trip bit-exact --
        including all later evictions, which depend only on dict contents
        and order."""
        rows = self.values()
        return {
            "rows": rows,
            "counts": np.asarray([self._count[tuple(r)] for r in rows.tolist()],
                                 dtype=np.float64),
            "errs": np.asarray([self._err[tuple(r)] for r in rows.tolist()],
                               dtype=np.float64),
        }

    def load_state(self, rows: np.ndarray, counts: np.ndarray,
                   errs: np.ndarray) -> None:
        """Restore a summary saved by :meth:`state_dict` (same capacity/width).

        Overwrites the current contents wholesale; the rebuilt heap is the
        compacted form of the loaded counts, so eviction behaviour after a
        restore is identical to the uninterrupted summary's."""
        rows = np.asarray(rows, dtype=np.uint32)
        if rows.ndim != 2 or rows.shape[1] != self.n_cols:
            raise ValueError(f"rows must be [K, {self.n_cols}]")
        if rows.shape[0] > self.capacity:
            raise ValueError(
                f"loaded summary has {rows.shape[0]} rows but capacity is "
                f"{self.capacity}: capacity must match the saved summary")
        counts = np.asarray(counts, dtype=np.float64)
        errs = np.asarray(errs, dtype=np.float64)
        self._count = {tuple(r): float(c)
                       for r, c in zip(rows.tolist(), counts.tolist())}
        self._err = {tuple(r): float(e)
                     for r, e in zip(rows.tolist(), errs.tolist())}
        self._compact_heap()

    @classmethod
    def fold(cls, summaries: List["SpaceSaving"]) -> "SpaceSaving":
        """Fold shard summaries into one fresh summary (cross-shard cascade).

        Capacity and width come from the first summary; each shard is
        folded in with :meth:`merge_from`, so the result carries the
        mergeable-summaries guarantees: counts upper-bound true weights and
        the inherited error is at most the sum of the shards' floors (each
        <= W_i / m).  When every shard is under capacity the fold is exact
        -- counts are plain sums and no row is lost -- which is what makes
        the sharded serving candidate pools shard-count invariant below
        capacity (serving/sharded_topk.py)."""
        summaries = list(summaries)
        if not summaries:
            raise ValueError("fold requires at least one summary")
        out = cls(summaries[0].capacity, summaries[0].n_cols)
        for s in summaries:
            out.merge_from(s)
        return out

    def merge_from(self, other: "SpaceSaving") -> None:
        """Fold another summary in (cross-shard candidate merge).

        Mergeable-summaries rule (Agarwal et al. 2012): a row absent from
        one side contributes that side's min count when the side is at
        capacity (its worst-case possible count there -- the row may have
        been evicted with up to that much mass) and 0 when the side is
        under capacity (absent then means truly unseen).  The union is
        truncated back to capacity keeping the largest counts.  This
        preserves count(v) >= true(v) for every retained row, so a value
        heavy on either shard still out-ranks light entries in the merged
        summary; the error bound grows to the sum of the two floors.
        """
        if other.n_cols != self.n_cols:
            raise ValueError("cannot merge summaries of different widths")
        m_self = (min(self._count.values())
                  if len(self._count) >= self.capacity else 0.0)
        m_other = (min(other._count.values())
                   if len(other._count) >= other.capacity else 0.0)
        count, err = {}, {}
        for row in set(self._count) | set(other._count):
            cs, co = self._count.get(row), other._count.get(row)
            count[row] = ((cs if cs is not None else m_self)
                          + (co if co is not None else m_other))
            err[row] = ((self._err[row] if cs is not None else m_self)
                        + (other._err[row] if co is not None else m_other))
        if len(count) > self.capacity:
            keep = sorted(count, key=count.__getitem__,
                          reverse=True)[: self.capacity]
            count = {r: count[r] for r in keep}
            err = {r: err[r] for r in keep}
        self._count, self._err = count, err
        self._compact_heap()
