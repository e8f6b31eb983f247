"""Heavy-hitter workloads + exact ground truth for the hierarchy subsystem.

Port of ``repro/streams/heavy_hitters.py`` (numpy).  This slice carries the
zipf edge workload; the n-gram workload arrives with the stream slice
(ROADMAP item 8).  The reference has two workload families:

  * ``zipf_hh_workload`` -- the Twitter/CAIDA-like edge streams already used
    for point queries, re-cut as threshold reporting: which edges carry at
    least a phi-fraction of the stream?
  * ``ngram_hh_workload`` -- the LM-framework angle: which n-grams dominate
    a token stream?  (An n-gram key is modularity-n over the vocabulary; the
    hierarchy prunes by (n-1)-gram prefix mass.)

Both return a :class:`HHWorkload` bundling the stream, a threshold, the
exact answer (for tests/benchmarks), and per-group candidate sets -- the
value combos the descent may extend prefixes with.  Candidates from
``group_candidates`` are the distinct observed group values, which makes
the no-false-negative guarantee unconditional on these streams.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core.sketch import SketchSpec
from repro_torch.streams.synthetic import Stream, zipf_graph_stream


def exact_heavy_hitters(
    items: np.ndarray, freqs: np.ndarray, threshold: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Ground truth: distinct keys with total frequency >= threshold,
    sorted by frequency descending."""
    uniq, inv = np.unique(np.asarray(items), axis=0, return_inverse=True)
    tot = np.bincount(inv, weights=np.asarray(freqs, dtype=np.float64))
    keep = tot >= threshold
    uniq, tot = uniq[keep], tot[keep].astype(np.int64)
    order = np.argsort(-tot, kind="stable")
    return uniq[order], tot[order]


def group_candidates(spec: SketchSpec, items: np.ndarray) -> List[np.ndarray]:
    """Distinct observed value-combos per partition group, in group order.

    candidates[j]: uint32[C_j, len(g_j)] -- exactly the shape
    core.hierarchy.find_heavy_hitters expects.  Using observed values keeps
    the candidate sets exact (every true heavy hitter is reachable).
    """
    items = np.asarray(items, dtype=np.uint32)
    return [np.unique(items[:, list(g)], axis=0) for g in spec.partition]


@dataclasses.dataclass
class HHWorkload:
    """A stream plus everything a heavy-hitter evaluation needs."""
    stream: Stream
    threshold: int
    exact_items: np.ndarray    # uint32[K, n_modules], schema order
    exact_freqs: np.ndarray    # int64[K]

    def candidates(self, spec: SketchSpec) -> List[np.ndarray]:
        return group_candidates(spec, self.stream.items)


def zipf_hh_workload(
    phi: float = 0.002,
    n_src: int = 2_000,
    n_tgt: int = 4_000,
    n_edges: int = 20_000,
    n_occurrences: int = 100_000,
    s: float = 1.1,
    seed: int = 0,
) -> HHWorkload:
    """Edge stream with Zipf(s) marginals; report edges >= phi * L."""
    stream = zipf_graph_stream(n_src=n_src, n_tgt=n_tgt, n_edges=n_edges,
                               n_occurrences=n_occurrences, s_src=s, s_tgt=s,
                               seed=seed, name=f"zipf-hh(s={s})")
    threshold = max(1, int(phi * stream.total))
    ei, ef = exact_heavy_hitters(stream.items, stream.freqs, threshold)
    return HHWorkload(stream=stream, threshold=threshold,
                      exact_items=ei, exact_freqs=ef)
