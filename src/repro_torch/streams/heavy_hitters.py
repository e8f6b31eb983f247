"""Heavy-hitter workloads + exact ground truth for the hierarchy subsystem.

Port of ``repro/streams/heavy_hitters.py`` (numpy).  Two workload
families:

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
from repro_torch.streams.ngram import ngram_items_np, ngram_schema
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


def ngram_hh_workload(
    vocab_size: int = 512,
    n: int = 2,
    n_sequences: int = 64,
    seq_len: int = 256,
    phi: float = 0.002,
    s: float = 1.2,
    seed: int = 0,
) -> HHWorkload:
    """Token n-gram stream: Zipf(s) unigram marginal, report heavy n-grams.

    The compressed stream's keys are modularity-n over [0, vocab_size); a
    hierarchy over the per-token partition prunes by prefix (n-1)-gram mass.
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64) ** (-s)
    p = ranks / ranks.sum()
    toks = rng.choice(vocab_size, size=(n_sequences, seq_len), p=p)
    grams = ngram_items_np(toks.astype(np.uint32), n)
    uniq, inv = np.unique(grams, axis=0, return_inverse=True)
    freqs = np.bincount(inv).astype(np.int64)
    stream = Stream(schema=ngram_schema(vocab_size, n), items=uniq,
                    freqs=freqs, name=f"{n}gram-hh(V={vocab_size})")
    threshold = max(1, int(phi * stream.total))
    ei, ef = exact_heavy_hitters(stream.items, stream.freqs, threshold)
    return HHWorkload(stream=stream, threshold=threshold,
                      exact_items=ei, exact_freqs=ef)
