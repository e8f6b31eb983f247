"""Blocks of a directed-edge stream with Zipf-skewed node marginals, the
structure of the paper's Twitter stream (arXiv:1808.06800 SVI-A1; the
calibration recorded in the port's ``streams/synthetic.py``: random
32-bit node ids, #targets about 3.1x #sources, Zipf marginals, edge
frequencies drawn in proportion to the edges' multiplicities).

Made on the card with torch in a few large calls, then held in host
memory as a collector would hand blocks over.  Steps 1-4 draw from the
traffic's fixed ``stream_seed``, so every run sees the same edges and the
same arrivals; the run's seed draws their order (step 4) and the rows'
order in a block (step 6), so that seeds change the order of the work and
not its amount:

1. ``n_edges`` draws of a source and a target from Zipf(s) over ranks;
2. distinct random 32-bit ids for the sources and the targets;
3. the distinct (src, dst) pairs and their multiplicities;
4. ``n_occurrences`` arrivals, each an edge drawn in proportion to its
   multiplicity, in an order drawn from the run's seed: one pass of the
   stream;
5. the pass cut, in arrival order, into intervals that each hold exactly
   ``block_rows`` distinct edges (an interval ends where the next arrival
   would bring a new edge past that), and each interval aggregated into
   a block of its distinct edges with their counts, as a collector hands
   over an interval;
6. the first ``pool_blocks`` blocks kept (the pass's arrivals after them
   are dropped, so that every seed gives the same sizes); within a block
   the rows are in an order drawn from the seed (``random``) or sorted by
   source, then target (``source``).

Traffic parameters (the traffic file): ``stream_seed``, ``block_rows``,
``pool_blocks``, ``order``.  Configuration parameters (top-level keys of the
configuration): ``n_src``, ``n_tgt``, ``n_edges``, ``n_occurrences``,
``s_src``, ``s_tgt``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

ID_SPACE = (1 << 32) - 1


def _draw(weights: torch.Tensor, n: int, g: torch.Generator) -> torch.Tensor:
    """n indices drawn with replacement in proportion to ``weights``
    (float64), by the inverse of their cumulative sum."""
    cdf = torch.cumsum(weights, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(n, generator=g, dtype=torch.float64, device=g.device)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=weights.numel() - 1)


def _zipf_draws(n: int, draws: int, s: float, g: torch.Generator) -> torch.Tensor:
    ranks = torch.arange(1, n + 1, dtype=torch.float64, device=g.device)
    return _draw(ranks.pow(-s), draws, g)


def _distinct_ids(n: int, g: torch.Generator) -> torch.Tensor:
    """n distinct ids in [0, 2^32 - 1), in an order drawn from ``g``."""
    extra = n // 64 + 64
    ids = torch.unique(torch.randint(0, ID_SPACE, (n + extra,), generator=g,
                                     dtype=torch.int64, device=g.device))
    if ids.numel() < n:
        raise RuntimeError("too few distinct node ids drawn")
    return ids[torch.randperm(ids.numel(), generator=g, device=g.device)[:n]]


def one_pass(stream: dict, g: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """(edges int64 [E] as src << 32 | dst, sorted; arrivals int64 [L],
    each an index into ``edges``, in stream order), on ``g``'s device."""
    src = _zipf_draws(stream["n_src"], stream["n_edges"], stream["s_src"], g)
    tgt = _zipf_draws(stream["n_tgt"], stream["n_edges"], stream["s_tgt"], g)
    src_ids = _distinct_ids(stream["n_src"], g)
    tgt_ids = _distinct_ids(stream["n_tgt"], g)
    packed = (src_ids[src] << 32) | tgt_ids[tgt]
    del src, tgt
    edges, mult = torch.unique(packed, return_counts=True)
    del packed
    arrivals = _draw(mult.to(torch.float64), int(stream["n_occurrences"]), g)
    return edges, arrivals


def interval_ends(arrivals: torch.Tensor, rows: int, blocks: int) -> torch.Tensor:
    """Ends (exclusive, int64 [blocks]) of the first ``blocks`` intervals of
    the arrival sequence that each hold exactly ``rows`` distinct values,
    cut greedily from the start."""
    n = arrivals.numel()
    order = torch.argsort(arrivals, stable=True)
    same = arrivals[order[1:]] == arrivals[order[:-1]]
    prev = torch.full((n,), -1, dtype=torch.int64, device=arrivals.device)
    prev[order[1:]] = torch.where(same, order[:-1], -1)
    del order, same
    ends, s, span = [], 0, 4 * rows
    while len(ends) < blocks:
        # an arrival is new to the interval that starts at s when the
        # previous arrival of its value lies before s
        new = torch.cumsum(prev[s : s + span] < s, 0)
        if int(new[-1]) <= rows:
            if s + span >= n:
                raise RuntimeError(f"a pass holds {len(ends)} blocks of {rows} distinct "
                                   f"edges, fewer than {blocks}")
            span *= 2
            continue
        e = s + int(torch.searchsorted(new, rows + 1))
        ends.append(e)
        s = e
    return torch.tensor(ends, dtype=torch.int64, device=arrivals.device)


def pool(stream: dict, traffic: dict, seed: int, device: str) -> Dict[str, object]:
    """The pool on the device: ``edges`` [blocks, rows] (indices into
    ``edge_keys``), ``counts`` [blocks, rows], ``edge_keys`` [E, 2], and
    ``arrivals``, the pass's arrivals that the pool holds."""
    g = torch.Generator(device=device).manual_seed(int(traffic["stream_seed"]))
    edges, arrivals = one_pass(stream, g)
    g.manual_seed(seed)
    arrivals = arrivals[torch.randperm(arrivals.numel(), generator=g, device=g.device)]
    rows, blocks = int(traffic["block_rows"]), int(traffic["pool_blocks"])
    ends = interval_ends(arrivals, rows, blocks)
    kept = arrivals[: int(ends[-1])]
    del arrivals
    interval = torch.searchsorted(ends, torch.arange(kept.numel(), device=kept.device),
                                  right=True)
    ids, counts = torch.unique(interval * edges.numel() + kept, return_counts=True)
    del interval
    if ids.numel() != rows * blocks:
        raise RuntimeError("an interval does not hold block_rows distinct edges")
    edge = (ids % edges.numel()).reshape(blocks, rows)
    counts = counts.reshape(blocks, rows)
    if traffic["order"] == "random":
        draw = torch.rand((blocks, rows), generator=g, dtype=torch.float64, device=g.device)
    elif traffic["order"] == "source":   # the keys as unsigned numbers: the sign bit flipped
        draw = edges[edge] ^ torch.iinfo(torch.int64).min
    else:
        raise ValueError(f"unknown order {traffic['order']!r}")
    shuffle = torch.argsort(draw, dim=1, stable=True)
    edge, counts = edge.gather(1, shuffle), counts.gather(1, shuffle)
    keys = torch.stack([(edges >> 32) & 0xFFFFFFFF, edges & 0xFFFFFFFF], dim=1)
    return {"edges": edge, "counts": counts, "edge_keys": keys, "arrivals": kept.numel()}


def generate(stream: dict, traffic: dict, seed: int,
             device: str) -> Tuple[np.ndarray, np.ndarray]:
    """The pool: keys uint32 [pool_blocks, block_rows, 2] and counts int64
    [pool_blocks, block_rows], in host memory."""
    p = pool(stream, traffic, seed, device)
    keys = p["edge_keys"][p["edges"]].to(torch.int32).cpu().numpy().view(np.uint32)
    return np.ascontiguousarray(keys), np.ascontiguousarray(p["counts"].cpu().numpy())
