"""Synthetic stream generators matched to the paper's datasets (SVI-A1).

Port of ``repro/streams/synthetic.py`` (numpy, with the port's own
``KeySchema``): every generator draws exactly the reference's arrays.

The raw Twitter/CAIDA traces are not redistributable offline, so we generate
streams with the same *structure*: modular keys, Zipf-skewed frequencies, and
asymmetric module marginals.  Calibration targets (Tables II/III):

  * Twitter  (mod 2): #targets ~ 3.1x #sources, max freq ~ 17K, L ~ 151M
  * IPv4-1   (mod 2): #sources ~ 10.9x #targets (7.23M vs 0.67M), L ~ 6.2G
  * IPv4#4 / IPv4#8: the same pairs viewed as 16-bit / 8-bit words

Scales are configurable so benchmarks run on one CPU core; structure (skew
direction and modularity) is what the paper's claims depend on.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core.hashing import KeySchema


@dataclasses.dataclass
class Stream:
    """A weighted (compressed) stream: distinct items + frequencies.

    A p-fraction *uniform occurrence sample* of the flat stream is drawn per
    item as Binomial(freq, p) -- exactly the distribution a uniform sample of
    the expanded stream would have (see :meth:`sample`).
    """
    schema: KeySchema
    items: np.ndarray       # uint32[N, n_modules], distinct
    freqs: np.ndarray       # int64[N]
    name: str = "stream"

    @property
    def total(self) -> int:
        return int(self.freqs.sum())

    def sample(self, fraction: float, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        """Uniform sample of stream occurrences (paper's 2-4% sample)."""
        cnt = rng.binomial(self.freqs.astype(np.int64), fraction)
        keep = cnt > 0
        return self.items[keep], cnt[keep]

    def top_k_queries(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        idx = np.argsort(-self.freqs)[:k]
        return self.items[idx], self.freqs[idx]

    def random_k_queries(self, k: int, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        idx = rng.choice(len(self.freqs), size=min(k, len(self.freqs)), replace=False)
        return self.items[idx], self.freqs[idx]


def _zipf_values(n_distinct: int, n_draws: int, s: float, rng: np.random.Generator) -> np.ndarray:
    """n_draws values in [0, n_distinct) with Zipf(s) head-heavy skew."""
    ranks = np.arange(1, n_distinct + 1, dtype=np.float64)
    p = ranks ** (-s)
    p /= p.sum()
    return rng.choice(n_distinct, size=n_draws, p=p)


def zipf_graph_stream(
    n_src: int = 20_000,
    n_tgt: int = 60_000,
    n_edges: int = 200_000,
    n_occurrences: int = 2_000_000,
    s_src: float = 1.1,
    s_tgt: float = 1.1,
    seed: int = 0,
    name: str = "twitter-like",
) -> Stream:
    """Directed-edge stream with asymmetric node marginals (Twitter-like).

    Node ids are randomly embedded in [0, 2^32) so hashing sees realistic
    key magnitudes.  With n_tgt > n_src the per-item alpha = O(src,*)/O(*,tgt)
    is typically > 1 => optimal b > a, matching the paper's Twitter finding.
    """
    rng = np.random.default_rng(seed)
    src = _zipf_values(n_src, n_edges, s_src, rng)
    tgt = _zipf_values(n_tgt, n_edges, s_tgt, rng)
    # random id embedding
    src_ids = rng.choice(np.uint32(0xFFFFFFFF), size=n_src, replace=False).astype(np.uint32)
    tgt_ids = rng.choice(np.uint32(0xFFFFFFFF), size=n_tgt, replace=False).astype(np.uint32)
    edges = np.stack([src_ids[src], tgt_ids[tgt]], axis=1)
    uniq, inv = np.unique(edges, axis=0, return_counts=False, return_inverse=True)
    # Zipf edge frequencies on top of edge multiplicity
    mult = np.bincount(inv)
    f = mult.astype(np.float64)
    f = f / f.sum()
    freqs = rng.multinomial(n_occurrences, f).astype(np.int64)
    keep = freqs > 0
    schema = KeySchema(domains=(1 << 32, 1 << 32))
    return Stream(schema=schema, items=uniq[keep].astype(np.uint32), freqs=freqs[keep], name=name)


def ipv4_stream(
    n_src_hosts: int = 40_000,
    n_tgt_hosts: int = 4_000,
    n_pairs: int = 150_000,
    n_occurrences: int = 3_000_000,
    s: float = 1.2,
    seed: int = 1,
    name: str = "ipv4-like",
) -> Stream:
    """(src_ip, dst_ip) pair stream; #sources >> #targets like CAIDA probing."""
    rng = np.random.default_rng(seed)
    src_hosts = rng.integers(0, 1 << 32, size=n_src_hosts, dtype=np.uint64).astype(np.uint32)
    tgt_hosts = rng.integers(0, 1 << 32, size=n_tgt_hosts, dtype=np.uint64).astype(np.uint32)
    src = src_hosts[_zipf_values(n_src_hosts, n_pairs, s, rng)]
    tgt = tgt_hosts[_zipf_values(n_tgt_hosts, n_pairs, 0.8, rng)]
    pairs = np.stack([src, tgt], axis=1)
    uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
    mult = np.bincount(inv).astype(np.float64)
    freqs = rng.multinomial(n_occurrences, mult / mult.sum()).astype(np.int64)
    keep = freqs > 0
    schema = KeySchema(domains=(1 << 32, 1 << 32))
    return Stream(schema=schema, items=uniq[keep].astype(np.uint32), freqs=freqs[keep], name=name)


def reinterpret_modularity(stream: Stream, words: int) -> Stream:
    """View a modularity-2 (two 32-bit modules) stream at higher modularity.

    words=4: 16-bit words (IPv4#4 analogue); words=8: 8-bit words (IPv4#8).
    This mirrors how the paper derives #4/#8 datasets from the same trace.
    """
    if stream.schema.domains != (1 << 32, 1 << 32):
        raise ValueError("expects a two x 32-bit stream")
    if words not in (4, 8):
        raise ValueError("words must be 4 or 8")
    bits = 64 // words
    mask = (1 << bits) - 1
    packed = (stream.items[:, 0].astype(np.uint64) << np.uint64(32)) | stream.items[:, 1].astype(np.uint64)
    cols = [((packed >> np.uint64(bits * (words - 1 - i))) & np.uint64(mask)).astype(np.uint32)
            for i in range(words)]
    items = np.stack(cols, axis=1)
    schema = KeySchema(domains=(1 << bits,) * words)
    return Stream(schema=schema, items=items, freqs=stream.freqs.copy(),
                  name=f"{stream.name}#{words}")


def telecom_stream(
    n_users: int = 30_000,
    n_calls: int = 120_000,
    seed: int = 3,
) -> Stream:
    """(caller, callee, duration_s) stream -- the paper's SIII example of
    arbitrary positive per-tuple counts (seconds of conversation)."""
    rng = np.random.default_rng(seed)
    a = _zipf_values(n_users, n_calls, 1.05, rng).astype(np.uint32)
    b = rng.integers(0, n_users, size=n_calls, dtype=np.int64).astype(np.uint32)
    pairs = np.stack([a, b], axis=1)
    uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
    dur = rng.exponential(180.0, size=n_calls).astype(np.int64) + 1
    freqs = np.bincount(inv, weights=dur.astype(np.float64)).astype(np.int64)
    schema = KeySchema(domains=(n_users, n_users))
    return Stream(schema=schema, items=uniq, freqs=freqs, name="telecom-like")
