"""Pairwise-independent modular hashing (paper Eq. 1, generalized).

Port of ``repro/core/hashing.py``.  The family is the Carter-Wegman vector
hash over the 16-bit chunks of a domain-aware packed key::

    H(x) = ((r + sum_c q_c * x_c) mod P) mod range,     P = 2^31 - 1

with ``q_c, r`` uniform in ``[0, P)``.  The reference evaluates it in uint32
limbs (TPU Pallas has no 64-bit lanes).  torch's CPU kernels cannot shift
uint32 tensors, so the port evaluates it in int64 with the semantics of the
numpy oracle :func:`cw_hash_np`: every term ``q_c * x_c`` is below 2^47 and
up to 64 of them sum below 2^53, so one final ``% P31`` is exact.  The two
forms agree bit for bit because they are equal mod P31.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

P31 = np.uint32((1 << 31) - 1)  # Mersenne prime 2^31 - 1


def cw_hash(chunks: torch.Tensor, q: torch.Tensor, r) -> torch.Tensor:
    """Carter-Wegman vector hash in int64.

    chunks: int64[..., C] with each value < 2^16
    q:      int64[C] multipliers < P31 (or any shape broadcasting against
            ``chunks``)
    r:      offset(s) < P31 broadcasting against ``chunks.shape[:-1]``
    returns int64[...] in [0, P31)
    """
    acc = (q * chunks).sum(dim=-1) + r
    return acc % int(P31)


def cw_hash_np(chunks: np.ndarray, q: np.ndarray, r: int | np.ndarray) -> np.ndarray:
    """Oracle: same hash with plain uint64 arithmetic.

    q*x < 2^31 * 2^16 = 2^47 per term; <= 64 chunk terms keeps the sum < 2^53,
    far below uint64 overflow, so a single final ``% P`` suffices.
    """
    chunks = chunks.astype(np.uint64)
    q = q.astype(np.uint64)
    acc = np.full(chunks.shape[:-1], np.uint64(r), dtype=np.uint64)
    for c in range(chunks.shape[-1]):
        acc = acc + q[c] * chunks[..., c]
    return (acc % np.uint64(P31)).astype(np.uint32)


# --------------------------------------------------------------------------
# Key schema: module domains -> 16-bit chunk layout
# --------------------------------------------------------------------------

def _chunks_for_domain(domain: int) -> int:
    """Number of 16-bit chunks needed for values in [0, domain)."""
    if domain < 2:
        return 1
    bits = int(domain - 1).bit_length()
    return (bits + 15) // 16


@dataclasses.dataclass(frozen=True)
class KeySchema:
    """Domains of the ordered modules of an item key (paper SIII).

    ``domains[i]`` is the size of module i's value set; module values are
    in ``[0, domains[i])``.  Packing a *group* of modules is the
    concatenation of each member's fixed-width 16-bit digit vector.  Same
    class and field names as the reference, so spec ``repr``s (and with
    them state fingerprints) agree across the two packages.
    """
    domains: Tuple[int, ...]

    def __post_init__(self):
        if not self.domains:
            raise ValueError("KeySchema needs at least one module")
        for d in self.domains:
            if not (2 <= d <= 1 << 32):
                raise ValueError(f"module domain {d} out of [2, 2^32]")

    @property
    def modularity(self) -> int:
        return len(self.domains)

    @property
    def chunk_counts(self) -> Tuple[int, ...]:
        return tuple(_chunks_for_domain(d) for d in self.domains)

    def module_chunks_np(self, items: np.ndarray) -> np.ndarray:
        """uint32[N, n_modules] -> uint32[N, total_chunks] of 16-bit digits."""
        cols = []
        for m, nc in enumerate(self.chunk_counts):
            v = items[..., m].astype(np.uint64)
            for c in range(nc):
                cols.append(((v >> np.uint64(16 * c)) & np.uint64(0xFFFF)).astype(np.uint32))
        return np.stack(cols, axis=-1)

    def module_chunks(self, items: torch.Tensor) -> torch.Tensor:
        """torch version of :meth:`module_chunks_np`: int64[..., n_modules]
        module values -> int64[..., total_chunks] 16-bit digits."""
        cols = []
        for m, nc in enumerate(self.chunk_counts):
            v = items[..., m]
            for c in range(nc):
                cols.append((v >> (16 * c)) & 0xFFFF)
        return torch.stack(cols, dim=-1)

    def chunk_slice(self, module: int) -> Tuple[int, int]:
        """(start, stop) of module's chunks in the full chunk vector."""
        start = sum(self.chunk_counts[:module])
        return start, start + self.chunk_counts[module]

    @property
    def total_chunks(self) -> int:
        return sum(self.chunk_counts)


def draw_hash_params(generator: torch.Generator, shape: Sequence[int],
                     device: DeviceLike = None) -> torch.Tensor:
    """Uniform multipliers/offsets in [0, P31) as int64 on ``device``.

    Drawn on the generator's own device, then moved.  A torch generator
    cannot reproduce a ``jax.random`` draw: to share params with the
    reference, draw with :func:`draw_hash_params_np` and hand the arrays to
    both packages."""
    device = resolve_device(device)
    v = torch.randint(0, int(P31), tuple(shape), generator=generator,
                      dtype=torch.int64, device=generator.device)
    return v.to(device)


def draw_hash_params_np(rng: np.random.Generator, shape: Sequence[int]) -> np.ndarray:
    return rng.integers(0, int(P31), size=tuple(shape), dtype=np.int64).astype(np.uint32)
