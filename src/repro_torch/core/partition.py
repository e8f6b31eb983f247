"""Module-combination partitions and Bell numbers (paper Thm 6, Table I).

Port of ``repro/core/partition.py`` (pure Python, kept as the port's own
copy so the port imports nothing of the JAX package)."""
from __future__ import annotations

from functools import lru_cache
from math import comb
from typing import Iterator, List, Sequence, Tuple


@lru_cache(maxsize=None)
def bell_number(n: int) -> int:
    """T(n): #ways to combine the modules of a modularity-n key (Thm 6).

    T(n) = sum_{k=0}^{n-1} C(n-1, k) * T(n-k-1),  T(0) = T(1) = 1.
    """
    if n < 0:
        raise ValueError("n >= 0 required")
    if n <= 1:
        return 1
    return sum(comb(n - 1, k) * bell_number(n - k - 1) for k in range(n))


def all_partitions(modules: Sequence[int]) -> Iterator[Tuple[Tuple[int, ...], ...]]:
    """Enumerate every set partition of ``modules`` in canonical form.

    Canonical form: elements sorted within groups, groups sorted by their
    smallest element.  Count equals ``bell_number(len(modules))``.
    """
    modules = list(modules)
    if not modules:
        yield ()
        return
    first, rest = modules[0], modules[1:]
    for sub in all_partitions(rest):
        # put `first` into its own group
        yield tuple(sorted([(first,)] + list(sub), key=lambda g: g[0]))
        # or into each existing group
        for gi in range(len(sub)):
            groups: List[Tuple[int, ...]] = [
                tuple(sorted(g + (first,))) if i == gi else g for i, g in enumerate(sub)
            ]
            yield tuple(sorted(groups, key=lambda g: g[0]))


def canonical(partition: Sequence[Sequence[int]]) -> Tuple[Tuple[int, ...], ...]:
    return tuple(sorted((tuple(sorted(g)) for g in partition), key=lambda g: g[0]))
