"""The composite Carter-Wegman hash of the paper (arXiv:1808.06800, Eq. 1),
worked out plainly in int64.

A key of modules ``x = (x_0, .., x_{n-1})`` is cut into 16-bit digits,
each module into ``ceil(bits(domain - 1) / 16)`` of them, least
significant first, module after module.  Group j of the partition hashes
its modules' digits:

    H_j(x) = ((r_j + sum_c q_c * digit_c) mod (2^31 - 1)) mod range_j

with one (q, r) per sketch row, and a row's cell is the mixed-radix
number ``sum_j H_j(x) * prod(range_{j+1..})``.  Every term is below 2^47
and a key has at most 64 digits, so the sum stays below 2^53.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

P31 = (1 << 31) - 1


def digits_per_module(domains: Sequence[int]) -> List[int]:
    return [max(1, ((int(d) - 1).bit_length() + 15) // 16) for d in domains]


def digits(keys: torch.Tensor, domains: Sequence[int]) -> torch.Tensor:
    """int64 [..., n_modules] module values -> int64 [..., n_digits]."""
    cols = []
    for m, nd in enumerate(digits_per_module(domains)):
        for c in range(nd):
            cols.append((keys[..., m] >> (16 * c)) & 0xFFFF)
    return torch.stack(cols, dim=-1)


def group_columns(domains: Sequence[int], partition) -> List[List[int]]:
    """The digit columns of each group, in the group's module order."""
    per = digits_per_module(domains)
    start = [sum(per[:m]) for m in range(len(per))]
    return [[start[m] + c for m in group for c in range(per[m])] for group in partition]


def group_hash(dig: torch.Tensor, q: torch.Tensor, r: torch.Tensor, cols: List[int],
               j: int) -> torch.Tensor:
    """The CW hash of group j for every row: int64 [w, B] in [0, P31).
    ``dig`` int64 [B, n_digits]; q int64 [w, n_digits]; r int64 [w, n_groups]."""
    acc = (dig[None, :, cols] * q[:, None, cols]).sum(dim=-1) + r[:, j, None]
    return acc % P31


def cells(keys: torch.Tensor, q: torch.Tensor, r: torch.Tensor, domains, partition,
          ranges) -> torch.Tensor:
    """Every row's cell of every key: int64 [w, B]."""
    dig = digits(keys, domains)
    idx = torch.zeros((q.shape[0], keys.shape[0]), dtype=torch.int64, device=keys.device)
    stride = 1
    for r_j in ranges:
        stride *= int(r_j)
    for j, cols in enumerate(group_columns(domains, partition)):
        stride //= int(ranges[j])
        idx += (group_hash(dig, q, r, cols, j) % int(ranges[j])) * stride
    return idx
