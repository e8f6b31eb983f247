"""The conservative (Estan-Varghese) update, folded exactly in stream order.

One item b with frequency f, over the w rows of the table:

    cur_k = T[k, cell_k(b)];  est = min_k cur_k + f;  T[k, cell_k(b)] = max(cur_k, est)

``fold_serial_`` gives the per-item loop's table without walking the
stream item by item: in each round every remaining item that comes first,
among the remaining items, in each of its w cells is folded at once
(:func:`schedule`).  Those items touch pairwise disjoint cells, and every
cell still sees its writers in stream order, so each reads what the
per-item loop would have read.  The rounds number the stream's dependency
depth, not its length.  ``fold_per_item_`` is the loop itself, for small
tests.

int32 tables follow int32 arithmetic: ``min + f`` wraps past 2^31 - 1;
an int64 table does not wrap, so a fold held against one shows a wrap.

``fold_block_parallel_`` is the control: each block's items all read the
table as it stood before the block and write the max of their estimates.
It breaks the guarantee that the estimates are the serial fold's.
"""
from __future__ import annotations

from typing import List, Optional

import torch


def _estimates(cur: torch.Tensor, f: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    low = cur.min(dim=0).values
    if dtype.is_floating_point:
        return low + f.to(dtype)
    return (low.to(torch.int64) + f.to(torch.int64)).to(dtype)   # wraps as int32 does


def fold_per_item_(table: torch.Tensor, cells: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """The serial fold, one item at a time (``cells`` int64 [w, B])."""
    rows = torch.arange(table.shape[0], device=table.device)
    for b in range(cells.shape[1]):
        cur = table[rows, cells[:, b]]
        est = _estimates(cur[:, None], freqs[b : b + 1], table.dtype)
        table[rows, cells[:, b]] = torch.maximum(cur, est)
    return table


def schedule(cells: torch.Tensor, sync_every: int = 4,
             first: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """The rounds of a unit (``cells`` int64 [w, n]): index tensors of the
    items folded in each round, each item in the first round in which it
    comes first, among the items not yet folded, in every one of its
    cells.  The items of a round touch pairwise disjoint cells, and every
    cell sees its items in stream order, so folding the rounds in turn is
    the per-item fold.  The rounds depend on the cells alone, not on the
    table, so a unit that recurs (the same blocks in the same order) reuses
    them.  The host checks every ``sync_every`` rounds whether any item is
    left.  ``first``, int32 [w, > max cell] filled with the int32 maximum,
    is scratch that a caller may hand every call: it is left as found."""
    w, n = cells.shape
    sentinel = torch.iinfo(torch.int32).max
    if n >= sentinel:
        raise ValueError("a unit holds too many items")
    if first is None:
        first = torch.full((w, int(cells.max()) + 1), sentinel, dtype=torch.int32,
                           device=cells.device)
    rounds: List[torch.Tensor] = []
    rem = torch.arange(n, device=cells.device)
    while rem.numel():
        c, pos = cells[:, rem], rem.to(torch.int32)
        done = torch.zeros_like(rem, dtype=torch.bool)
        for _ in range(sync_every):
            live = torch.where(done, sentinel, pos).expand(w, -1)
            first.scatter_reduce_(1, c, live, "amin")
            ready = (first.gather(1, c) == live).all(dim=0) & ~done
            first.scatter_(1, c, sentinel)
            rounds.append(ready)
            done |= ready
        rounds[-sync_every:] = [rem[r.nonzero().squeeze(1)] for r in rounds[-sync_every:]]
        rem = rem[~done]
    return [r for r in rounds if r.numel()]


class SerialFolder:
    """Folds units of the stream into ``table`` in place, exactly as the
    per-item loop would, round by round (:func:`schedule`)."""

    def __init__(self, table: torch.Tensor):
        self.table = table
        self.rounds = 0

    def fold_(self, cells: torch.Tensor, freqs: torch.Tensor,
              rounds: Optional[List[torch.Tensor]] = None) -> None:
        """Fold the items of one unit (``cells`` int64 [w, n], ``freqs`` [n]),
        in their order, after everything folded before; ``rounds`` is the
        unit's :func:`schedule` where the caller has it."""
        for idx in schedule(cells) if rounds is None else rounds:
            c = cells[:, idx]
            cur = self.table.gather(1, c)
            est = _estimates(cur, freqs[idx], self.table.dtype)
            self.table.scatter_(1, c, torch.maximum(cur, est.expand_as(cur)))
            self.rounds += 1


def fold_serial_(table: torch.Tensor, cells: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    SerialFolder(table).fold_(cells, freqs)
    return table


def fold_block_parallel_(table: torch.Tensor, cells: torch.Tensor, freqs: torch.Tensor,
                         block: int) -> torch.Tensor:
    """The control: blocks in order, each block's items all against the
    table as it stood before the block."""
    for s in range(0, cells.shape[1], block):
        c = cells[:, s : s + block]
        est = _estimates(table.gather(1, c), freqs[s : s + block], table.dtype)
        table.scatter_reduce_(1, c, est.expand_as(c), "amax")
    return table


def point_query(table: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
    """Min over rows of each key's cells."""
    return table.gather(1, cells).min(dim=0).values
