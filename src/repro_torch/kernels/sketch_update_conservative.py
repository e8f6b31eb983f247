"""K5 and K5i: the conservative (Estan-Varghese) fold, in stream order.

Port of ``repro/kernels/sketch_update_conservative.py``
(``sketch_update_conservative_pallas``).  A conservative step for item b
with frequency f is

    cur_k = table[k, idx_k(b)]            (min-gather over the w rows)
    est   = min_k cur_k + f
    table[k, idx_k(b)] = max(cur_k, est)  (max-scatter)

The min couples all w rows of one item, and item b reads the writes of
every earlier item that shares one of its w cells.  Items whose cells are
pairwise disjoint commute, so the fold need not walk the block's length,
only its dependency depth.  The TPU kernel keeps the whole table resident
in VMEM and walks the block as its grid; the Hopper kernels
(``csrc/conservative_kernels.cu``) fold one table per CTA in the order
:func:`fold_schedule` describes:

* producer warps, one a chunk of :func:`buffer_items` items, stage the
  block in shared memory: they hash (K5) or read (K5i) the cells, cut the
  chunk into runs (maximal runs of adjacent items with identical cells)
  and give each run its level in its window of 32 runs;
* two fold warps take the windows in turns, one run per lane, and apply a
  window level by level: runs of one level touch pairwise disjoint cells,
  and each cell still sees its writers in stream order.  A lane folds its
  whole run in registers (``m <- max(m, m + f_i)`` over the run, in
  stream order), so the result is bit for bit the per-item fold's.

:func:`fold_depths` reports the depths that bound this work.  The table
itself sits in shared memory when it fits beside the staging buffers
(:func:`residency`) and in global memory otherwise; both routes run the
same kernel body.

* **K5** (:func:`sketch_update_conservative`) hashes each item with the
  fused hash of ``csrc/hashes.cuh`` (K0) and folds it into a flat [w, h_pad]
  table: the counterpart of the Pallas kernel.  A large block on the global
  route (:func:`rounds_route`) is folded across the whole card in claim
  rounds instead (:func:`claim_rounds` is their plain model): each round
  folds, at once, every pending item that comes first among the pending
  items in each of its cells, as far as a hashed claim table of
  ``2^CLAIM_SLOT_BITS`` slots can tell; when a round folds fewer than two
  items a CTA of the launch, the items left go to the window body above on
  one CTA, in stream order.  Its scratch (:class:`RoundScratch`) is
  allocated once per sketch.
* **K5i** (:func:`conservative_fold_tables`) folds given indices (int64
  [w, B] per table) into every table of a hierarchy in one launch, one CTA
  per table.  The reference computes this fold in jnp outside any Pallas
  kernel (``core/sketch.conservative_fold``,
  ``core/hierarchy._update_conservative_tables_jit``); on the card it is
  this kernel, since a Python loop over B is no option.

Tables are int32 or float32; both are exact (gather, min, add, max).  An
int32 ``min + f`` past 2^31 - 1 wraps as jnp's does, and then
``max(cur, est) = cur``.  NaN never enters: callers refuse negative and
NaN frequencies first (``core/sketch.check_conservative_freqs``), so the
plain versions do not emulate jnp's NaN propagation, and a zero frequency
leaves every cell as it is.  Both wrappers fold in place (the reference
donates the table) and run the plain per-item loop only for tensors on
the CPU.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.hashes import IndexPlan, all_indices
from repro_torch.tracing import span

# One CTA's dynamic shared memory on an H100 (227 KB), in place of the
# reference's 14 MiB VMEM budget (``_VMEM_BUDGET_BYTES``).
SHARED_BYTES = 232_448
TABLE_DTYPES = (torch.int32, torch.float32)


def index_chunk(w: int) -> int:
    """Items whose staging the residency rule budgets for: about 16 KB of
    int32 cell indices (4,096 // w items, between 1 and 1,024)."""
    return max(1, min(1024, 4096 // w))


def staging_bytes(w: int, itemsize: int) -> int:
    """Shared memory the residency rule sets aside for staging:
    :func:`index_chunk` items' int32 cell indices [w] and frequency."""
    return index_chunk(w) * (4 * w + itemsize)


WINDOW = 32


def buffer_items(w: int) -> int:
    """Items in each of the kernels' staging buffers: a quarter of
    :func:`index_chunk`, at most 128 (4 windows of single-item runs) and at
    least 1.  The kernels lay the buffers out and take as many as fit
    (``buffers_for`` in csrc/conservative_kernels.cu); for w below 1,366 two
    of them and the kernels' reserve fit in :func:`staging_bytes`."""
    return max(1, min(128, index_chunk(w) // 4))


def residency(w: int, cols: int, itemsize: int,
              shared_bytes: Optional[int] = None) -> str:
    """Where a [w, cols] table is folded: ``"shared"`` when it fits one
    CTA's dynamic shared memory (``SHARED_BYTES`` unless given) beside the
    staging buffers, else ``"global"``.  The port's rule in place of
    ``conservative_chunk_b``; both answers run the kernel."""
    limit = SHARED_BYTES if shared_bytes is None else shared_bytes
    fits = w * cols * itemsize + staging_bytes(w, itemsize) <= limit
    return "shared" if fits else "global"


# The claim rounds (csrc/conservative_kernels.cu, "Claim rounds").
REG_ROWS = 8                    # rows the kernels keep in registers (kRegRows)
CLAIM_SLOT_BITS = 19            # 2 MB of int32 claim slots
CTL_WORDS = 64 + 1024           # the grid barrier's words, then one a CTA (kMaxCtas)
MAX_ROUNDS = (1 << 15) - 2      # a segment's rounds before its tail (kMaxRounds)
ROUNDS_MIN_ITEMS = 512          # below, one CTA's window walk is as fast (PERF.md, section 6)
STATS = ("blocks", "rounds", "round_items", "tail_items")


def rounds_route(w: int, b: int) -> bool:
    """Whether K5 folds a block of ``b`` items into a ``w``-row table on the
    global route in claim rounds across the card: rows in registers and at
    least ``ROUNDS_MIN_ITEMS`` items."""
    return w <= REG_ROWS and b >= ROUNDS_MIN_ITEMS


class RoundScratch:
    """Device scratch of K5's claim rounds, allocated once per sketch and
    reused for every block: ``claims`` (the claim slots, which the kernel
    resets itself and which hold the tail's list once a segment's rounds
    end), ``ctl`` (the grid barrier's words, zero at first) and ``stats``,
    how often the rounds engage: int64 counts of the blocks folded in
    rounds, their rounds, the items folded in rounds and the items handed
    to the tail (:data:`STATS`), added to on the card and read only by
    :meth:`counts`.  Launches that share a scratch run on one stream."""

    def __init__(self, device):
        self.claims = torch.empty(1 << CLAIM_SLOT_BITS, dtype=torch.int32, device=device)
        self.ctl = torch.zeros(CTL_WORDS, dtype=torch.int32, device=device)
        self.stats = torch.zeros(len(STATS), dtype=torch.int64, device=device)

    def counts(self) -> dict:
        """The counts, read from the card (this waits for it)."""
        return dict(zip(STATS, self.stats.tolist()))


def round_scratch(table: torch.Tensor) -> Optional[RoundScratch]:
    """Scratch for a [w, cols] table that the claim rounds may fold: on the
    card, on the global route, with its rows in registers; else None."""
    w, cols = table.shape
    if not table.is_cuda or w > REG_ROWS or residency(w, cols, table.element_size()) == "shared":
        return None
    return RoundScratch(table.device)


def rounds_grid(plan: IndexPlan, w: int, dtype: torch.dtype, device) -> Tuple[int, int]:
    """(``min_fold``, ``seg``) of :func:`claim_rounds` for the kernel's
    launch at this plan, rows and table dtype on ``device``: two items a
    CTA of a launch of as many CTAs as fit on the card, and the items of a
    segment."""
    min_fold, seg = ctypes.c_int32(), ctypes.c_int32()
    with torch.cuda.device(device):
        rc = _cuda.library().sk_conservative_rounds_grid(
            ctypes.byref(_cuda.plan_struct(plan)), w, buffer_items(w),
            int(dtype == torch.float32), ctypes.byref(min_fold), ctypes.byref(seg))
    _cuda.check(rc, "sketch_update_conservative (rounds grid)")
    return min_fold.value, seg.value


def claim_slots(idx: np.ndarray, slot_bits: int = CLAIM_SLOT_BITS) -> np.ndarray:
    """The claim slot of each (row k, cell) of ``idx`` [w, n]: the top
    ``slot_bits`` bits of the Fibonacci hash of ``k << 32 | cell``, as
    ``claim_slot`` in csrc/conservative_kernels.cu."""
    rows = np.arange(idx.shape[0], dtype=np.uint64)[:, None]
    key = rows << np.uint64(32) | idx.astype(np.uint64)
    return ((key * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(64 - slot_bits)).astype(np.int64)


class ClaimRounds(NamedTuple):
    """One segment of the claim rounds: the items each round folds
    (ascending), then the items left to the tail, in stream order."""
    rounds: List[np.ndarray]
    tail: np.ndarray


def claim_rounds(idx: torch.Tensor, freqs: torch.Tensor, min_fold: int, seg: int,
                 slot_bits: int = CLAIM_SLOT_BITS) -> List[ClaimRounds]:
    """The claim rounds' order of work on one block (``idx`` [w, B] cells,
    ``freqs`` [B]), segment by segment of ``seg`` items (:func:`rounds_grid`
    gives the kernel's ``min_fold`` and ``seg``).  In a round every pending
    item (nonzero frequency, not yet folded) claims the slots of its cells;
    an item that is the first claimant of each of its slots folds.  The
    rounds end when no item is left, or when a round folds fewer than
    ``min_fold`` items (or after ``MAX_ROUNDS``): the items left are the
    tail.  Applying the rounds in order, a round's items in any order, then
    the tail in stream order, is the per-item fold."""
    cols = idx.detach().cpu().numpy()
    nonzero = (freqs.detach().cpu() != 0).numpy()
    n = cols.shape[1]
    out = []
    for s0 in range(0, n, seg):
        slots = claim_slots(cols[:, s0 : s0 + seg], slot_bits)
        pending = s0 + np.flatnonzero(nonzero[s0 : s0 + seg])
        rounds, tail = [], pending[:0]
        while pending.size:
            mine = slots[:, pending - s0]
            first = np.full(1 << slot_bits, n, dtype=np.int64)
            np.minimum.at(first, mine.ravel(), np.broadcast_to(pending, mine.shape).ravel())
            won = (first[mine] == pending).all(axis=0)
            rounds.append(pending[won])
            pending = pending[~won]
            if pending.size and (int(won.sum()) < min_fold or len(rounds) == MAX_ROUNDS):
                tail = pending
                break
        out.append(ClaimRounds(rounds, tail))
    return out


class Run(NamedTuple):
    """Items [start, end) of a block: adjacent, with identical cells."""
    start: int
    end: int
    level: int     # 0-based level in its window


class FoldDepths(NamedTuple):
    """The dependency structure of one block's conservative fold."""
    depth: int          # D: the longest chain of items that share a cell
    run_depth: int      # D_r: the same after runs collapse
    window_steps: int   # S: the kernels' level steps, summed over windows


def _run_starts(cols: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """First item of each maximal run of identical cell columns in [lo, hi)."""
    new = np.ones(hi - lo, dtype=bool)
    new[1:] = np.any(cols[:, lo + 1 : hi] != cols[:, lo : hi - 1], axis=0)
    return lo + np.flatnonzero(new)


def _chain_levels(cols: np.ndarray, live: np.ndarray) -> List[int]:
    """For each column of ``cols`` [w, n], the number of live columns in
    the longest chain ending at it whose neighbours share a cell in one row
    (0 for a dead column).  The last column to touch a cell holds the
    highest level among those that touched it, so one pass suffices."""
    last = [dict() for _ in range(cols.shape[0])]
    out = []
    for col, ok in zip(cols.T.tolist(), live.tolist()):
        if not ok:
            out.append(0)
            continue
        lv = 1 + max(seen.get(c, 0) for seen, c in zip(last, col))
        for seen, c in zip(last, col):
            seen[c] = lv
        out.append(lv)
    return out


def _live_runs(cols: np.ndarray, nonzero: np.ndarray, lo: int, hi: int):
    """The runs of [lo, hi): their starts, ends, and whether any of their
    frequencies is nonzero (a run of zero frequencies changes no cell)."""
    starts = _run_starts(cols, lo, hi)
    ends = np.append(starts[1:], hi)
    live = np.add.reduceat(nonzero[lo:hi], starts - lo) > 0
    return starts, ends, live


def fold_schedule(idx: torch.Tensor, freqs: torch.Tensor,
                  chunk: Optional[int] = None) -> List[List[Run]]:
    """The kernels' order of work on one block, as a list of windows.

    ``idx`` [w, B] holds each item's cell per row.  The block is cut into
    staging chunks of ``chunk`` items (:func:`buffer_items` by default),
    each chunk into runs of adjacent items with identical cells, and the
    runs of each chunk into windows of 32.  Each window lists its live
    runs (those with a nonzero frequency) with their level: 1 + the
    highest level among the window's earlier runs that share a cell with
    it in some row.  Applying the windows in order, and a window's runs
    level by level, each run's items in stream order, is the per-item fold.
    """
    cols = idx.detach().cpu().numpy()
    nonzero = (freqs.detach().cpu() != 0).numpy()
    w, n = cols.shape
    chunk = buffer_items(w) if chunk is None else chunk
    windows = []
    for lo in range(0, n, chunk):
        starts, ends, live = _live_runs(cols, nonzero, lo, min(n, lo + chunk))
        for a in range(0, starts.shape[0], WINDOW):
            sl = slice(a, a + WINDOW)
            levels = _chain_levels(cols[:, starts[sl]], live[sl])
            windows.append([Run(int(s0), int(e0), lv - 1)
                            for s0, e0, lv in zip(starts[sl], ends[sl], levels) if lv])
    return windows


def fold_depths(idx: torch.Tensor, freqs: torch.Tensor,
                chunk: Optional[int] = None) -> FoldDepths:
    """D, D_r and S of one block (``idx`` [w, B], ``freqs`` [B]): the
    dependency depth over items with a nonzero frequency, the depth over
    runs of adjacent items with identical cells (the whole block, no chunk
    cuts), and the level steps the kernels take (:func:`fold_schedule`'s
    windows, each as deep as its deepest run).  Any exact fold takes at
    least D_r dependent steps of ``m <- max(m, m + f)``; the kernels take
    S level steps."""
    cols = idx.detach().cpu().numpy()
    nonzero = (freqs.detach().cpu() != 0).numpy()
    n = cols.shape[1]
    if n == 0:
        return FoldDepths(0, 0, 0)
    depth = max(_chain_levels(cols, nonzero))
    starts, _, live = _live_runs(cols, nonzero, 0, n)
    run_depth = max(_chain_levels(cols[:, starts], live))
    steps = sum(1 + max(r.level for r in win) for win in fold_schedule(idx, freqs, chunk)
                if win)
    return FoldDepths(depth, run_depth, steps)


def conservative_fold_tables_ref(tables: Sequence[torch.Tensor],
                                 idxs: Sequence[torch.Tensor],
                                 freqs: torch.Tensor) -> Sequence[torch.Tensor]:
    """Plain version of K5i: the reference's ``fori_loop``, one item at a
    time, into each table in place.  ``freqs`` is cast to the table dtype."""
    for table, idx in zip(tables, idxs):
        w = table.shape[0]
        rows = torch.arange(w, device=table.device)
        f = freqs.to(table.dtype)
        integer = not table.dtype.is_floating_point
        for b in range(idx.shape[1]):
            cells = idx[:, b]
            cur = table[rows, cells]
            if integer:   # add in int64 and wrap back, as jnp's int32 add does
                est = (cur.min().to(torch.int64) + f[b]).to(table.dtype)
            else:
                est = cur.min() + f[b]
            table[rows, cells] = torch.maximum(cur, est)
    return tables


def sketch_update_conservative_ref(plan: IndexPlan, table: torch.Tensor,
                                   chunks: torch.Tensor, freqs: torch.Tensor,
                                   q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: hash every (row, key), then the per-item fold."""
    conservative_fold_tables_ref([table], [all_indices(plan, chunks, q, r)], freqs)
    return table


def _kernel_freqs(freqs: torch.Tensor, table: torch.Tensor, name: str,
                  b: int) -> torch.Tensor:
    """The frequencies in the table dtype, after the checks every launch
    shares: their shape, and staging buffers that fit shared memory."""
    w = table.shape[0]
    _cuda.require(staging_bytes(w, table.element_size()) <= SHARED_BYTES,
                  f"{name}: {w} rows leave no room to stage a chunk in shared memory")
    f = freqs.to(device=table.device, dtype=table.dtype).contiguous()
    _cuda.require(tuple(f.shape) == (b,),
                  f"{name}: freqs {tuple(freqs.shape)} do not match the {b} keys")
    return f


def sketch_update_conservative(plan: IndexPlan, table: torch.Tensor,
                               chunks: torch.Tensor, freqs: torch.Tensor,
                               q: torch.Tensor, r: torch.Tensor,
                               scratch: Optional[RoundScratch] = None) -> torch.Tensor:
    """Conservatively fold one block into ``table`` ([w, h_pad], int32 or
    float32) in place, in stream order; returns it.

    chunks int64[B, C], freqs [B] (non-negative, cast to the table dtype),
    q int64[w, C], r int64[w, m].  CUDA tensors launch K5 on the route
    :func:`residency` picks, on the global route in claim rounds where
    :func:`rounds_route` says so, with ``scratch`` (a fresh
    :class:`RoundScratch` when None); CPU tensors take
    :func:`sketch_update_conservative_ref`.
    """
    with span("repro_torch.kernels.sketch_update_conservative"):
        if not table.is_cuda:
            return sketch_update_conservative_ref(plan, table, chunks, freqs, q, r)
        name = "sketch_update_conservative"
        _cuda.require_hash_inputs(name, plan, table, chunks, q, r, TABLE_DTYPES)
        w, h_pad = table.shape
        b = chunks.shape[0]
        _cuda.require(plan.table_size <= h_pad,
                      f"{name}: table width {h_pad} below the plan's {plan.table_size}")
        f = _kernel_freqs(freqs, table, name, b)
        shared = residency(w, h_pad, table.element_size()) == "shared"
        suffix = "i32" if table.dtype == torch.int32 else "f32"
        plan_c = _cuda.plan_struct(plan)
        lib = _cuda.library()
        with torch.cuda.device(table.device):
            if not shared and rounds_route(w, b):
                _cuda.require(b < 1 << 31, f"{name}: {b} keys, at most 2^31 - 1 in claim rounds")
                scratch = RoundScratch(table.device) if scratch is None else scratch
                _cuda.require(scratch.claims.device == table.device,
                              f"{name}: the round scratch is on {scratch.claims.device}")
                rc = getattr(lib, "sk_conservative_rounds_" + suffix)(
                    ctypes.byref(plan_c), table.data_ptr(), h_pad, w, chunks.data_ptr(),
                    f.data_ptr(), b, q.data_ptr(), r.data_ptr(), buffer_items(w),
                    scratch.claims.data_ptr(), CLAIM_SLOT_BITS, scratch.ctl.data_ptr(),
                    scratch.stats.data_ptr(), _cuda.stream_of(table))
            else:
                rc = getattr(lib, "sk_conservative_update_" + suffix)(
                    ctypes.byref(plan_c), table.data_ptr(), h_pad, w, chunks.data_ptr(),
                    f.data_ptr(), b, q.data_ptr(), r.data_ptr(), int(shared),
                    buffer_items(w), _cuda.stream_of(table))
        _cuda.check(rc, name)
        _cuda.LAUNCHES[name] += 1
        return table


def conservative_fold_tables(tables: Sequence[torch.Tensor],
                             idxs: Sequence[torch.Tensor],
                             freqs: torch.Tensor) -> Sequence[torch.Tensor]:
    """Conservatively fold one block into every table, each at its own
    given cells, in place; returns the tables.

    tables: [w, cols_l] int32 or float32 (all one dtype and width, rows
    unit-strided, e.g. hierarchy levels); idxs: int64 [w, B] per table,
    every index below its table's ``cols``; freqs [B] (non-negative, cast
    to the table dtype).  CUDA tensors launch K5i once for all tables,
    each on the route :func:`residency` picks; CPU tensors take
    :func:`conservative_fold_tables_ref`.
    """
    tables, idxs = list(tables), list(idxs)
    if not tables:
        return tables
    if not tables[0].is_cuda:
        return conservative_fold_tables_ref(tables, idxs, freqs)
    name = "conservative_fold"
    t0 = tables[0]
    w, b = int(t0.shape[0]), int(idxs[0].shape[1])
    _cuda.require(len(tables) == len(idxs) <= _cuda.MAX_LEVELS,
                  f"{name}: one index block per table, at most "
                  f"{_cuda.MAX_LEVELS} tables")
    _cuda.require_table_dtype(t0, name, TABLE_DTYPES)
    s = _cuda.ConsLevelsC()
    s.n_levels, s.w = len(tables), w
    for l, (table, idx) in enumerate(zip(tables, idxs)):
        _cuda.require(table.dtype == t0.dtype and table.device == t0.device
                      and table.dim() == 2 and table.shape[0] == w
                      and table.stride(1) == 1 and table.shape[1] < 1 << 31,
                      f"{name}: table {l} is not a [w={w}, cols] {t0.dtype} "
                      f"table on {t0.device} with unit-strided rows")
        _cuda.require(idx.dtype == torch.int64 and idx.device == t0.device
                      and idx.is_contiguous() and tuple(idx.shape) == (w, b),
                      f"{name}: indices {l} must be contiguous int64 [{w}, {b}] "
                      f"on {t0.device}")
        s.tables[l] = table.data_ptr()
        s.idx[l] = idx.data_ptr()
        s.row_stride[l] = table.stride(0)
        s.cols[l] = table.shape[1]
        s.shared[l] = int(residency(w, table.shape[1], table.element_size()) == "shared")
    f = _kernel_freqs(freqs, t0, name, b)
    fn = "sk_conservative_fold_" + ("i32" if t0.dtype == torch.int32 else "f32")
    lib = _cuda.library()
    with torch.cuda.device(t0.device):
        rc = getattr(lib, fn)(ctypes.byref(s), f.data_ptr(), b,
                              buffer_items(w), _cuda.stream_of(t0))
    _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1
    return tables
