"""The conservative fold's schedule: the order of work of K5 and K5i.

``kernels/sketch_update_conservative.fold_schedule`` cuts a block into
staging chunks, each chunk into runs of adjacent items with identical
cells, and the runs into windows of 32, each live run with its level in its
window.  Applied in plain torch -- windows in order, a window level by
level (a level's runs in reverse order, since they must commute), each run
folded as the kernels fold it (one load, ``m <- max(m, m + f_i)`` in
stream order, one store) -- it is held against the reference's jnp
``conservative_fold`` at tolerance 0 (exact equality): int32 cells near
2^31 so ``min + f`` wraps inside a run, float32 runs of non-integer
frequencies (the rounding order), a block of one key, runs across windows
and chunks, zero frequencies, w = 1, 5 and 40.  ``fold_depths`` (D, D_r,
S) is checked on small hand-built blocks.  The kernels themselves run on
the card (tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sketch as rsk
from repro_torch.kernels import sketch_update_conservative as scu

NEAR_TOP = (1 << 31) - 20_000
_reference_fold = jax.jit(rsk.conservative_fold)


def _scheduled_fold(table, idx, freqs, chunk):
    """``fold_schedule``'s order in plain torch, in place."""
    w = table.shape[0]
    rows = torch.arange(w)
    f = freqs.to(table.dtype)
    integer = not table.dtype.is_floating_point
    for window in scu.fold_schedule(idx, freqs, chunk):
        depth = 1 + max((run.level for run in window), default=-1)
        for level in range(depth):
            runs = [run for run in window if run.level == level]
            cells = [tuple(idx[:, run.start].tolist()) for run in runs]
            for k in range(w):    # a level's runs touch pairwise disjoint cells
                assert len({c[k] for c in cells}) == len(cells)
            for run in reversed(runs):
                at = idx[:, run.start]
                cur = table[rows, at]
                m = cur.min()
                for b in range(run.start, run.end):
                    e = (m.to(torch.int64) + f[b]).to(table.dtype) if integer else m + f[b]
                    m = torch.where(e > m, e, m)
                table[rows, at] = torch.where(cur > m, cur, m)
    return table


def _block(w, n, seed, kind, dtype):
    """Cells [w, n] and frequencies [n] of a block of runs over a few keys.

    ``runs``: 200 short runs (more than 32 to a chunk of 90 items), then
    runs of 40 to 150 items (across chunks), over 12 keys whose cells
    collide across rows and keys, a fifth of the frequencies zero and one
    whole run zero; ``one_key``: one key n times."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 7, (12, w))
    if kind == "one_key":
        order = np.zeros(n, np.int64)
    else:
        lengths = np.concatenate([rng.geometric(0.7, 200), rng.integers(40, 150, 40)])
        order = np.repeat(rng.integers(0, 12, lengths.size), lengths)[:n]
    idx = keys[order].T.copy()
    if dtype == "int32":
        freqs = rng.integers(0, 3000, n).astype(np.int32)
    else:
        freqs = (rng.random(n) * 1000).astype(np.float32)   # not integers
    freqs[rng.random(n) < 0.2] = 0
    if kind == "runs":
        starts = np.flatnonzero(np.r_[True, np.any(idx[:, 1:] != idx[:, :-1], axis=0)])
        freqs[starts[3] : starts[4]] = 0                   # a run of zero frequencies
    return idx, freqs


def _table(w, h, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return (rng.integers(0, 4000, (w, h)) + NEAR_TOP).astype(np.int32)
    return (rng.random((w, h)) * 5000).astype(np.float32)


@pytest.mark.parametrize("kind", ["runs", "one_key"])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("w", [1, 5, 40])
def test_schedule_equals_reference_fold(w, dtype, kind):
    n, h, chunk = 700, 7, 90        # runs cross windows of 32 runs and chunks of 90 items
    idx, freqs = _block(w, n, w, kind, dtype)
    base = _table(w, h, dtype, w + 1)
    want = np.asarray(_reference_fold(jnp.asarray(base), jnp.asarray(idx), jnp.asarray(freqs)))
    got = _scheduled_fold(torch.from_numpy(base.copy()), torch.from_numpy(idx),
                          torch.from_numpy(freqs), chunk)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, base)
    windows = scu.fold_schedule(torch.from_numpy(idx), torch.from_numpy(freqs), chunk)
    assert max(run.end - run.start for win in windows for run in win) > 1
    if kind == "runs":                  # a chunk with more than one window of runs
        assert len(windows) > -(-n // chunk)
    run = max((r for win in windows for r in win), key=lambda r: r.end - r.start)
    if dtype == "int32":                # an add wrapped inside a run
        assert int(base.min()) + int(freqs[run.start : run.end].sum()) > 2**31 - 1


def test_schedule_default_chunk_is_the_kernels_buffer():
    idx, freqs = _block(4, 3000, 3, "runs", "int32")
    it, ft = torch.from_numpy(idx), torch.from_numpy(freqs)
    assert scu.fold_schedule(it, ft) == scu.fold_schedule(it, ft, scu.buffer_items(4))
    base = _table(4, 7, "int32", 4)
    want = np.asarray(_reference_fold(jnp.asarray(base), jnp.asarray(idx), jnp.asarray(freqs)))
    np.testing.assert_array_equal(
        _scheduled_fold(torch.from_numpy(base.copy()), it, ft, None).numpy(), want)


def _depths(cells, freqs=None, chunk=None):
    idx = torch.tensor(cells, dtype=torch.int64)
    f = torch.ones(idx.shape[1], dtype=torch.int32) if freqs is None else torch.tensor(freqs)
    return tuple(scu.fold_depths(idx, f, chunk))


@pytest.mark.parametrize("cells,freqs,chunk,want", [
    # 40 items, no shared cell: one level a window, two windows
    ([list(range(40)), list(range(40))], None, 64, (1, 1, 2)),
    # one key 10 times: a chain of 10, one run, one run per chunk of 4
    ([[3] * 10, [5] * 10], None, 4, (10, 1, 3)),
    # a chain through row 1 alone: no runs collapse
    ([[0, 1, 2, 3], [9, 9, 9, 9]], None, 8, (4, 4, 4)),
    # A A B A: the chain A, A, A; runs AA, B, A, A on level 1 of its window
    ([[1, 1, 2, 1], [4, 4, 6, 4]], None, 8, (3, 2, 2)),
    # zero frequencies: item 1 changes nothing, and the run of items 2-3 is dead
    ([[0, 0, 0, 0, 0], [1, 1, 2, 2, 1]], [1, 0, 0, 0, 5], 8, (2, 2, 2)),
    # an empty block
    ([[], []], [], 8, (0, 0, 0)),
])
def test_fold_depths_on_hand_built_blocks(cells, freqs, chunk, want):
    assert _depths(cells, freqs, chunk) == want


def test_fold_depths_bound_each_other():
    idx, freqs = _block(5, 2000, 8, "runs", "int32")
    d = scu.fold_depths(torch.from_numpy(idx), torch.from_numpy(freqs), 90)
    n_windows = len(scu.fold_schedule(torch.from_numpy(idx), torch.from_numpy(freqs), 90))
    assert 1 <= d.run_depth <= d.depth <= 2000
    assert n_windows <= d.window_steps
    assert d.run_depth <= d.window_steps


@pytest.mark.parametrize("w", [1, 3, 4, 5, 8, 40, 100, 1024])
def test_staging_buffers_fit_the_residency_budget(w):
    """The cells and frequencies of two buffers of ``buffer_items`` items
    take at most half of the ``staging_bytes`` the residency rule sets
    aside, which leaves the rest to the kernels' run bookkeeping and
    reserve (int32 and float32 tables both take 4 bytes a cell)."""
    n = scu.buffer_items(w)
    assert 1 <= n <= 128
    assert 2 * n * (4 * w + 4) <= scu.staging_bytes(w, 4) // 2
    assert scu.buffer_items(4) == 128 and scu.buffer_items(40) == 25


# --------------------------------------------------------------------------
# K5's claim rounds: ``claim_rounds``, the plain model of the kernel's order
# of work on a large block, then the stream-order tail
# --------------------------------------------------------------------------

def _claim_block(w, n, seed, dtype):
    """Cells [w, n] of 150 keys over 40 cells a row (true conflicts in
    every row), a run of one key, a fifth of the frequencies zero."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 40, (150, w))
    order = rng.integers(0, 150, n)
    order[n // 6 : n // 6 + 40] = 7
    idx = keys[order].T.copy()
    if dtype == "int32":
        freqs = rng.integers(0, 3000, n).astype(np.int32)
    else:
        freqs = (rng.random(n) * 1000).astype(np.float32)   # not integers
    freqs[rng.random(n) < 0.2] = 0
    return idx, freqs


def _step(table, idx, freqs, b):
    """One item's conservative step, in place (int32 wraps)."""
    rows = np.arange(table.shape[0])
    cur = table[rows, idx[:, b]]
    m = cur.min()
    if table.dtype == np.int32:
        est = np.int32(((int(m) + int(freqs[b]) + 2**31) % 2**32) - 2**31)
    else:
        est = m + freqs[b]
    table[rows, idx[:, b]] = np.maximum(cur, est)


def _apply_round(table, idx, freqs, items):
    """A round's items at once: pairwise disjoint cells, so one gather and
    one scatter give the per-item steps in any order."""
    for k in range(idx.shape[0]):
        assert np.unique(idx[k, items]).size == items.size
    if items.size == 0:
        return
    rows = np.arange(table.shape[0])[:, None]
    cur = table[rows, idx[:, items]]
    if table.dtype == np.int32:
        est = ((cur.min(axis=0).astype(np.int64) + freqs[items] + 2**31) % 2**32
               - 2**31).astype(np.int32)
    else:
        est = cur.min(axis=0) + freqs[items]
    table[rows, idx[:, items]] = np.maximum(cur, est)


@pytest.mark.parametrize("slot_bits", [4, 8, 19])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("w", [1, 4, 8])
def test_claim_rounds_then_tail_equal_the_per_item_fold(w, dtype, slot_bits):
    """At every switch point s of the rounds (s rounds, then every item
    left in stream order) the table is the per-item fold's, at tolerance 0:
    the folded items are closed under "an earlier item shares a cell",
    however many false conflicts the slots add (16 slots: nearly all)."""
    n = 300
    idx, freqs = _claim_block(w, n, 60 + w, dtype)
    base = _table(w, 40, dtype, 61)
    want = np.asarray(_reference_fold(jnp.asarray(base), jnp.asarray(idx), jnp.asarray(freqs)))
    (seg,) = scu.claim_rounds(torch.from_numpy(idx), torch.from_numpy(freqs), 1, n, slot_bits)
    assert seg.tail.size == 0                 # one CTA: rounds to the end
    rounds = seg.rounds
    assert sum(r.size for r in rounds) == np.count_nonzero(freqs)
    assert len(rounds) > 1
    table = base.copy()
    for s in range(len(rounds) + 1):
        if s:
            _apply_round(table, idx, freqs, rounds[s - 1])
        left = np.sort(np.concatenate([np.zeros(0, np.int64), *rounds[s:]]))
        got = table.copy()
        for b in left:
            _step(got, idx, freqs, b)
        np.testing.assert_array_equal(got, want)
    if slot_bits == 4 and w > 1:              # false conflicts: rounds past the true depth
        assert len(rounds) > scu.fold_depths(torch.from_numpy(idx),
                                             torch.from_numpy(freqs)).depth


@pytest.mark.parametrize("min_fold,seg", [(1, 97), (5, 300), (5, 97), (60, 300)])
def test_claim_rounds_segments_and_tails_equal_the_per_item_fold(min_fold, seg):
    """The kernel's rule: a round that folds fewer than ``min_fold`` items
    (two a CTA of its launch) ends the rounds, and the items left are the
    tail; a block past one segment is folded segment by segment.  Rounds in order, then each
    tail in stream order: the per-item fold."""
    n, w = 300, 4
    idx, freqs = _claim_block(w, n, 70, "int32")
    base = _table(w, 40, "int32", 71)
    want = np.asarray(_reference_fold(jnp.asarray(base), jnp.asarray(idx), jnp.asarray(freqs)))
    segs = scu.claim_rounds(torch.from_numpy(idx), torch.from_numpy(freqs), min_fold, seg, 8)
    assert len(segs) == -(-n // seg)
    table = base.copy()
    for s0, part in zip(range(0, n, seg), segs):
        for items in part.rounds:
            assert items.min() >= s0 and items.max() < s0 + seg
            _apply_round(table, idx, freqs, items)
        assert np.all(np.diff(part.tail) > 0)
        for b in part.tail:
            _step(table, idx, freqs, b)
        if min_fold > 1 and part.tail.size:
            assert part.rounds[-1].size < min_fold
    np.testing.assert_array_equal(table, want)
    assert sum(r.size for p in segs for r in p.rounds) + sum(p.tail.size for p in segs) \
        == np.count_nonzero(freqs)
    if min_fold == 60:
        assert segs[0].tail.size > 0


def test_claim_rounds_of_one_key_hand_all_but_one_item_to_the_tail():
    idx = np.tile(np.array([[3], [5], [2], [9]]), (1, 500))
    freqs = np.ones(500, np.int32)
    freqs[:3] = 0
    (seg,) = scu.claim_rounds(torch.from_numpy(idx), torch.from_numpy(freqs), 2, 500)
    assert [r.tolist() for r in seg.rounds] == [[3]]
    assert seg.tail.tolist() == list(range(4, 500))


def test_claim_slots_are_the_kernels_fibonacci_hash():
    """Row k's cell c goes to the top bits of (k << 32 | c) times the 64-bit
    golden ratio, mod 2^64; cells shared by two items share the slot."""
    idx = np.array([[0, 1, 12_345_678, 1], [0, 7, 2**31 - 1, 1]])
    got = scu.claim_slots(idx, 19)
    for k in range(2):
        for j in range(idx.shape[1]):
            key = (k << 32) | int(idx[k, j])
            assert got[k, j] == ((key * 0x9E3779B97F4A7C15) % 2**64) >> (64 - 19)
    assert got[0, 1] == got[0, 3] and got.min() >= 0 and got.max() < 2**19
    assert scu.claim_slots(idx, 4).max() < 16


@pytest.mark.parametrize("w,b,want", [(4, scu.ROUNDS_MIN_ITEMS, True),
                                      (4, scu.ROUNDS_MIN_ITEMS - 1, False),
                                      (8, 1 << 16, True), (9, 1 << 16, False)])
def test_rounds_route_takes_large_blocks_with_rows_in_registers(w, b, want):
    assert scu.rounds_route(w, b) == want


def test_round_scratch_only_for_tables_the_rounds_may_fold():
    """CPU tables, shared-route tables and tables past eight rows get
    none; a conservative KernelSketch on the CPU carries none."""
    from repro_torch.core import sketch as tsk
    from repro_torch.core.hashing import KeySchema
    from repro_torch.kernels.ops import KernelSketch

    assert scu.round_scratch(torch.zeros((4, 1 << 16), dtype=torch.int32)) is None
    spec = tsk.mod_sketch_spec(KeySchema((1 << 32, 1 << 32)), [(0,), (1,)], (64, 64), 4)
    ks = KernelSketch(spec, torch.Generator().manual_seed(0), mode="conservative",
                      device="cpu")
    assert ks.fold_scratch is None
    # the claim slots (2 MB at most) hold a segment's list of 2^17 items
    assert scu.CLAIM_SLOT_BITS >= 17 and (1 << scu.CLAIM_SLOT_BITS) * 4 <= 2 << 20
