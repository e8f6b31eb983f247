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
