"""Signed Count-Sketch mode of the composite-hash family, PyTorch port.

Port of ``repro/core/countsketch.py``.  The same partitioned indexing as
core/sketch.py, plus a +-1 sign per (row, item) built compositely: one CW
parity hash per module group, so the sign factors over the same group
prefixes as the cell address.  The level-L sign is the product (XOR of
parities) of groups 0..L, so it cascades with the hierarchy the way the
mixed-radix index does::

    sign_L(key) = sign_{L-1}(prefix) * parity_L(g_L value)

:func:`sign_bits` packs every level's sign into one integer per (row,
item): bit L is the cumulative parity of groups 0..L.  A parity is the low
bit of the canonical residue in [0, P31) that ``cw_hash`` returns.

Signed tables stay linear in the stream, so turnstile deletions cancel
exactly and tables merge cell-wise.  Point estimates are the median over
rows, computed as ``jnp.median`` does (:func:`median_rows`).

This module is the plain path and keeps the reference's arithmetic: signs
multiply values in float32 and the product is cast to the table's dtype
(exact for |value| < 2^24).  One exception: :func:`hier_fold_tables` folds
float32 tables on the card with K8f, in one launch for all levels.  The
kernels (``kernels/ops.py`` ``mode="signed"``, K6-K9) multiply in int32
and are held to the same results below 2^24; K9m, the signed descent's
query, and K7m, the signed flat sketch's, also take the median over rows
in their launch.  Hash params are
int64 tensors, as in core/sketch.py; a torch generator cannot reproduce
the reference's ``jax.random`` draw, so shared params cross as arrays
(``repro_torch.interop``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import hierarchy as hh
from repro_torch.core import sketch as sk
from repro_torch.core.hashing import cw_hash, draw_hash_params
from repro_torch.device import DeviceLike, as_index_tensor, resolve_device


class CountSketchParams(NamedTuple):
    """Bucket hash params + one CW sign hash per (row, group)."""
    base: sk.SketchParams
    sign_q: torch.Tensor  # int64[w, total_chunks]
    sign_r: torch.Tensor  # int64[w, n_groups]


class CountSketchState(NamedTuple):
    params: CountSketchParams
    table: torch.Tensor  # [w, h], float32 or int32


def init_params(spec: sk.SketchSpec, generator: torch.Generator,
                device: DeviceLike = None) -> CountSketchParams:
    base = sk.init_params(spec, generator, device)
    sign_q = draw_hash_params(generator, (spec.width, spec.schema.total_chunks),
                              device)
    sign_r = draw_hash_params(generator, (spec.width, spec.n_groups), device)
    return CountSketchParams(base, sign_q, sign_r)


def resolve_params(spec: sk.SketchSpec, params,
                   device: DeviceLike = None) -> CountSketchParams:
    """Signed params for ``spec`` from a ``torch.Generator`` (a fresh draw),
    a ``CountSketchParams``, or a ``(q, r, sign_q, sign_r)`` tuple of numpy
    arrays or tensors -- e.g. the reference's own draw."""
    device = resolve_device(device)
    if isinstance(params, torch.Generator):
        return init_params(spec, params, device)
    if isinstance(params, CountSketchParams):
        (q, r), sq, sr = params
    else:
        q, r, sq, sr = params
    base = sk.resolve_params(spec, (q, r), device)
    sign = sk.resolve_params(spec, (sq, sr), device)
    return CountSketchParams(base, sign.q, sign.r)


def init_state(spec: sk.SketchSpec, params, dtype=torch.float32,
               device: DeviceLike = None) -> CountSketchState:
    params = resolve_params(spec, params, device)
    table = torch.zeros((spec.width, spec.table_size), dtype=dtype,
                        device=params.sign_q.device)
    return CountSketchState(params, table)


def median_rows(rows: torch.Tensor) -> torch.Tensor:
    """Median over axis 0 in float32, as ``jnp.median`` computes it.

    Rows are cast to float32 first (jnp promotes int32 before the median)
    and put in order by an odd-even transposition network of
    ``torch.minimum`` / ``torch.maximum`` (w rounds of compare-exchanges of
    neighbouring rows, which sorts any w); the two middle rows are averaged
    as ``(a + b) * 0.5`` in float32, as jnp.median does (for odd w they are
    one row).  ``torch.median`` would return the lower middle row instead.
    A column that holds a NaN has median NaN, as in ``jnp.median``: min and
    max both carry NaN, and in a sorting network every input reaches every
    output.  K9m and K7m (``kernels/hier_query.py``,
    ``kernels/sketch_query.py``) run the same network in registers.  No sort: nothing but w float32 rows is allocated.
    """
    x = list(rows.to(torch.float32).unbind(0))
    w = len(x)
    for rnd in range(w):
        for i in range(rnd % 2, w - 1, 2):
            x[i], x[i + 1] = torch.minimum(x[i], x[i + 1]), torch.maximum(x[i], x[i + 1])
    return (x[(w - 1) // 2] + x[w // 2]) * 0.5


# --------------------------------------------------------------------------
# Signs
# --------------------------------------------------------------------------

def sign_bits(spec: sk.SketchSpec, params: CountSketchParams,
              items) -> torch.Tensor:
    """Packed cumulative parity bits per (row, item): int64[w, B].

    Bit L is the XOR of the per-group CW-hash parities of groups 0..L --
    the sign of the level-L prefix of the key under the shared family (the
    finest/flat sign is the top group's bit).
    """
    items = as_index_tensor(items, params.sign_q.device)
    chunks = spec.schema.module_chunks(items)                 # [B, C]
    bits = torch.zeros((spec.width, chunks.shape[0]), dtype=torch.int64,
                       device=chunks.device)
    cum = torch.zeros_like(bits)
    for j in range(spec.n_groups):
        cols = list(spec.group_chunk_columns(j))
        h = cw_hash(chunks[None, :, cols], params.sign_q[:, None, cols],
                    params.sign_r[:, j, None])                # [w, B]
        cum = cum ^ (h & 1)
        bits = bits | (cum << j)
    return bits


def signs_from_bits(bits: torch.Tensor, level: int) -> torch.Tensor:
    """float32 +-1 signs for one level from the packed cumulative bits."""
    par = (bits >> int(level)) & 1
    return 1.0 - 2.0 * par.to(torch.float32)


def signs(spec: sk.SketchSpec, params: CountSketchParams,
          items) -> torch.Tensor:
    """+-1 per (row, item) for the full composite key: float32[w, B]."""
    return signs_from_bits(sign_bits(spec, params, items), spec.n_groups - 1)


def group_sign_parity(spec: sk.SketchSpec, params: CountSketchParams,
                      group: int, values) -> torch.Tensor:
    """Parity bit of ONE group's sign hash: int64[w, Q] in {0, 1}.

    The sign analogue of ``sk.group_subindex`` -- the separable child factor
    of the candidate grid: sign(prefix + v) = prefix_sign * (1 - 2 *
    parity(v)).
    """
    sign = sk.SketchParams(q=params.sign_q, r=params.sign_r)
    return sk.group_hash(spec, sign, group, values) & 1


# --------------------------------------------------------------------------
# Flat update / query / diagnostics
# --------------------------------------------------------------------------

def add_signed(table: torch.Tensor, idx: torch.Tensor,
               signed_vals: torch.Tensor) -> torch.Tensor:
    """Scatter-add per-(row, item) signed values (float32[w, B]) into a copy
    of the table, cast to its dtype.  Flat offsets are int64 (the
    reference's uint32 offsets would wrap past 2^32 cells)."""
    w, h = table.shape
    rows = torch.arange(w, dtype=torch.int64, device=table.device)[:, None]
    flat = (rows * h + idx).reshape(-1)
    out = torch.clone(table, memory_format=torch.contiguous_format)
    out.view(-1).index_add_(0, flat, signed_vals.reshape(-1).to(table.dtype))
    return out


def update(spec: sk.SketchSpec, state: CountSketchState, items,
           values) -> CountSketchState:
    """Fold (item, value) pairs: cell[k, h_k(x)] += s_k(x) * v (order-free).

    Values may be negative (turnstile deletions); int32 tables are exact
    for |value| < 2^24, where the float32 product is."""
    idx = sk.compute_indices(spec, state.params.base, items)  # [w, B]
    s = signs(spec, state.params, items)                      # [w, B]
    v = sk.as_freqs(values, s.device).to(torch.float32)
    return CountSketchState(state.params,
                            add_signed(state.table, idx, s * v[None, :]))


def query_rows(spec: sk.SketchSpec, state: CountSketchState,
               items) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-row estimates float32[w, Q], median float32[Q])."""
    idx = sk.compute_indices(spec, state.params.base, items)
    s = signs(spec, state.params, items)
    vals = torch.gather(state.table, 1, idx).to(torch.float32) * s
    return vals, median_rows(vals)


def query(spec: sk.SketchSpec, state: CountSketchState, items) -> torch.Tensor:
    """Unbiased median-of-rows estimate of each item's summed value."""
    return query_rows(spec, state, items)[1]


def l2estimate(table: torch.Tensor) -> torch.Tensor:
    """AMS-style L2 estimate: sqrt(median_k sum_j table[k, j]^2), float32.

    The row sums run in float32, as the reference's; their order of
    addition is the backend's own, so they match the reference exactly
    only while every partial sum is an integer below 2^24."""
    sq = torch.square(table.to(torch.float32)).sum(dim=1)
    return torch.sqrt(median_rows(sq))


def merge(a: CountSketchState, b: CountSketchState) -> CountSketchState:
    """Cell-wise merge -- exact by linearity (same hash params assumed)."""
    return CountSketchState(params=a.params, table=a.table + b.table)


# --------------------------------------------------------------------------
# Hierarchy: signed tables over the same group-prefix cascade
# --------------------------------------------------------------------------

class CountSketchHierarchy(NamedTuple):
    """One signed table per level, sharing ONE (bucket + sign) hash draw:
    ``params`` is the finest level's, level L uses the prefix slices."""
    params: CountSketchParams
    tables: Tuple[torch.Tensor, ...]   # coarse -> fine, [w, h_L] each


def level_params(hspec: hh.HierarchySpec, params: CountSketchParams,
                 level: int) -> CountSketchParams:
    """Level ``level``'s params as prefix slices of the finest draw."""
    nc = hspec.levels[level].schema.total_chunks
    return CountSketchParams(
        base=hh.level_params(hspec, params.base, level),
        sign_q=params.sign_q[:, :nc],
        sign_r=params.sign_r[:, : level + 1])


def init_hierarchy(hspec: hh.HierarchySpec, params, dtype=torch.float32,
                   device: DeviceLike = None) -> CountSketchHierarchy:
    """Zero tables for every level and ONE shared draw: ``params`` is a
    ``torch.Generator`` or the finest level's ``(q, r, sign_q, sign_r)``."""
    params = resolve_params(hspec.levels[-1], params, device)
    tables = tuple(torch.zeros((s.width, s.table_size), dtype=dtype,
                               device=params.sign_q.device)
                   for s in hspec.levels)
    return CountSketchHierarchy(params, tables)


def hier_fold_tables(hspec: hh.HierarchySpec, params: CountSketchParams,
                     tables: Tuple[torch.Tensor, ...], items,
                     values) -> Tuple[torch.Tensor, ...]:
    """Signed cascade fold: ONE hash pass (buckets + sign bits), every
    level's cells by integer division and its sign by one bit of the packed
    parities.  Returns new tables.

    Float32 tables on the card (the gradient compressor's) take the kernel
    route: every level is folded by ONE K8f launch into a new concatenated
    ``[w, sum_L h_L]`` table, and the levels come back as views of it, which
    the descent reads through their stride.  Other tables take the plain
    scatter (int32 tables reach K8 through ``KernelHierarchy``)."""
    items = as_index_tensor(items, params.sign_q.device)
    fine_items = hspec.level_items(hspec.n_levels - 1, items)
    if tables[0].is_cuda and all(t.dtype == torch.float32 for t in tables):
        return _hier_fold_kernel(hspec, params, torch.cat(tables, dim=1),
                                 fine_items, values)
    idxs = hh.hierarchy_indices(hspec, params.base, items)
    bits = sign_bits(hspec.levels[-1], params, fine_items)
    vals = sk.as_freqs(values, items.device).to(torch.float32)[None, :]
    return tuple(add_signed(table, idx, signs_from_bits(bits, lvl) * vals)
                 for lvl, (table, idx) in enumerate(zip(tables, idxs)))


def hier_fold_zero_tables(hspec: hh.HierarchySpec, params: CountSketchParams,
                          items, values) -> Tuple[torch.Tensor, ...]:
    """:func:`hier_fold_tables` into fresh float32 zero tables (the gradient
    compressor's sketch).  On the card the levels are views of ONE zero
    ``[w, sum_L h_L]`` table that K8f folds in place: one allocation, no
    copy."""
    device = params.sign_q.device
    if device.type != "cuda":
        tables = tuple(torch.zeros((s.width, s.table_size), dtype=torch.float32,
                                   device=device) for s in hspec.levels)
        return hier_fold_tables(hspec, params, tables, items, values)
    items = as_index_tensor(items, device)
    table = torch.zeros((hspec.base.width, sum(s.table_size for s in hspec.levels)),
                        dtype=torch.float32, device=device)
    return _hier_fold_kernel(hspec, params, table,
                             hspec.level_items(hspec.n_levels - 1, items), values)


def _hier_fold_kernel(hspec: hh.HierarchySpec, params: CountSketchParams,
                      table: torch.Tensor, fine_items,
                      values) -> Tuple[torch.Tensor, ...]:
    """K8f folds every level into ``table`` ([w, sum_L h_L] float32, levels
    unpadded) in place; returns the level views."""
    from repro_torch.kernels import hier_update as hu

    hplan = hu.make_hier_plan(hspec, tile_h=1)       # levels unpadded
    chunks = hspec.levels[-1].schema.module_chunks(fine_items)
    vals = sk.as_freqs(values, table.device).to(torch.float32).contiguous()
    hu.hier_update_signed(hplan, table, chunks, vals, params.base.q, params.base.r,
                          params.sign_q, params.sign_r)
    return tuple(table[:, off : off + h]
                 for off, h in zip(hplan.level_offsets, hplan.level_sizes))


def hier_update(hspec: hh.HierarchySpec, state: CountSketchHierarchy, items,
                values) -> CountSketchHierarchy:
    """Fold full keys into every level's signed table (cascade path)."""
    return CountSketchHierarchy(
        state.params,
        hier_fold_tables(hspec, state.params, state.tables, items, values))


def hier_update_reference(hspec: hh.HierarchySpec,
                          state: CountSketchHierarchy, items,
                          values) -> CountSketchHierarchy:
    """Per-level oracle: L independent flat updates, each re-hashing its
    prefix (and its prefix sign) from scratch."""
    items = as_index_tensor(items, state.params.sign_q.device)
    new = []
    for lvl, (spec_l, table) in enumerate(zip(hspec.levels, state.tables)):
        st = CountSketchState(level_params(hspec, state.params, lvl), table)
        new.append(update(spec_l, st, hspec.level_items(lvl, items),
                          values).table)
    return CountSketchHierarchy(state.params, tuple(new))


def hier_merge(a: CountSketchHierarchy,
               b: CountSketchHierarchy) -> CountSketchHierarchy:
    """Cell-wise merge per level -- exact by linearity."""
    return CountSketchHierarchy(
        a.params, tuple(ta + tb for ta, tb in zip(a.tables, b.tables)))


def hier_query(hspec: hh.HierarchySpec, state: CountSketchHierarchy,
               level: int, prefixes) -> torch.Tensor:
    """Median estimate of each level-``level`` prefix's signed mass: [Q].

    ``prefixes``: [Q, n_modules(levels 0..level)] in group-major order."""
    st = CountSketchState(level_params(hspec, state.params, level),
                          state.tables[level])
    return query(hspec.levels[level], st, prefixes)


# --------------------------------------------------------------------------
# Separable signed candidate queries + threshold descent
# --------------------------------------------------------------------------

def candidate_signed_partials(
    hspec: hh.HierarchySpec,
    params: CountSketchParams,
    level: int,
    prefixes,     # [P, n_prefix_modules] (group-major)
    values,       # [C, len(level group modules)]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Index AND sign factors of the level-``level`` candidate grid.

    Returns (pp, cp, sp, sc): int64[w, P] prefix partials (scaled by the
    last group's range), int64[w, C] child partials, and float32 +-1 sign
    partials, such that child (p, c) of row k lives at cell ``pp[k, p] +
    cp[k, c]`` with sign ``sp[k, p] * sc[k, c]``.  ``sp`` is the sign of the
    level-(L-1) prefix (the top bit of its own packed bits) and ``sc`` one
    group's parity; their product is bit L of the full key's packed bits
    because the cumulative parity XORs.
    """
    spec_l = hspec.levels[level]
    lp = level_params(hspec, params, level)
    device = params.sign_q.device
    prefixes = as_index_tensor(prefixes, device)
    w = spec_l.width

    if level == 0:
        pp = torch.zeros((w, prefixes.shape[0]), dtype=torch.int64, device=device)
        sp = torch.ones((w, prefixes.shape[0]), dtype=torch.float32, device=device)
    else:
        prefix_spec = hspec.levels[level - 1]
        prefix_params = level_params(hspec, params, level - 1)
        pp = sk.compute_indices(prefix_spec, prefix_params.base, prefixes)
        pp = pp * int(spec_l.ranges[-1])
        sp = signs(prefix_spec, prefix_params, prefixes)

    cp = sk.group_subindex(spec_l, lp.base, level, values)
    sc = 1.0 - 2.0 * group_sign_parity(spec_l, lp, level, values).to(torch.float32)
    return pp, cp, sp, sc


def candidate_estimates(
    hspec: hh.HierarchySpec,
    state: CountSketchHierarchy,
    level: int,
    prefixes: np.ndarray,    # uint32[P, n_prefix_modules]
    values: np.ndarray,      # uint32[C, len(level group modules)]
    *,
    use_kernel: bool = False,
    max_batch: Optional[int] = None,
) -> np.ndarray:
    """Median signed estimates for every (prefix x value) child: f32[P, C].

    ``use_kernel=True`` routes tables on the card through K9m, the signed
    grid with the median over rows in the same launch, which takes int32
    only and refuses the rest; the default is the plain gather and
    :func:`median_rows`.  Both agree bit for bit on int32 tables.  K9m is
    given the level's last range as its ``span``
    (``hierarchy.candidate_span``).  ``max_batch`` chunks the prefix axis
    only; a short last chunk is padded with prefix partial 0 (always a
    valid cell) and sign +1, and sliced off.
    """
    from repro_torch.kernels import hier_query as hq

    pp, cp, sp, sc = candidate_signed_partials(
        hspec, state.params, level, np.asarray(prefixes, dtype=np.uint32),
        np.asarray(values, dtype=np.uint32))
    table = state.tables[level]
    if use_kernel and table.is_cuda:
        grid = functools.partial(hq.hier_candidate_median_signed,
                                 span=hh.candidate_span(hspec, level))
    else:
        grid = hq.hier_candidate_median_signed_ref

    def one(pp_chunk, sp_chunk):
        return grid(table, pp_chunk, cp, sp_chunk, sc).cpu().numpy()

    p, c = pp.shape[1], cp.shape[1]
    if max_batch is None or p * c <= max_batch:
        return one(pp, sp)
    p_chunk = max(1, max_batch // max(c, 1))
    outs = []
    for s in range(0, p, p_chunk):
        ppc, spc = pp[:, s : s + p_chunk], sp[:, s : s + p_chunk]
        if ppc.shape[1] < p_chunk:
            pad = p_chunk - ppc.shape[1]
            ppc = torch.nn.functional.pad(ppc, (0, pad))
            spc = torch.nn.functional.pad(spc, (0, pad), value=1.0)
        outs.append(one(ppc.contiguous(), spc.contiguous()))
    return np.concatenate(outs, axis=0)[:p]


def find_heavy_hitters(
    hspec: hh.HierarchySpec,
    state: CountSketchHierarchy,
    threshold: float,
    candidates: Sequence[np.ndarray],
    *,
    use_kernel: bool = False,
    max_batch: int = 1 << 16,
) -> Tuple[np.ndarray, np.ndarray]:
    """All keys whose |median estimate| >= ``threshold`` (signed descent).

    The descent prunes on |median|, which is unbiased per level.  Returns
    (items uint32[K, n_modules] in schema order, float32 estimates of the
    FINEST level) sorted by |estimate| descending.  ``use_kernel`` as in
    :func:`candidate_estimates`.
    """
    if len(candidates) != hspec.n_levels:
        raise ValueError(
            f"need one candidate set per level ({hspec.n_levels}), "
            f"got {len(candidates)}")
    threshold = float(threshold)

    prefixes = np.zeros((1, 0), dtype=np.uint32)
    est = np.zeros((1,), dtype=np.float32)
    for lvl in range(hspec.n_levels):
        cand = np.asarray(candidates[lvl], dtype=np.uint32)
        if cand.ndim != 2 or cand.shape[1] != len(hspec.base.partition[lvl]):
            raise ValueError(
                f"candidates[{lvl}] must be "
                f"[C, {len(hspec.base.partition[lvl])}]")
        if prefixes.shape[0] == 0 or cand.shape[0] == 0:
            n_mods = len(hh.level_modules(hspec.base, hspec.n_levels - 1))
            return (np.zeros((0, n_mods), np.uint32),
                    np.zeros((0,), np.float32))
        grid = candidate_estimates(
            hspec, state, lvl, prefixes, cand, use_kernel=use_kernel,
            max_batch=max_batch)
        keep_p, keep_c = np.nonzero(np.abs(grid) >= threshold)
        prefixes = np.concatenate([prefixes[keep_p], cand[keep_c]], axis=1)
        est = grid[keep_p, keep_c]

    order = np.argsort(-np.abs(est), kind="stable")
    return hspec.to_schema_order(prefixes[order]), est[order]
